"""Resource-configuration tuning (paper §IV-D/E).

Re-implementations of CherryPick (Bayesian optimization) and Arrow
(augmented BO with low-level metrics), a scout-like dataset simulator
(18 workloads x 69 AWS configs, its counter-based draws on a device),
Perona's acquisition weighting and the machine scores behind it, the
Perona HPO (``hpo``), and the scientific-workflow integrations (Lotaru
runtime prediction, Tarema node grouping).
"""

from repro_torch.tuning.scout import ScoutDataset
from repro_torch.tuning.cherrypick import CherryPick
from repro_torch.tuning.arrow import Arrow
from repro_torch.tuning.perona_weights import PeronaAcquisitionWeighter

__all__ = [
    "ScoutDataset",
    "CherryPick",
    "Arrow",
    "PeronaAcquisitionWeighter",
]
