"""Machine capability profiles for GCP / AWS instance types.

Scores are relative capability scalars calibrated loosely to public
instance specs (vCPU count/clock, memory bandwidth class, network/disk
tiers). They drive the benchmark-tool simulators; absolute values only
need to be *ordered and proportioned* realistically, since Perona's
pipeline normalizes per metric.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class MachineProfile:
    name: str
    cpu: float  # single-thread-ish events/s scale
    memory: float  # memory bandwidth scale (MiB/s)
    disk_iops: float
    disk_lat_us: float
    net_gbps: float
    net_lat_us: float
    noise: float = 0.04  # relative run-to-run variation


MACHINE_PROFILES: Dict[str, MachineProfile] = {
    # GCP (paper §IV-C: e2-medium; §IV-E adds n1/n2/c2-standard-4)
    "e2-medium": MachineProfile("e2-medium", 900, 9500, 15000, 260, 4.0, 110),
    "n1-standard-4": MachineProfile("n1-standard-4", 1050, 11000, 30000, 210,
                                    10.0, 85),
    "n2-standard-4": MachineProfile("n2-standard-4", 1400, 15000, 30000, 190,
                                    10.0, 80),
    "c2-standard-4": MachineProfile("c2-standard-4", 1750, 16500, 30000, 185,
                                    10.0, 75),
    # AWS (paper §IV-D: scout dataset machine families)
    "m4.large": MachineProfile("m4.large", 1000, 10500, 3600, 300, 0.45, 140),
    "m4.xlarge": MachineProfile("m4.xlarge", 1950, 20500, 6000, 280, 0.75,
                                130),
    "m4.2xlarge": MachineProfile("m4.2xlarge", 3800, 40000, 8000, 260, 1.0,
                                 120),
    "c4.large": MachineProfile("c4.large", 1300, 11500, 4000, 290, 0.5, 130),
    "c4.xlarge": MachineProfile("c4.xlarge", 2550, 22500, 6000, 270, 0.75,
                                125),
    "c4.2xlarge": MachineProfile("c4.2xlarge", 5000, 44000, 8000, 250, 1.0,
                                 115),
    "r4.large": MachineProfile("r4.large", 1100, 13000, 3000, 310, 10.0, 100),
    "r4.xlarge": MachineProfile("r4.xlarge", 2150, 25500, 6000, 285, 10.0,
                                95),
    "r4.2xlarge": MachineProfile("r4.2xlarge", 4200, 50000, 8000, 265, 10.0,
                                 90),
}

# ChaosMesh-style stress: multiplicative degradation per resource aspect
# at full severity; actual runs draw severity in (0, 1] and interpolate,
# so mild degradations overlap with run-to-run noise (the regime that
# caps the paper's outlier F1 at 0.75).
STRESS_FACTORS = {
    "cpu": {"cpu": 0.45},
    "memory": {"memory": 0.5, "cpu": 0.85},
    "disk": {"disk_iops": 0.35, "disk_lat_us": 2.8},
    "network": {"net_gbps": 0.4, "net_lat_us": 2.5},
}


def stress_multiplier(full_factor: float, severity: float) -> float:
    """Interpolate a full-severity factor toward 1.0 (no effect)."""
    return 1.0 + severity * (full_factor - 1.0)
