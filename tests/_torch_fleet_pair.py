"""One fleet set-up in both packages, for the port's fleet-tier tests.

The same seeded telemetry (``SuiteRunner(seed)`` in each package, equal
bit for bit), the same fitted preprocessor statistics, and the JAX
package's untrained ``model.init(PRNGKey(0))`` parameters carried into
the port through ``core.params.params_from_numpy``, as the reference's
own fleet tests score with untrained parameters.
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np

from repro.core.graph_data import build_graphs as jbuild_graphs
from repro.core.model import PeronaConfig as JConfig
from repro.core.model import PeronaModel as JModel
from repro.core.preprocess import Preprocessor as JPreprocessor
from repro.fingerprint.runner import SuiteRunner as JRunner
from repro_torch.core.model import PeronaConfig, PeronaModel
from repro_torch.core.params import params_from_numpy
from repro_torch.core.preprocess import Preprocessor
from repro_torch.fingerprint.runner import SuiteRunner

DAY = 86400.0
MACHINES = {"in-0": "e2-medium", "in-1": "n2-standard-4",
            "in-2": "e2-medium"}


def fleet_pair(machines=MACHINES, seed=5, runs_per_type=10):
    """``jax`` and ``torch`` namespaces, each with ``runner`` (already
    past the history draw), ``frame`` (the history), ``pre``, ``model``
    and ``params``."""
    jr, tr = JRunner(seed=seed), SuiteRunner(seed=seed)
    jframe = jr.run_frame(machines, runs_per_type=runs_per_type,
                          stress_fraction=0.2)
    tframe = tr.run_frame(machines, runs_per_type=runs_per_type,
                          stress_fraction=0.2)
    jpre = JPreprocessor().fit(jframe)
    cfg = JConfig(feature_dim=jpre.feature_dim,
                  edge_dim=jbuild_graphs(jframe, jpre).edge.shape[-1])
    jmodel = JModel(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))  # untrained
    return SimpleNamespace(
        machines=machines,
        jax=SimpleNamespace(runner=jr, frame=jframe, pre=jpre,
                            model=jmodel, params=jparams),
        torch=SimpleNamespace(
            runner=tr, frame=tframe, pre=Preprocessor().fit(tframe),
            model=PeronaModel(PeronaConfig(**dataclasses.asdict(cfg))),
            params=params_from_numpy(
                jax.tree_util.tree_map(np.asarray, jparams))))


def int_stats(stats):
    """The integer keys of a ``stats`` dict (bools and floats left out:
    wall times differ between runs)."""
    return {k: v for k, v in stats.items()
            if isinstance(v, (int, np.integer)) and not isinstance(v, bool)}
