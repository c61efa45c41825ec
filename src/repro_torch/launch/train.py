"""Cluster fingerprinting for the LM training entry point.

The PyTorch counterpart of ``repro/launch/train.py::fingerprint_cluster``
(`:47-66`): benchmark the cluster's hosts with the standardized suite,
train Perona on the executions (``core.trainer.train_perona``), score
every execution and rank the hosts, and hand back a watchdog that holds
the trained model and the acquisition as its history. The rest of that
file, the fault-tolerant LM training loop, is not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.graph_data import build_graphs, chronological_split
from repro_torch.core.model import PeronaConfig, PeronaModel
from repro_torch.core.params import flat_params, params_from_numpy
from repro_torch.core.preprocess import Preprocessor
from repro_torch.core.ranking import aspect_scores, rank_machines
from repro_torch.core.trainer import batch_to_torch, train_perona
from repro_torch.fingerprint.runner import SuiteRunner
from repro_torch.runtime.watchdog import PeronaWatchdog


def train_on_records(records, *, seed=0, epochs=40, device="cuda",
                        params0=None):
    """Perona trained on ``records`` (70/30 chronological split) and the
    codes of every record: (model holding the selected parameters,
    training result, preprocessor, codes). ``params0``: initial
    parameters as the reference's nested tree (``core.params``), else
    the port's seeded initialisation."""
    dev = resolve_device(device)
    train_r, val_r, _ = chronological_split(records, (0.7, 0.3, 0.0))
    pre = Preprocessor().fit(train_r)
    tb, vb = build_graphs(train_r, pre), build_graphs(val_r, pre)
    cfg = PeronaConfig(feature_dim=pre.feature_dim,
                       edge_dim=tb.edge.shape[-1])
    model = PeronaModel(cfg, generator=torch.Generator().manual_seed(seed))
    if params0 is not None:
        model.load_state_dict(flat_params(params_from_numpy(params0)))
    res = train_perona(model, tb, vb, epochs=epochs, seed=seed, device=dev)
    with torch.no_grad():
        out = model(batch_to_torch(build_graphs(records, pre), dev))
    return model, res, pre, out["codes"].cpu().numpy()


def fingerprint_cluster(machines, *, seed=0, epochs=40, runs_per_type=8,
                        device="cuda", params0=None):
    """Rank cluster nodes with Perona; returns (watchdog, ranked_nodes,
    runner). ``machines``: {node: machine type}."""
    runner = SuiteRunner(seed=seed)
    records = runner.run(machines, runs_per_type=runs_per_type)
    model, res, pre, codes = train_on_records(
        records, seed=seed, epochs=epochs, device=device, params0=params0)
    scores = aspect_scores(codes, [r.benchmark_type for r in records],
                           [r.machine for r in records])
    ranked = rank_machines(scores)
    watchdog = PeronaWatchdog(model, res.params, pre, device=device)
    watchdog.history = list(records)
    return watchdog, ranked, runner
