"""Perona's tuner integration (paper §IV-D).

The acquisition values of CherryPick/Arrow are weighted by a sum of
products: for each resource aspect, (configuration utilization factor) x
(representation-based score of the machine type's fingerprint)
(:class:`PeronaAcquisitionWeighter`). Machine fingerprints come from
benchmarking the candidate machine types once (10 runs a type in the
paper), training Perona on the executions and scoring each type's codes
per resource aspect with the p-norm (:func:`fingerprint_machine_scores`,
the "540 executions" procedure, which runs the edge-softmax kernels on
the card); :func:`normalized_machine_scores` normalizes the score
vectors across types and :func:`calibrate_scores` maps them onto raw
capability proxies.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.core.ranking import aspect_scores, machine_score_vector
from repro_torch.fingerprint.runner import SuiteRunner
from repro_torch.launch.train import train_on_records
from repro_torch.tuning.scout import PRICES, CloudConfig, ScoutDataset


def normalized_machine_scores(machine_scores: Dict[str, Dict[str, float]]
                              ) -> Dict[str, np.ndarray]:
    """Per-aspect min-max normalization (+0.1 floor) of machine score
    vectors across types: the weighter's precomputation, shared with
    ``optimizer.scenarios`` so batched lanes use bit-identical weighting
    inputs."""
    mats = {m: machine_score_vector(machine_scores, m)
            for m in machine_scores}
    arr = np.stack(list(mats.values()))
    lo, hi = arr.min(0), arr.max(0)
    rng = np.where(hi > lo, hi - lo, 1.0)
    return {m: (v - lo) / rng + 0.1 for m, v in mats.items()}


class PeronaAcquisitionWeighter:
    """Paper §IV-D integration: acquisition values are weighted by a sum
    of products over resource aspects — (the target workload's observed
    utilization of the aspect, from the profiling runs so far) x (the
    machine type's representation-based score for that aspect). A
    cpu-bound workload therefore steers the search toward machine types
    whose *fingerprint* says they are strong on cpu, before ever running
    on them."""

    def __init__(self, dataset: ScoutDataset,
                 machine_scores: Dict[str, Dict[str, float]],
                 strength: float = 0.3, per_dollar: bool = True):
        """strength: interpolation toward the weighted acquisition (the
        weighting is a prior, not a replacement for EI); per_dollar:
        divide scores by the on-demand price — the objective is the
        *cheapest* valid configuration, so the fingerprint prior should
        encode cost-effectiveness, not raw capability."""
        self.ds = dataset
        self.scores = machine_scores
        self.strength = strength
        self.per_dollar = per_dollar
        self.prices = PRICES
        # normalize scores across machine types per aspect
        self.norm_scores = normalized_machine_scores(machine_scores)

    def __call__(self, configs: Sequence[CloudConfig],
                 acquisition: np.ndarray, workload: str = None,
                 evaluated: Sequence[CloudConfig] = (),
                 any_valid: bool = True) -> np.ndarray:
        """Two-phase prior (the paper's 'less prone to timeouts ... and
        eventually a more cost-effective configuration'): while NO valid
        configuration is known, weight by raw fingerprint capability for
        the workload's bottleneck resources (find something that meets
        the runtime constraint); once one exists, weight by capability
        per dollar (hunt for the cheapest valid one)."""
        if workload is not None and evaluated:
            util = np.mean([self.ds.low_level_metrics(workload, c)
                            for c in evaluated], axis=0)
        else:
            util = np.ones(4)
        util = util / max(util.sum(), 1e-9)
        weights = []
        for c in configs:
            s = float(np.sum(util * self.norm_scores.get(c.vm_type,
                                                         np.ones(4))))
            if self.per_dollar and any_valid:
                s = s / self.prices[c.vm_type]
            weights.append(s)
        weights = np.asarray(weights)
        weights = weights / max(weights.mean(), 1e-9)
        return acquisition * (1.0 + self.strength * (weights - 1.0))


# canonical raw metric per aspect, for score->capability calibration
_PROXY_METRIC = {
    "cpu": "cpu.events_per_second",
    "memory": "mem.throughput",
    "disk": "fio.read.iops",
    "network": "qperf.tcp_bw",
}


def fingerprint_machine_scores(machine_types, *, seed: int = 0,
                               runs_per_type: int = 10, epochs: int = 60,
                               return_calibration: bool = False,
                               device="cuda", params0=None):
    """Benchmark each machine type, train Perona on the executions, and
    return {machine_type: {aspect: score}} (one simulated node per
    type). ``params0``: initial parameters as the reference's nested
    tree, else the port's seeded initialisation.

    With ``return_calibration=True`` also returns capability proxies
    {machine_type: {aspect: raw value}} from Perona's own benchmark
    records, for :func:`calibrate_scores`.
    """
    runner = SuiteRunner(seed=seed)
    machines = {f"{m}-0": m for m in machine_types}
    records = runner.run(machines, runs_per_type=runs_per_type)
    _, _, _, codes = train_on_records(records, seed=seed, epochs=epochs,
                                      device=device, params0=params0)
    scores = aspect_scores(codes, [r.benchmark_type for r in records],
                           [r.machine_type for r in records])
    if not return_calibration:
        return scores
    proxies: Dict[str, Dict[str, list]] = {}
    for r in records:
        for aspect, metric in _PROXY_METRIC.items():
            if metric in r.metrics:
                proxies.setdefault(r.machine_type, {}).setdefault(
                    aspect, []).append(float(r.metrics[metric][0]))
    proxy_means = {m: {a: float(np.mean(v)) for a, v in per.items()}
                   for m, per in proxies.items()}
    return scores, proxy_means


def calibrate_scores(scores: Dict[str, Dict[str, float]],
                     proxies: Dict[str, Dict[str, float]]
                     ) -> Dict[str, Dict[str, float]]:
    """Per aspect, least-squares affine map score -> capability proxy
    across machine types (it dampens score-ranking errors)."""
    out: Dict[str, Dict[str, float]] = {m: {} for m in scores}
    aspects = sorted({a for per in scores.values() for a in per})
    for a in aspects:
        ms = [m for m in scores if a in scores[m] and a in proxies.get(m, {})]
        s = np.asarray([scores[m][a] for m in ms])
        p = np.asarray([proxies[m][a] for m in ms])
        if len(ms) >= 2 and np.std(s) > 1e-9:
            A = np.stack([s, np.ones_like(s)], axis=1)
            coef, *_ = np.linalg.lstsq(A, p, rcond=None)
            fit = A @ coef
        else:
            fit = p
        for m, v in zip(ms, fit):
            out[m][a] = float(max(v, 1e-9))
    return out
