"""Lotaru-style task-runtime prediction for heterogeneous clusters
(Bader et al., SSDBM'22) + the paper's §IV-E substitution experiment.

Lotaru predicts a workflow task's runtime on a target node by profiling
the task locally (small inputs on a local machine) and scaling by an
adjustment factor derived from microbenchmarks of local vs target nodes.
Perona's variant replaces the raw microbenchmark values with fingerprint
scores. Baselines from the Lotaru paper: Naive (mean runtime ratio),
Online-M / Online-P (median/percentile online estimators without
benchmarking).

Evaluation metric: median / P90 / P95 of |pred - actual| / actual over
synthetic workflow tasks with heterogeneous resource profiles (Table III
analogue).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.fingerprint.machines import MACHINE_PROFILES


@dataclasses.dataclass
class Task:
    name: str
    cpu_frac: float  # fraction of work bound by cpu
    disk_frac: float
    mem_frac: float
    base_work: float


def make_workflow(rng, n_tasks: int = 24) -> List[Task]:
    tasks = []
    for i in range(n_tasks):
        f = rng.dirichlet([2.0, 1.2, 0.8])
        tasks.append(Task(
            name=f"task-{i}", cpu_frac=float(f[0]), disk_frac=float(f[1]),
            mem_frac=float(f[2]), base_work=float(rng.uniform(50, 900))))
    return tasks


def true_runtime(task: Task, machine_type: str, rng=None) -> float:
    p = MACHINE_PROFILES[machine_type]
    t = task.base_work * (
        task.cpu_frac * 1000.0 / p.cpu
        + task.disk_frac * 15000.0 / p.disk_iops
        + task.mem_frac * 10000.0 / p.memory)
    if rng is not None:
        t *= float(np.exp(rng.normal(0, 0.05)))
    return float(t)


def predict_factor(task: Task, local_vec: np.ndarray, target_vec: np.ndarray
                   ) -> float:
    """Adjustment factor f with pred_target = local_runtime * f.

    Runtime ~ sum_i w_i / cap_i, so f ~ sum_i w_i * cap_local_i /
    cap_target_i with weights = the task's local resource-time fractions
    (Lotaru's local-profile scheme)."""
    w = np.asarray([task.cpu_frac, task.disk_frac, task.mem_frac])
    ratio = np.clip(local_vec, 1e-9, None) / np.clip(target_vec, 1e-9, None)
    return float(np.sum(w * ratio))


def microbenchmark_vector(machine_type: str) -> np.ndarray:
    """Lotaru's raw microbenchmark values (cpu events/s, disk iops,
    memory MiB/s)."""
    p = MACHINE_PROFILES[machine_type]
    return np.asarray([p.cpu, p.disk_iops, p.memory])


def perona_vector(machine_scores: Dict[str, Dict[str, float]],
                  machine_type: str) -> np.ndarray:
    """(cpu, disk, memory) capability vector from Perona fingerprints —
    pass *calibrated* scores (repro_torch.tuning.perona_weights
    .calibrate_scores) when ratios matter (Lotaru)."""
    per = machine_scores[machine_type]
    return np.asarray([per.get("cpu", 1e-9), per.get("disk", 1e-9),
                       per.get("memory", 1e-9)])


def evaluate_predictors(machine_scores: Dict[str, Dict[str, float]],
                        *, local_type: str = "e2-medium",
                        target_types: Sequence[str] = (
                            "n1-standard-4", "n2-standard-4",
                            "c2-standard-4"),
                        n_workflows: int = 8, seed: int = 0
                        ) -> Dict[str, Dict[str, float]]:
    """Table III analogue: error percentiles per method."""
    rng = np.random.default_rng(seed)
    errors: Dict[str, List[float]] = {
        "naive": [], "online_m": [], "online_p": [], "lotaru": [],
        "perona": []}
    for _ in range(n_workflows):
        tasks = make_workflow(rng)
        for task in tasks:
            local_rt = true_runtime(task, local_type, rng)
            history = [true_runtime(t, local_type, rng) for t in tasks[:6]]
            for tgt in target_types:
                actual = true_runtime(task, tgt, rng)
                # Naive: assume same runtime as local
                errors["naive"].append(abs(local_rt - actual) / actual)
                # Online-M/P: median/percentile of unrelated history
                om = float(np.median(history))
                op = float(np.percentile(history, 25))
                errors["online_m"].append(abs(om - actual) / actual)
                errors["online_p"].append(abs(op - actual) / actual)
                # Lotaru: microbenchmark factors
                f = predict_factor(task, microbenchmark_vector(local_type),
                                   microbenchmark_vector(tgt))
                errors["lotaru"].append(abs(local_rt * f - actual) / actual)
                # Perona: fingerprint score factors (calibrated, §IV-E's
                # "adjusted the estimation process")
                fp = predict_factor(
                    task, perona_vector(machine_scores, local_type),
                    perona_vector(machine_scores, tgt))
                errors["perona"].append(
                    abs(local_rt * fp - actual) / actual)
    out = {}
    for k, v in errors.items():
        arr = np.asarray(v)
        out[k] = {"median": float(np.median(arr)),
                  "p90": float(np.percentile(arr, 90)),
                  "p95": float(np.percentile(arr, 95))}
    return out
