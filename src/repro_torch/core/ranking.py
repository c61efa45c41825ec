"""Aspect-based resource ranking (paper §III-D application).

A learned code's quality score is its p-norm (p=10); scores aggregate
per (machine x benchmark type), and benchmark types map onto resource
aspects (cpu / memory / disk / network) for fine-granular ranking.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

ASPECT_OF_TYPE = {
    "sysbench-cpu": "cpu",
    "sysbench-memory": "memory",
    "fio": "disk",
    "ioping": "disk",
    "qperf": "network",
    "iperf3": "network",
}


def code_scores(codes: np.ndarray, p: float = 10.0) -> np.ndarray:
    return np.power(
        np.power(np.abs(codes) + 1e-12, p).sum(-1), 1.0 / p)


def aspect_scores(codes: np.ndarray, type_names: Sequence[str],
                  machines: Sequence[str], p: float = 10.0
                  ) -> Dict[str, Dict[str, float]]:
    """Returns {machine: {aspect: mean score}}."""
    s = code_scores(codes, p)
    out: Dict[str, Dict[str, List[float]]] = {}
    for score, btype, machine in zip(s, type_names, machines):
        aspect = ASPECT_OF_TYPE[btype]
        out.setdefault(machine, {}).setdefault(aspect, []).append(
            float(score))
    return {m: {a: float(np.mean(v)) for a, v in per.items()}
            for m, per in out.items()}


def rank_machines(scores: Dict[str, Dict[str, float]],
                  aspect: str = None) -> List[str]:
    """Machines ranked best-first by mean (or per-aspect) score."""
    def key(m):
        per = scores[m]
        if aspect is not None:
            return per.get(aspect, 0.0)
        return float(np.mean(list(per.values())))

    return sorted(scores, key=key, reverse=True)


def machine_score_vector(scores: Dict[str, Dict[str, float]],
                         machine: str) -> np.ndarray:
    """(cpu, memory, disk, network) score vector for tuner integration."""
    per = scores.get(machine, {})
    return np.asarray([per.get(a, 0.0)
                       for a in ("cpu", "memory", "disk", "network")])


def machine_score_matrix(scores: Dict[str, Dict[str, float]],
                         machines: Sequence[str]) -> np.ndarray:
    """(len(machines), 4) stacked score vectors — the batched-input
    form consumed by the optimizer's batched acquisition weighting."""
    if not len(machines):
        return np.zeros((0, 4))
    return np.stack([machine_score_vector(scores, m) for m in machines])
