"""Tarema-style node grouping (Bader et al., BigData'21) + §IV-E check.

Tarema groups heterogeneous cluster nodes by microbenchmark similarity
and allocates tasks to groups by resource usage. The paper's experiment
mocks Tarema's group build with Perona fingerprint scores and verifies
the *same node groups* emerge (hence identical workflow makespans).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.fingerprint.machines import MACHINE_PROFILES
from repro_torch.tuning.lotaru import microbenchmark_vector, perona_vector


def group_nodes(vectors: Dict[str, np.ndarray], tol: float = 0.2
                ) -> List[List[str]]:
    """Greedy agglomeration on min-max-normalized capability vectors:
    nodes within ``tol`` on every (normalized) aspect share a group.
    Normalization makes raw microbenchmark values and Perona scores
    directly comparable grouping inputs (scale-free)."""
    nodes = sorted(vectors)
    arr = np.stack([vectors[n] for n in nodes]).astype(float)
    lo, hi = arr.min(0), arr.max(0)
    rng = np.where(hi > lo, hi - lo, 1.0)
    norm = {n: (vectors[n] - lo) / rng for n in nodes}
    groups: List[List[str]] = []
    for node in nodes:
        placed = False
        for g in groups:
            if np.all(np.abs(norm[node] - norm[g[0]]) <= tol):
                g.append(node)
                placed = True
                break
        if not placed:
            groups.append([node])
    return [sorted(g) for g in groups]


def groups_from_microbenchmarks(machines: Dict[str, str]) -> List[List[str]]:
    return group_nodes({node: microbenchmark_vector(mt)
                        for node, mt in machines.items()})


def groups_from_perona(machines: Dict[str, str],
                       machine_scores: Dict[str, Dict[str, float]]
                       ) -> List[List[str]]:
    return group_nodes({node: perona_vector(machine_scores, mt)
                        for node, mt in machines.items()})


def same_grouping(a: List[List[str]], b: List[List[str]]) -> bool:
    canon = lambda g: sorted(tuple(x) for x in g)
    return canon(a) == canon(b)
