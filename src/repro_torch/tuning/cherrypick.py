"""CherryPick re-implementation (Alipourfard et al., NSDI'17).

Bayesian optimization over cloud configurations: model cost(config) with
a GP, pick the next config by expected improvement, subject to a runtime
constraint; stop when EI/best < threshold or the run budget is used.
The objective is *execution cost*, valid configurations satisfy the
runtime constraint (paper §IV-D setup).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from repro_torch.tuning.gp import GP, expected_improvement
from repro_torch.tuning.scout import CloudConfig, ScoutDataset


@dataclasses.dataclass
class SearchTrace:
    evaluated: List[CloudConfig]
    costs: List[float]
    runtimes: List[float]
    best_valid_cost: List[float]  # running cheapest-valid after each run
    search_cost: float  # total $ spent profiling


class CherryPick:
    name = "cherrypick"

    def __init__(self, dataset: ScoutDataset, runtime_limit_s: float,
                 max_runs: int = 9, n_init: int = 3, ei_threshold: float = 0.1,
                 seed: int = 0, acquisition_weighter=None):
        self.ds = dataset
        self.limit = runtime_limit_s
        self.max_runs = max_runs
        self.n_init = n_init
        self.ei_threshold = ei_threshold
        self.rng = np.random.default_rng(seed)
        self.weighter = acquisition_weighter

    def _features(self, config) -> np.ndarray:
        return self.ds.config_features(config)

    def _on_evaluate(self, workload: str, config: CloudConfig):
        """Hook for subclasses (Arrow records low-level metrics here)."""

    def search(self, workload: str) -> SearchTrace:
        configs = list(self.ds.configs)
        X = np.stack([self._features(c) for c in configs])
        evaluated, costs, runtimes, best_curve = [], [], [], []
        seen = set()

        def evaluate(c: CloudConfig):
            rt = self.ds.runtime_s(workload, c)
            cost = self.ds.cost_usd(workload, c)
            evaluated.append(c)
            runtimes.append(rt)
            costs.append(cost)
            seen.add(c.key)
            self._on_evaluate(workload, c)
            valid = [co for co, r in zip(costs, runtimes) if r <= self.limit]
            best_curve.append(min(valid) if valid else np.inf)

        # quasi-random init spread over VM families (paper: >=1 run first)
        init_idx = self.rng.choice(len(configs), self.n_init, replace=False)
        for i in init_idx:
            evaluate(configs[i])

        while len(evaluated) < self.max_runs:
            y = np.asarray([
                c if r <= self.limit else c * 5.0  # constraint penalty
                for c, r in zip(costs, runtimes)])
            gp = GP().fit(np.stack([self._features(c) for c in evaluated]),
                          y)
            mu, sigma = gp.predict(X)
            best = float(np.min(y))
            ei = expected_improvement(mu, sigma, best)
            if self.weighter is not None:
                any_valid = any(r <= self.limit for r in runtimes)
                ei = self.weighter(configs, ei, workload=workload,
                                   evaluated=evaluated,
                                   any_valid=any_valid)
            ei = np.asarray([
                e if c.key not in seen else -np.inf
                for c, e in zip(configs, ei)])
            # select on float32-rounded EI: a deterministic tie-break
            # grid. Near-identical configurations (e.g. adjacent
            # scaleouts of one VM type) can tie to within float64 ulps,
            # where backend rounding differences would make the argmax
            # arbitrary; the batched replay engine (optimizer.replay)
            # rounds identically and reproduces these traces exactly.
            ei = ei.astype(np.float32).astype(np.float64)
            if np.max(ei) <= 0:
                break
            if np.max(ei) / max(best, 1e-9) < self.ei_threshold \
                    and len(evaluated) >= self.n_init + 2:
                break
            evaluate(configs[int(np.argmax(ei))])

        return SearchTrace(
            evaluated=evaluated, costs=costs, runtimes=runtimes,
            best_valid_cost=best_curve, search_cost=float(np.sum(costs)))
