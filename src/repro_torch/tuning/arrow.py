"""Arrow re-implementation (Hsu et al., ICDCS'18).

Augmented Bayesian optimization: the GP input of an *evaluated* config is
augmented with low-level metrics observed during its profiling run; for
un-evaluated candidates the low-level block is imputed with the mean of
observed runs. With Perona (paper §IV-D), the low-level metrics are
replaced by the fingerprint scores of the machine type.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.tuning.cherrypick import CherryPick, SearchTrace
from repro_torch.tuning.scout import CloudConfig, ScoutDataset


class Arrow(CherryPick):
    name = "arrow"

    def __init__(self, dataset: ScoutDataset, runtime_limit_s: float,
                 low_level_fn: Optional[Callable] = None, **kw):
        super().__init__(dataset, runtime_limit_s, **kw)
        # default low-level source: utilization metrics of the actual run
        self.low_level_fn = low_level_fn
        self._low_cache = {}

    def _low(self, workload: str, config: CloudConfig) -> np.ndarray:
        key = (workload, config.key)
        if key not in self._low_cache:
            if self.low_level_fn is not None:
                self._low_cache[key] = self.low_level_fn(workload, config)
            else:
                self._low_cache[key] = self.ds.low_level_metrics(
                    workload, config)
        return self._low_cache[key]

    def search(self, workload: str) -> SearchTrace:
        self._workload = workload
        self._observed_lows = []
        self._low_cache = {}
        return super().search(workload)

    def _on_evaluate(self, workload: str, config: CloudConfig):
        low = self._low(workload, config)
        self._low_cache[(workload, config.key)] = low
        self._observed_lows.append(low)

    def _features(self, config) -> np.ndarray:
        base = self.ds.config_features(config)
        wl = getattr(self, "_workload", None)
        if wl is None:
            return base
        key = (wl, config.key)
        if key in self._low_cache:
            low = self._low_cache[key]
        elif self.low_level_fn is not None:
            # Perona mode: fingerprint scores exist *before* any run —
            # the machine was benchmarked once, independent of workload
            low = self._low(wl, config)
        elif self._observed_lows:
            low = np.mean(np.stack(self._observed_lows), axis=0)
        else:
            low = np.zeros(4)
        return np.concatenate([base, low])
