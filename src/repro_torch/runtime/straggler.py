"""Straggler detection from per-host step timings (a copy of
``repro/runtime/straggler.py``).

At pod scale the slowest host gates every synchronous collective, so a
persistent straggler is a cluster-wide slowdown. The monitor keeps an
EWMA of per-host step times, flags hosts slower than
``ratio_threshold`` x cluster median for ``patience`` consecutive steps,
and hands the flagged host to the Perona watchdog for confirmation
(fingerprint-confirmed degradation -> exclusion; unconfirmed -> likely
transient interference, keep the node).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerEvent:
    host: str
    step: int
    ewma_ms: float
    median_ms: float


class StragglerMonitor:
    def __init__(self, ratio_threshold: float = 1.35, patience: int = 5,
                 alpha: float = 0.3):
        self.ratio_threshold = ratio_threshold
        self.patience = patience
        self.alpha = alpha
        self._ewma: Dict[str, float] = {}
        self._strikes: Dict[str, int] = {}
        self.events: List[StragglerEvent] = []

    def record_step(self, step: int, host_times_ms: Dict[str, float]
                    ) -> List[StragglerEvent]:
        for host, t in host_times_ms.items():
            prev = self._ewma.get(host, t)
            self._ewma[host] = (1 - self.alpha) * prev + self.alpha * t
        med = float(np.median(list(self._ewma.values())))
        flagged = []
        for host, ew in self._ewma.items():
            if ew > self.ratio_threshold * med:
                self._strikes[host] = self._strikes.get(host, 0) + 1
            else:
                self._strikes[host] = 0
            if self._strikes[host] >= self.patience:
                ev = StragglerEvent(host=host, step=step, ewma_ms=ew,
                                    median_ms=med)
                flagged.append(ev)
                self.events.append(ev)
                self._strikes[host] = 0  # hand off; reset
        return flagged
