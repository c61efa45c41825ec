"""Record type for one benchmark execution (one Kubestone job run)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass
class BenchmarkExecution:
    benchmark_type: str  # e.g. "sysbench-cpu"
    machine: str  # node name, e.g. "node-1"
    machine_type: str  # e.g. "e2-medium"
    t: float  # wall-clock seconds since experiment start
    metrics: Dict[str, Tuple[float, str]]  # name -> (value, unit)
    node_metrics: Dict[str, float]  # low-level machine metrics during run
    stressed: bool  # ground-truth degradation marker (eval only)

    @property
    def resource_aspect(self) -> str:
        return {
            "sysbench-cpu": "cpu",
            "sysbench-memory": "memory",
            "fio": "disk",
            "ioping": "disk",
            "qperf": "network",
            "iperf3": "network",
        }[self.benchmark_type]
