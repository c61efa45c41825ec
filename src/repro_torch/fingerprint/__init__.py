"""Benchmark substrate: standardized tool suites over simulated machines
(numpy; a copy of ``repro.fingerprint``)."""

from repro_torch.fingerprint.frame import (BenchmarkFrame, as_frame,
                                           concat_frames)
from repro_torch.fingerprint.machines import MACHINE_PROFILES, MachineProfile
from repro_torch.fingerprint.records import BenchmarkExecution
from repro_torch.fingerprint.runner import BENCHMARK_TYPES, SuiteRunner

__all__ = [
    "BenchmarkExecution",
    "BenchmarkFrame",
    "as_frame",
    "concat_frames",
    "MachineProfile",
    "MACHINE_PROFILES",
    "SuiteRunner",
    "BENCHMARK_TYPES",
]
