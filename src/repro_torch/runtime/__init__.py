"""Runtime: the Perona degradation watchdog, the straggler monitor and
the fault-tolerant training loop (``fault``)."""

from repro_torch.runtime.fault import (FailureInjector, RuntimeEvent,
                                       TrainingRuntime)
from repro_torch.runtime.straggler import StragglerEvent, StragglerMonitor
from repro_torch.runtime.watchdog import PeronaWatchdog

__all__ = ["FailureInjector", "PeronaWatchdog", "RuntimeEvent",
           "StragglerEvent", "StragglerMonitor", "TrainingRuntime"]
