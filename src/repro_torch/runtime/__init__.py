"""Runtime: the Perona degradation watchdog and the straggler monitor.
The fault-tolerant training loop (``fault``) comes with LM training."""

from repro_torch.runtime.straggler import StragglerEvent, StragglerMonitor
from repro_torch.runtime.watchdog import PeronaWatchdog

__all__ = ["PeronaWatchdog", "StragglerEvent", "StragglerMonitor"]
