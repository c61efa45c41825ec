"""Runtime: the Perona degradation watchdog."""

from repro_torch.runtime.watchdog import PeronaWatchdog

__all__ = ["PeronaWatchdog"]
