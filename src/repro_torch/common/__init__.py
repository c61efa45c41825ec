"""Shared primitives: pow2 bucketing, counter-based RNG streams (host and
device), padded batch axes, device choice, and the string -> factory
:class:`Registry` (exported here as ``repro/common/__init__.py`` exports
it)."""

from repro_torch.common.registry import Registry

__all__ = ["Registry"]
