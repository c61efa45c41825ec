"""Optimizers of the port (``repro.optim``)."""

from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.optim.compress import compress_gradients, decompress_gradients
from repro_torch.optim.schedule import cosine_schedule, linear_warmup

__all__ = [
    "AdamW",
    "OptState",
    "cosine_schedule",
    "linear_warmup",
    "compress_gradients",
    "decompress_gradients",
]
