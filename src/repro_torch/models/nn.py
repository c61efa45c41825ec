"""The linear layer of ``repro.models.nn`` as a PyTorch module.

The weight keeps the reference layout ``w (d_in, d_out)`` and the layer
computes ``y = x @ w + b``, so parameters cross between the packages
without a transpose (``torch.nn.Linear`` stores ``(d_out, d_in)``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # fan-in scaled normal weights and zero bias, the scheme of
        # repro.models.nn.linear_init (the draws differ from jax.random)
        self.w = nn.Parameter(
            torch.randn(d_in, d_out, generator=generator)
            / math.sqrt(max(d_in, 1)))
        self.b = nn.Parameter(torch.zeros(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w.to(x.dtype)
        if self.b is not None:
            y = y + self.b.to(x.dtype)
        return y
