"""Plain PyTorch version of the RG-LRU linear scan.

Mirrors ``repro/kernels/rg_lru/ref.py``: ``h_t = a_t * h_{t-1} + b_t``
per channel, in float32, from ``h0`` (zeros when absent). The
reference combines with an associative scan; here it is a loop over
time, which gives the same recurrence in the order the kernel takes.

The CPU tests use it, ``chip_smoke.py`` holds the CUDA kernel against
it on the card, and the kernel wrapper (``ops``) takes it for tensors
that lie on the CPU.
"""

from __future__ import annotations

import torch


def linear_scan(a, b, h0=None):
    """a, b: (B, S, C); h0: optional (B, C). Returns (y (B, S, C) float32,
    h_last (B, C) float32)."""
    a = a.float()
    b = b.float()
    B, S, C = a.shape
    h = (torch.zeros(B, C, dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    y = torch.empty(B, S, C, dtype=torch.float32, device=a.device)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        y[:, t] = h
    return y, h.clone()
