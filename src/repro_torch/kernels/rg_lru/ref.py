"""Plain PyTorch versions of the RG-LRU linear scan.

``linear_scan`` mirrors ``repro/kernels/rg_lru/ref.py``: ``h_t = a_t *
h_{t-1} + b_t`` per channel, in float32, from ``h0`` (zeros when
absent). The reference combines with an associative scan; here it is a
loop over time. The CPU tests use it, ``chip_smoke.py`` holds the CUDA
kernel against it on the card (and against its float64 evaluation), and
the kernel wrapper (``ops``) takes it for tensors that lie on the CPU.

``linear_scan_chunked`` is the same recurrence in the CUDA kernel's
order (chunk aggregates, a forward recursion over them, a rescan of each
chunk), for the tests; nothing on the model's path calls it.
"""

from __future__ import annotations

import torch


def linear_scan(a, b, h0=None, dtype=torch.float32):
    """a, b: (B, S, C); h0: optional (B, C). Returns (y (B, S, C), h_last
    (B, C)), computed and returned in ``dtype``."""
    a = a.to(dtype)
    b = b.to(dtype)
    B, S, C = a.shape
    h = (torch.zeros(B, C, dtype=dtype, device=a.device)
         if h0 is None else h0.to(dtype))
    y = torch.empty(B, S, C, dtype=dtype, device=a.device)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        y[:, t] = h
    return y, h.clone()


def _fma(x, y, z):
    """The kernel's fmaf: x * y + z rounded once to float32. x * y is
    exact in float64; the sum is rounded to float64 first, so in rare
    ties the result may sit one float32 step from fmaf's."""
    return (x.double() * y.double() + z.double()).float()


def linear_scan_chunked(a, b, h0=None, chunk=32):
    """``linear_scan`` in float32, in the order of ``csrc/rg_lru.cu``
    with chunks of ``chunk`` steps: per chunk k, A_k = prod a_t (step
    order) and H_k = the chunk's scan from 0; then P_k = fma(A_k,
    P_{k-1}, H_k) from P_{-1} = h0 (or 0); then each chunk rescanned from
    P_{k-1}. A short last chunk is padded with a = 1, b = 0, which changes
    nothing. Returns (y (B, S, C), h_last (B, C)), float32."""
    a = a.float()
    b = b.float()
    B, S, C = a.shape
    n = -(-S // chunk)
    pad = n * chunk - S
    a = torch.cat([a, a.new_ones(B, pad, C)], 1).view(B, n, chunk, C)
    b = torch.cat([b, b.new_zeros(B, pad, C)], 1).view(B, n, chunk, C)
    A, H = a[:, :, 0], b[:, :, 0]
    for i in range(1, chunk):
        A = A * a[:, :, i]
        H = _fma(a[:, :, i], H, b[:, :, i])
    p = (torch.zeros(B, C, dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    starts = []
    for k in range(n):
        starts.append(p)
        p = _fma(A[:, k], p, H[:, k])
    h = torch.stack(starts, 1)  # (B, n, C): P_{k-1} of each chunk
    y = torch.empty_like(a)
    for i in range(chunk):
        h = _fma(a[:, :, i], h, b[:, :, i])
        y[:, :, i] = h
    y = y.view(B, n * chunk, C)[:, :S].contiguous()
    return y, y[:, -1].clone()
