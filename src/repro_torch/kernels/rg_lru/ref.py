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

``linear_scan_bwd`` is the scan's gradient, the function of the backward
kernel and of the reference's VJP (``jax.vjp`` of its plain scan): a
loop over time in reverse, in float32 or float64. The tests and
``chip_smoke.py`` use it; on the CPU the model's training takes autograd
through ``linear_scan``'s loop instead. ``linear_scan_bwd_chunked`` is
it in the backward kernel's order.
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


def _gradients(a, y, h0, dh):
    """(da, db, dh0) of the scan from dh_t = dL/dh_t: db = dh, da_t =
    dh_t h_{t-1} with h_{-1} = h0 (or 0), dh0 = a_0 dh_0 (None without
    h0)."""
    first = torch.zeros_like(y[:, 0]) if h0 is None else h0.to(y.dtype)
    prev = torch.cat([first[:, None], y[:, :-1]], 1)
    dh0 = None if h0 is None else a[:, 0] * dh[:, 0]
    return dh * prev, dh, dh0


def linear_scan_bwd(a, y, h0, g_y, g_last=None, dtype=torch.float32):
    """The gradient of ``linear_scan``: a, y (its output), g_y (y's
    cotangent) (B, S, C); h0 and g_last (h_last's cotangent) (B, C) or
    None. dh_{S-1} = g_{S-1} + g_last, dh_t = a_{t+1} dh_{t+1} + g_t.
    Returns (da, db (B, S, C), dh0 (B, C) or None), in ``dtype``."""
    a, y, g = (t.to(dtype) for t in (a, y, g_y))
    B, S, C = a.shape
    d = (torch.zeros(B, C, dtype=dtype, device=a.device)
         if g_last is None else g_last.to(dtype))
    dh = torch.empty_like(g)
    for t in range(S - 1, -1, -1):
        d = (d if t == S - 1 else a[:, t + 1] * d) + g[:, t]
        dh[:, t] = d
    return _gradients(a, y, h0, dh)


def linear_scan_bwd_chunked(a, y, h0, g_y, g_last=None, chunk=32):
    """``linear_scan_bwd`` in float32 in the order of the backward kernel
    of ``csrc/rg_lru.cu``: ``linear_scan_chunked`` over the reversed
    sequence, coefficients a_{t+1} (1 at S - 1) from g_last, with the
    kernel's chunks of time (the ragged one last in time, padded with
    a = 1, g = 0, which hand g_last on unchanged)."""
    a, y, g = a.float(), y.float(), g_y.float()
    B, S, C = a.shape
    pad = -S % chunk
    coeff = torch.cat([a[:, 1:], a.new_ones(B, 1 + pad, C)], 1)
    cot = torch.cat([g, g.new_zeros(B, pad, C)], 1)
    dh, _ = linear_scan_chunked(coeff.flip(1), cot.flip(1), g_last, chunk)
    return _gradients(a, y, h0, dh.flip(1)[:, :S])
