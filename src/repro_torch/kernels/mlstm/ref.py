"""Plain PyTorch version of the stabilized chunkwise mLSTM.

Mirrors ``repro/kernels/mlstm/ref.py`` in the kernel's layout: q/k/v
``(BH, S, hd)``, gates ``(BH, S)`` float32, state ``(C (BH, hd, hd),
n (BH, hd), m (BH,))`` float32. It differs in one point, the schedule:
chunks of ``L = min(chunk, S)`` rows with a short last chunk when
``S % L != 0`` (the reference takes one chunk of S rows there, and its
Pallas kernel refuses such S). The CUDA kernel takes the same schedule.
The chunking changes the carried stabilizer m, and with it the scale of
C and n, but not h or ``C * exp(m)``.

The CPU tests use it, ``chip_smoke.py`` holds the CUDA kernel against
it on the card, and the kernel wrapper (``ops``) takes it for tensors
that lie on the CPU. Under float64 inputs (the CPU tests' float64
evaluation of the small xLSTM) it computes and keeps its state in
float64.
"""

from __future__ import annotations

import torch

M_INIT = -1e30  # the fresh state's stabilizer: finite, so no -inf - -inf


def init_state(bh: int, hd: int, device="cpu", dtype=torch.float32):
    return (torch.zeros(bh, hd, hd, dtype=dtype, device=device),
            torch.zeros(bh, hd, dtype=dtype, device=device),
            torch.full((bh,), M_INIT, dtype=dtype, device=device))


def _chunk(q, k, v, li, lf, C, n, m):
    """One chunk of Lc rows: q/k/v (BH, Lc, hd) float32, gates (BH, Lc).
    Returns (h float32, (C, n, m) after the chunk)."""
    Lc = q.shape[1]
    # cumulative log-forget, summed in float64 and rounded to float32: a
    # float32 cumsum's rounding depends on its order (sequential here, a
    # tree in XLA, a scan on the card) and exp amplifies it; this gives
    # the kernel's bits on any device
    b = torch.cumsum(lf.double(), dim=1).to(lf.dtype)  # (BH, Lc)
    total_f = b[:, -1]  # b at the last real row
    # intra-chunk decay D[i, j] = b_i - b_j + li_j for j <= i
    dmat = b[:, :, None] - b[:, None, :] + li[:, None, :]
    causal = torch.ones(Lc, Lc, dtype=torch.bool, device=q.device).tril()
    dmat = dmat.masked_fill(~causal, float("-inf"))
    inter_log = b + m[:, None]  # decay of the carried state for row i
    m_new = torch.maximum(inter_log, dmat.amax(dim=2))  # finite: D[i, i]
    dmat_s = torch.exp(dmat - m_new[:, :, None])  # 0 above the diagonal
    inter_s = torch.exp(inter_log - m_new)
    scores = q @ k.transpose(1, 2)
    weighted = scores * dmat_s
    num = weighted @ v + (q @ C) * inter_s[:, :, None]
    den = weighted.sum(2) + (q @ n[:, :, None])[:, :, 0] * inter_s
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[:, :, None]

    m_next = torch.maximum(total_f + m, (b + li).amax(dim=1))
    kdecay = torch.exp(total_f[:, None] - b + li - m_next[:, None])
    decay = torch.exp(total_f + m - m_next)
    kd = k * kdecay[:, :, None]
    C = decay[:, None, None] * C + kd.transpose(1, 2) @ v
    n = decay[:, None] * n + kd.sum(1)
    return h, (C, n, m_next)


def mlstm_chunkwise(q, k, v, log_i, log_f, chunk: int = 64, state=None):
    """q/k/v (BH, S, hd); log_i/log_f (BH, S). Returns (h (BH, S, hd) in
    q's type, (C, n, m) float32)."""
    BH, S, hd = q.shape
    L = min(chunk, S)
    f = torch.float64 if q.dtype == torch.float64 else torch.float32
    C, n, m = (init_state(BH, hd, q.device, f) if state is None
               else tuple(t.to(f) for t in state))
    h = torch.empty(BH, S, hd, dtype=q.dtype, device=q.device)
    li, lf = log_i.to(f), log_f.to(f)
    for s0 in range(0, S, L):
        rows = slice(s0, min(s0 + L, S))
        hc, (C, n, m) = _chunk(q[:, rows].to(f), k[:, rows].to(f),
                               v[:, rows].to(f), li[:, rows], lf[:, rows],
                               C, n, m)
        h[:, rows] = hc.to(q.dtype)
    return h, (C, n, m)
