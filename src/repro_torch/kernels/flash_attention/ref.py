"""Plain PyTorch version of causal / sliding-window GQA attention.

Mirrors ``repro/kernels/flash_attention/ref.py``: materialized float32
scores (float64 for float64 inputs, the card's rounding-free control),
masked to -1e30, softmax with the sum clamped to 1e-30, output in q's
type. Layout q (B, H, S, D), k (B, KH, T, D) and v (B, KH, T, DV)
with H % KH == 0; query i and key j sit at positions i and j. The output
takes v's head dim (DeepSeek-V2's latent attention has D = 192 and
DV = 128; the reference's oracle reshapes it to D and cannot run that).

The CPU tests use it, ``chip_smoke.py`` holds the CUDA kernel against
it on the card, and the kernel wrapper (``ops``) takes it for tensors
that lie on the CPU. :func:`attention_lse` is the log-sum-exp that the
forward kernels keep for the backward, and :func:`attention_bwd` the
backward kernels' formulas written out (the gradient from L and the
output, as ``csrc/flash_attention_bwd.cu`` computes it).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None):
    """q: (B, H, S, D); k: (B, KH, T, D); v: (B, KH, T, DV). Returns
    (B, H, S, DV); the default scale is 1/sqrt(D)."""
    B, H, S, _ = q.shape
    s, live, _ = _scores(q, k, causal, window, scale)
    s = torch.where(live, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.to(p.dtype))
    return o.reshape(B, H, S, v.shape[-1]).to(q.dtype)


def _live(S, T, causal, window, device):
    """(S, T) bool: the pairs the mask keeps."""
    q_pos = torch.arange(S, device=device)[:, None]
    k_pos = torch.arange(T, device=device)[None, :]
    mask = torch.ones(S, T, dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    return mask


def _scores(q, k, causal, window, scale):
    """float32 (float64 for float64 inputs) scores (B, KH, group, S, T)
    and the live pairs (S, T)."""
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bkgsd,bktd->bkgst",
                     q.to(acc).reshape(B, KH, H // KH, S, D),
                     k.to(acc)) * scale
    return s, _live(S, T, causal, window, q.device), scale


def attention_lse(q, k, *, causal: bool = True, window: int = 0,
                  scale: float | None = None):
    """q: (B, H, S, D); k: (B, KH, T, D). Returns float32 (B, H, S): the
    log-sum-exp of each row's scaled scores over its live keys,
    L = m + log(max(l, 1e-30)) with m the row's largest masked score
    (-1e30 when no key is live) and l the sum of exp(s - m) over the live
    keys, so that P = exp(s - L) is the forward's softmax. A row with no
    live key gets about -1e30."""
    B, H, S, _ = q.shape
    s, live, _ = _scores(q, k, causal, window, scale)
    s = torch.where(live, s, NEG_INF)
    m = s.amax(-1)
    l = torch.where(live, torch.exp(s - m[..., None]), 0.0).sum(-1)
    return (m + torch.log(torch.clamp_min(l, 1e-30))).reshape(B, H, S)


def attention_bwd(q, k, v, lse, dout, *, causal: bool = True,
                  window: int = 0, scale: float | None = None):
    """The gradient of :func:`attention` as the float32 backward kernels
    compute it, in float32 (float64 for float64 inputs, the
    rounding-free control): q (B, H, S, D), k (B, KH, T, D), v (B, KH, T,
    DV), the output's cotangent ``dout`` (B, H, S, DV), the log-sum-exp
    ``lse`` (B, H, S) of :func:`attention_lse`. P = exp(s - L) at live
    pairs and 0 at dead ones (a row with no live key gets no gradient),
    dP = dout v^T, delta = rowsum(P dP) / rowsum(P) (rowsum(dout * out)
    in exact arithmetic), dS = P (dP - delta), dq = scale dS k, and dk =
    scale dS^T q and dv = P^T dout summed over each kv head's group.
    Every row of dS sums to 0; the rounding of each row's sum eta_i goes
    to one live key of the row, j_i = i mod T (min(i, T - 1) with a
    window): dq_i = scale (sum_j dS_ij k_j - eta_i k_{j_i}) and dk from
    dS with dS_{i j_i} - eta_i, the same functions, which keep their
    digits where a row's keys and values nearly agree, as autograd's
    softmax backward does (the bf16 kernels take delta from the output
    and dS as it is). Returns (dq, dk, dv) in the inputs' type."""
    B, H, S, D = q.shape
    KH = k.shape[1]
    s, live, scale = _scores(q, k, causal, window, scale)
    acc = s.dtype
    rows = (B, KH, H // KH, S)
    do = dout.to(acc).reshape(*rows, -1)
    p = torch.where(live, torch.exp(s - lse.to(acc).reshape(*rows, 1)), 0.0)
    dp = torch.einsum("bkgsd,bktd->bkgst", do, v.to(acc))
    total = p.sum(-1, keepdim=True)
    delta = torch.where(total > 0, (p * dp).sum(-1, keepdim=True)
                        / total.clamp_min(1e-30), 0.0)
    ds = p * (dp - delta)
    # each row's rounded sum of dS to its key j_i
    i = torch.arange(S, device=ds.device)
    T = k.shape[2]
    dump = i.clamp(max=T - 1) if window > 0 else i % T
    eta = ds.sum(-1)
    kc = k.to(acc)
    dq = (torch.einsum("bkgst,bktd->bkgsd", ds, kc)
          - eta[..., None] * kc[:, :, None, dump]) * scale
    ds = ds.clone()
    ds[..., i, dump] -= eta
    dk = torch.einsum("bkgst,bkgsd->bktd", ds,
                      q.to(acc).reshape(*rows, D)) * scale
    dv = torch.einsum("bkgst,bkgsd->bktd", p, do)
    return (dq.reshape(B, H, S, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
