"""Plain PyTorch version of causal / sliding-window GQA attention.

Mirrors ``repro/kernels/flash_attention/ref.py``: materialized float32
scores, masked to -1e30, softmax with the sum clamped to 1e-30, output
in q's type. Layout q (B, H, S, D), k (B, KH, T, D) and v (B, KH, T, DV)
with H % KH == 0; query i and key j sit at positions i and j. The output
takes v's head dim (DeepSeek-V2's latent attention has D = 192 and
DV = 128; the reference's oracle reshapes it to D and cannot run that).

The CPU tests use it, ``chip_smoke.py`` holds the CUDA kernel against
it on the card, and the kernel wrapper (``ops``) takes it for tensors
that lie on the CPU.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None):
    """q: (B, H, S, D); k: (B, KH, T, D); v: (B, KH, T, DV). Returns
    (B, H, S, DV); the default scale is 1/sqrt(D)."""
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    group = H // KH
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qf = q.float().reshape(B, KH, group, S, D)
    s = torch.einsum("bkgsd,bktd->bkgst", qf, k.float()) * scale
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones(S, T, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return o.reshape(B, H, S, v.shape[-1]).to(q.dtype)
