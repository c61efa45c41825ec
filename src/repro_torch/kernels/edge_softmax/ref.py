"""Plain PyTorch version of the fused edge-softmax aggregation.

Mirrors ``repro/kernels/edge_softmax/ref.py``: Perona's benchmark-
execution graphs have a fixed in-degree (each node attends to its P=3
chronological predecessors), so messages are laid out densely as
``(N, P, F)`` with a validity mask. Single-head (q ``(N, F)``) and
multi-head (q ``(N, H, hd)``) layouts are supported; the mask is shared
across heads.

The CPU tests use it, ``chip_smoke.py`` holds the CUDA kernel against
it on the card, and the kernel wrapper (``ops``) takes it for tensors
that lie on the CPU. Nothing on the main path calls it when a card is
present.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _multi_head(q, k, v, mask, scale):
    """q: (N, H, hd); k/v: (N, P, H, hd); mask: (N, P) bool."""
    s = torch.einsum("nhf,nphf->nhp", q.float(), k.float()) * scale
    m3 = mask[:, None, :]
    s = torch.where(m3, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m) * m3
    denom = e.sum(dim=-1, keepdim=True)
    att = e / torch.clamp_min(denom, 1e-30)  # (N, H, P)
    out = torch.einsum("nhp,nphf->nhf", att, v.float())
    return out.to(q.dtype), att


def edge_softmax_aggregate(q, k, v, mask, scale=None):
    """Single-head: q (N, F); k/v (N, P, F) -> (out (N, F), att (N, P)).
    Multi-head: q (N, H, hd); k/v (N, P, H, hd) -> (out (N, H, hd),
    att (N, H, P)). mask: (N, P) bool, shared across heads.

    out[i] = sum_p softmax_p(q_i . k_ip * scale) * v_ip  (masked),
    att[i] the attention weights (float32). Nodes with no valid
    neighbor get 0.
    """
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    mask = mask.bool()
    if q.dim() == 2:
        out, att = _multi_head(q[:, None, :], k[:, :, None, :],
                               v[:, :, None, :], mask, scale)
        return out[:, 0, :], att[:, 0, :]
    return _multi_head(q, k, v, mask, scale)
