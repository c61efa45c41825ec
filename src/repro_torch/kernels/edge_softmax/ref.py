"""Plain PyTorch version of the fused edge-softmax aggregation.

Mirrors ``repro/kernels/edge_softmax/ref.py``: Perona's benchmark-
execution graphs have a fixed in-degree (each node attends to its P=3
chronological predecessors), so messages are laid out densely as
``(N, P, F)`` with a validity mask. Single-head (q ``(N, F)``) and
multi-head (q ``(N, H, hd)``) layouts are supported; the mask is shared
across heads.

:func:`edge_softmax_backward` is the plain version of the backward:
the formula of the reference's custom VJP
(``repro/kernels/edge_softmax/ops.py::_bwd``), from the forward's saved
``att``, with no softmax recomputed.

The CPU tests use both, ``chip_smoke.py`` holds the CUDA kernels against
them on the card, and the kernel wrapper (``ops``) takes them for
tensors that lie on the CPU. Nothing on the main path calls them when a
card is present. Both compute in float32, or in float64 for float64
inputs (``torch.autograd.gradcheck``).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _compute_dtype(dtype):
    """float32, or float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _multi_head(q, k, v, mask, scale):
    """q: (N, H, hd); k/v: (N, P, H, hd); mask: (N, P) bool."""
    ct = _compute_dtype(q.dtype)
    s = torch.einsum("nhf,nphf->nhp", q.to(ct), k.to(ct)) * scale
    m3 = mask[:, None, :]
    s = torch.where(m3, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m) * m3
    denom = e.sum(dim=-1, keepdim=True)
    att = e / torch.clamp_min(denom, 1e-30)  # (N, H, P)
    out = torch.einsum("nhp,nphf->nhf", att, v.to(ct))
    return out.to(q.dtype), att


def edge_softmax_aggregate(q, k, v, mask, scale=None):
    """Single-head: q (N, F); k/v (N, P, F) -> (out (N, F), att (N, P)).
    Multi-head: q (N, H, hd); k/v (N, P, H, hd) -> (out (N, H, hd),
    att (N, H, P)). mask: (N, P) bool, shared across heads.

    out[i] = sum_p softmax_p(q_i . k_ip * scale) * v_ip  (masked),
    att[i] the attention weights (float32; float64 for float64
    inputs). Nodes with no valid
    neighbor get 0.
    """
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    mask = mask.bool()
    if q.dim() == 2:
        out, att = _multi_head(q[:, None, :], k[:, :, None, :],
                               v[:, :, None, :], mask, scale)
        return out[:, 0, :], att[:, 0, :]
    return _multi_head(q, k, v, mask, scale)


def edge_softmax_backward(q, k, v, att, g_out, g_att, scale):
    """(dq, dk, dv) of the multi-head layout from the forward's inputs,
    its ``att`` (N, H, P) and the cotangents ``g_out`` (N, H, hd) and
    ``g_att`` (N, H, P), which may be None (zero):

        da = g_out . v_p + g_att
        ds = att * (da - sum_p att * da)
        dq = scale * sum_p ds * k_p,  dk = scale * ds q,  dv = att g_out

    each cast to its input's type. ``att`` is 0 on masked slots, so
    ``ds``, ``dk`` and ``dv`` are too, and a fully masked node gets
    zero gradients.
    """
    ct = _compute_dtype(q.dtype)
    gf = g_out.to(ct)
    att = att.to(ct)
    da = torch.einsum("nhf,nphf->nhp", gf, v.to(ct))
    if g_att is not None:
        da = da + g_att.to(ct)
    ds = att * (da - (att * da).sum(-1, keepdim=True))
    dq = scale * torch.einsum("nhp,nphf->nhf", ds, k.to(ct))
    dk = scale * torch.einsum("nhp,nhf->nphf", ds, q.to(ct))
    dv = torch.einsum("nhp,nhf->nphf", att, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
