"""Mixture-of-Experts feed-forward: ``repro/models/moe.py`` in PyTorch.

The router runs in float32: a softmax over the experts, the top k
choices of each token (ties as ``jax.lax.top_k`` breaks them: the lower
expert index first), their weights renormalised to sum to 1, and the
Switch-style load-balancing loss.

Two dispatch implementations, as in the reference (``MoEConfig.impl``):

- ``"scatter"`` (the default): every batch row is a group with capacity
  C = ``_capacity(moe, S)`` slots per expert. A choice takes the next
  free slot of its expert in token-major order (a cumsum over the S·K
  choices), and a choice past C is dropped. The reference adds the
  tokens into an ``(E, C + 1, D)`` buffer with the dropped ones in row C
  and throws row C away; here each kept (expert, slot) pair holds
  exactly one token, so a plain index write is the same, and whatever
  the dropped rows leave in row C is thrown away as there.
- ``"einsum"``: groups of ``min(group_size, S)`` tokens, dispatched and
  combined through one-hot tensors (GShard).

The expert products are batched matrix products over the expert axis.
:func:`record_keep` collects which choices found a slot, for checks
that must know where a forward dropped a token.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import nn
from repro_torch.models.config import ModelConfig, MoEConfig

_RECORD: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def record_keep() -> Iterator[List[torch.Tensor]]:
    """Inside the block, every MoE layer call appends its keep mask
    ``(B, S, K)`` (True where a routing choice found a capacity slot) to
    the list this yields, in call order."""
    global _RECORD
    saved, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = saved


def _capacity(moe: MoEConfig, tokens_per_group: int) -> int:
    c = int(moe.capacity_factor * tokens_per_group * moe.top_k / moe.n_experts)
    return max(8, (c + 7) // 8 * 8)


def moe_init(init: nn.Init, cfg: ModelConfig):
    moe, d = cfg.moe, cfg.d_model
    E, f = moe.n_experts, moe.expert_d_ff
    params = {
        # read in float32 by the router
        "router": {"w": init.param((d, E), scale=nn.fanin_scale(d),
                                   f32=True)},
        # gated MLPs stacked on a leading expert axis
        "experts": {"wi": init.param((E, d, 2, f), scale=nn.fanin_scale(d)),
                    "wo": init.param((E, f, d), scale=nn.fanin_scale(f))},
    }
    if moe.n_shared_experts:
        shared_ff = moe.shared_d_ff or moe.n_shared_experts * f
        params["shared"] = nn.mlp_init(init, "swiglu", d, shared_ff)
    return params


def _topk(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest values along the last axis, in
    ``jax.lax.top_k``'s order: larger first, the lower index first among
    equal values (a stable descending sort keeps equal values in index
    order on every device)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]


def router_topk(params, moe: MoEConfig, x
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (weights (B,S,K), expert_ids (B,S,K), aux_loss scalar)."""
    rt = nn.state_dtype(x.dtype)
    logits = x.to(rt) @ params["router"]["w"].to(rt)
    probs = torch.softmax(logits, -1)
    ids = _topk(probs, moe.top_k)
    weights = probs.gather(-1, ids)
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    # load-balancing auxiliary loss (Switch-style)
    E = moe.n_experts
    density = F.one_hot(ids, E).to(rt).sum(-2).mean((0, 1))
    density_proxy = probs.mean((0, 1))
    aux = (density * density_proxy).sum() * E * moe.router_aux_weight
    return weights, ids, aux


def dispatch_slots(ids: torch.Tensor, n_experts: int, capacity: int):
    """Capacity slots of a group's choices, token-major. ids (G, N, K)
    -> (slot (G, N, K) in [0, N·K), keep (G, N, K)): a choice's slot is
    the number of earlier choices of the same expert in the group, and
    it is kept if that is below ``capacity``."""
    G, N, K = ids.shape
    onehot = F.one_hot(ids.reshape(G, N * K), n_experts)  # (G, NK, E)
    slot = ((onehot.cumsum(1) - 1) * onehot).sum(-1).reshape(G, N, K)
    return slot, slot < capacity


def _record(keep):
    if _RECORD is not None:
        _RECORD.append(keep)


def _experts(params, buf):
    """The experts' gated MLPs on their buffers: buf (..., E, C, D) ->
    (..., E, C, D)."""
    wi = params["wi"].to(buf.dtype)
    wo = params["wo"].to(buf.dtype)
    E, D, _, f = wi.shape
    lead, C = buf.shape[:-3], buf.shape[-2]
    xe = buf.movedim(-3, 0).reshape(E, -1, D)
    # (d, 2, f) as (d, 2 f): columns [0, f) gate, [f, 2 f) up
    h = torch.bmm(xe, wi.reshape(E, D, 2 * f))
    act = F.silu(h[..., :f]) * h[..., f:]
    return torch.bmm(act, wo).reshape(E, *lead, C, D).movedim(0, -3)


def moe_apply(params, cfg: ModelConfig, x):
    """x: (B, S, D) -> (out (B,S,D), aux_loss)."""
    if cfg.moe.impl == "einsum":
        out, aux = moe_apply_einsum(params, cfg, x)
    else:
        out, aux = moe_apply_scatter(params, cfg, x)
    if cfg.moe.n_shared_experts:
        out = out + nn.apply_mlp(params["shared"], "swiglu", x)
    return out, aux


def moe_apply_einsum(params, cfg: ModelConfig, x):
    """GShard-style one-hot dispatch in groups of ``group_size`` tokens
    (``repro/models/moe.py:83-133``), without the shared experts."""
    moe = cfg.moe
    B, S, D = x.shape
    E, K = moe.n_experts, moe.top_k
    g = min(moe.group_size, S)
    if (B * S) % g:
        raise ValueError(f"B*S = {B * S} is not a multiple of the group "
                         f"size {g}")
    G = B * S // g
    C = _capacity(moe, g)

    weights, ids, aux = router_topk(params, moe, x)
    slot, keep = dispatch_slots(ids.reshape(G, g, K), E, C)
    _record(keep.reshape(B, S, K))
    rt = nn.state_dtype(x.dtype)
    onehot_e = F.one_hot(ids.reshape(G, g, K), E)  # (G, g, K, E)
    onehot_c = (F.one_hot(slot.clamp(0, C - 1), C).to(x.dtype)
                * keep[..., None])  # (G, g, K, C)
    dispatch = torch.einsum("gske,gskc->gsec", onehot_e.to(x.dtype),
                            onehot_c)
    combine = torch.einsum("gske,gskc,gsk->gsec", onehot_e.to(rt),
                           onehot_c.to(rt),
                           weights.reshape(G, g, K).to(rt)).to(x.dtype)
    buf = torch.einsum("gsd,gsec->gecd", x.reshape(G, g, D), dispatch)
    eout = _experts(params["experts"], buf)
    out = torch.einsum("gecd,gsec->gsd", eout, combine)
    return out.reshape(B, S, D), aux


def moe_apply_scatter(params, cfg: ModelConfig, x):
    """Scatter/gather routing, one group a batch row
    (``repro/models/moe.py:136-188``), without the shared experts."""
    moe = cfg.moe
    B, S, D = x.shape
    E, K = moe.n_experts, moe.top_k
    C = _capacity(moe, S)

    weights, ids, aux = router_topk(params, moe, x)
    slot, keep = dispatch_slots(ids, E, C)  # (B, S, K)
    _record(keep)
    expert = ids.reshape(B, S * K)
    row = torch.where(keep, slot, C).reshape(B, S * K)  # C: dropped
    b = torch.arange(B, device=x.device)[:, None].expand(B, S * K)

    # dispatch: each kept (expert, slot) holds one token; row C is thrown
    # away
    buf = x.new_zeros(B, E, C + 1, D)
    buf[b, expert, row] = x.repeat_interleave(K, dim=1)
    eout = _experts(params["experts"], buf[:, :, :C])  # (B, E, C, D)

    # combine: gather back (row C reads zeros) + weighted sum over choices
    picked = F.pad(eout, (0, 0, 0, 1))[b, expert, row].reshape(B, S, K, D)
    w = (weights * keep).to(x.dtype)
    return torch.einsum("bskd,bsk->bsd", picked, w), aux
