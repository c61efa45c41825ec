"""Self-attention with GQA/MQA, a sliding window and the optional
RMSNorm of q and k (``qk_norm``): ``repro/models/attention.py``
(``:37-65``, ``:93-130``, ``:200-357``) in PyTorch.

Prefill (and the no-cache forward) always goes through the kernel
wrapper ``kernels.flash_attention.ops.flash_attention`` (the CUDA kernel
on the card, its plain version on the CPU); one decode step attends over
the cache with materialized scores (``attend_full``), as in the
reference. The kernel has no logit soft-cap, so a config that sets
``attn_logit_softcap`` is refused rather than served by another path.

KV caches are ``{"k", "v": (B, W, KH, hd), "pos": (B, W)}`` with
``pos = -1`` for an empty slot; W is the window for local layers and the
cache length otherwise. The port stores position p at ring index
``p mod W`` both when it prefills and when it decodes. (The reference's
prefill keeps the last W keys at indices 0..W-1, which disagrees with
its own decode, ``p mod W``, when a prompt longer than W is not a
multiple of W; ``ROADMAP.md`` records that fault.) Caches are written in
place and returned. The chunked path, the int8 KV cache, MLA and
cross-attention come with later slices.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import nn
from repro_torch.models.config import ModelConfig

NEG_INF = -2.3819763e38  # large negative for masking in fp32


def attention_init(init: nn.Init, cfg: ModelConfig):
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    params = {}
    for name, d_out in (("wq", H * hd), ("wk", KH * hd), ("wv", KH * hd)):
        params[name] = nn.linear_init(init, d, d_out, bias=cfg.qkv_bias)
    params["wo"] = nn.linear_init(init, H * hd, d)
    if cfg.qk_norm:  # RMSNorm over hd of q and k, before RoPE
        for name in ("q_norm", "k_norm"):
            params[name] = nn.norm_init(init, "rmsnorm", hd)
    return params


# ---------------------------------------------------------------------------
# Core attend: q (B,S,H,hd) x k/v (B,T,KH,hd) with GQA + masking
# ---------------------------------------------------------------------------

def _gqa_scores(q, k, scale):
    B, S, H, hd = q.shape
    KH = k.shape[2]
    qg = q.reshape(B, S, KH, H // KH, hd)
    return torch.einsum("bskgd,btkd->bkgst", qg, k) * scale  # (B,KH,G,S,T)


def _gqa_values(probs, v):
    B, KH, G, S, T = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, KH * G, -1)


def _softmax(scores, mask):
    s = torch.where(mask, scores.float(), NEG_INF)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    return e / torch.clamp_min(e.sum(-1, keepdim=True), 1e-30)


def attend_full(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
                scale: float):
    """Materialized-scores attention. positions: (B,S)/(B,T) absolute;
    a negative key position marks an empty cache slot."""
    scores = _gqa_scores(q, k, scale)
    rel = q_pos[:, None, None, :, None] - k_pos[:, None, None, None, :]
    mask = k_pos[:, None, None, None, :] >= 0
    if causal:
        mask = mask & (rel >= 0)
    if window > 0:
        mask = mask & (rel < window)
    probs = _softmax(scores, mask)
    return _gqa_values(probs.to(v.dtype), v)


# ---------------------------------------------------------------------------
# Attention block (GQA; full or sliding-window; optional cache)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, length: int, local: bool,
                  dtype=torch.bfloat16, device="cpu"):
    if cfg.kv_quant:
        raise ValueError("the int8 KV cache comes with a later slice")
    W = min(cfg.local_window, length) if local else length
    KH, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, W, KH, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, W, KH, hd), dtype=dtype, device=device),
        # absolute position held by each slot; -1 = empty
        "pos": torch.full((batch, W), -1, dtype=torch.int32, device=device),
    }


def _project_qkv(params, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = nn.linear(params["wq"], x).reshape(B, S, H, hd)
    k = nn.linear(params["wk"], x).reshape(B, S, KH, hd)
    v = nn.linear(params["wv"], x).reshape(B, S, KH, hd)
    if cfg.qk_norm:
        q = nn.apply_norm(params["q_norm"], "rmsnorm", q)
        k = nn.apply_norm(params["k_norm"], "rmsnorm", k)
    if cfg.rope_style == "rope":
        q = nn.apply_rope(q, positions, cfg.rope_theta)
        k = nn.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope_style != "none":
        raise ValueError(f"rope_style {cfg.rope_style!r} comes with a "
                         f"later slice")
    return q, k, v


def _attn_scale(cfg: ModelConfig) -> float:
    if cfg.attention_multiplier > 0:
        return cfg.attention_multiplier
    return 1.0 / math.sqrt(cfg.head_dim)


def _fill_cache(cache, k, v, pos2d):
    """Prefill: the last min(S, W) positions p at ring index p mod W,
    every other slot empty."""
    S, W = k.shape[1], cache["k"].shape[1]
    n = min(S, W)
    idx = torch.remainder(pos2d[:, S - n:], W).long()  # (B, n)
    for name, src in (("k", k), ("v", v)):
        dst = cache[name]
        dst.zero_()
        rows = idx[:, :, None, None].expand(-1, -1, *src.shape[2:])
        dst.scatter_(1, rows, src[:, S - n:].to(dst.dtype))
    cache["pos"].fill_(-1)
    cache["pos"].scatter_(1, idx, pos2d[:, S - n:].to(torch.int32))


def attention_block(params, cfg: ModelConfig, x, positions, *, local: bool,
                    mode: str = "train", cache=None):
    """Returns (output, cache). positions: (B, S) absolute. The cache is
    written in place in "prefill" and "decode" mode."""
    if cfg.attn_logit_softcap > 0.0:
        raise ValueError("attn_logit_softcap: the flash-attention kernel "
                         "has no logit soft-cap yet (a later slice)")
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    window = cfg.local_window if local else 0
    scale = _attn_scale(cfg)
    if mode in ("train", "prefill"):
        # the kernel masks by index in the sequence, as the reference's
        # pallas route does (positions only turn the RoPE)
        out = fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                     scale=scale)
        if mode == "prefill" and cache is not None:
            _fill_cache(cache, k, v, positions)
    elif mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token and a cache")
        W = cache["k"].shape[1]
        slot = torch.remainder(positions[:, 0], W).long()  # (B,)
        bidx = torch.arange(B, device=x.device)
        cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][bidx, slot] = positions[:, 0].to(torch.int32)
        out = attend_full(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                          positions, cache["pos"], causal=True,
                          window=window, scale=scale)
    else:
        raise ValueError(mode)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return nn.linear(params["wo"], out), cache
