"""Self-attention with GQA/MQA, a sliding window, the optional RMSNorm
of q and k (``qk_norm``) and Qwen2-VL's M-RoPE, whisper's bidirectional
and cross-attention, and DeepSeek-V2's Multi-head Latent Attention
(MLA): ``repro/models/attention.py`` (``:37-86``, ``:93-130``,
``:200-390``, ``:397-476``) in PyTorch.

Prefill (and the no-cache forward) always goes through the kernel
wrapper ``kernels.flash_attention.ops.flash_attention`` (the CUDA kernel
on the card, its plain version on the CPU); one decode step attends over
the cache with materialized scores (``attend_full``), as in the
reference. The kernel has no logit soft-cap, so a config that sets
``attn_logit_softcap`` is refused rather than served by another path.

KV caches are ``{"k", "v": (B, W, KH, hd), "pos": (B, W)}`` with
``pos = -1`` for an empty slot; W is the window for local layers and the
cache length otherwise. The port stores token i of a prefill at ring
index ``i mod W`` and a decode step's position p at ``p mod W``: the same
slot for text, whose positions count the tokens. (The reference's
prefill keeps the last W keys at indices 0..W-1, which disagrees with
its own decode, ``p mod W``, when a prompt longer than W is not a
multiple of W; ``ROADMAP.md`` records that fault.) Caches are written in
place and returned.

MLA keeps a compressed cache ``{"ckv": (B, T, kv_lora_rank), "krope":
(B, T, rope_dim), "pos": (B, T)}``, laid out as above. Its prefill (and
the no-cache forward) expands the latent into per-head keys ``(B, S, H,
nope + rope)`` and values ``(B, S, H, v_dim)`` and sends them through
the same kernel wrapper with a value head dim unlike the query's (192
and 128 at full width); a decode step takes the reference's absorbed
path (``W_uk`` folded into the query, the values read from the latent),
plain products outside any kernel.

Whisper's encoder attends without a mask (``attention_block(...,
causal=False)``), and its decoder's cross-attention takes every query
over the 1500 keys projected from the encoder output
(``encode_cross_kv``, ``cross_attention_block``): both through the same
kernel wrapper with ``causal=False`` at prefill, and a decode step's
cross-attention over the cached encoder k/v with materialized scores.
Learned positions (``rope_style="learned"``) are added at the embedding
and turn nothing here. The chunked path and the int8 KV cache come with
later slices.
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
    if cfg.rope_style == "mrope" and positions.dim() == 3:
        # (3, B, S) positions take M-RoPE; (B, S) fall back to RoPE
        q = nn.apply_mrope(q, positions, cfg.rope_theta)
        k = nn.apply_mrope(k, positions, cfg.rope_theta)
    elif cfg.rope_style in ("rope", "mrope"):
        q = nn.apply_rope(q, positions, cfg.rope_theta)
        k = nn.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope_style not in ("none", "learned"):
        # "learned": the positions were added at the embedding (whisper)
        raise ValueError(f"the port has no rope_style {cfg.rope_style!r}")
    return q, k, v


def _attn_scale(cfg: ModelConfig) -> float:
    if cfg.attention_multiplier > 0:
        return cfg.attention_multiplier
    return 1.0 / math.sqrt(cfg.head_dim)


def _fill_cache(cache, leaves, pos2d):
    """Prefill: the last min(S, W) tokens i of each ``leaves[name]``
    (B, S, ...) at ring index i mod W of ``cache[name]`` with their
    positions ``pos2d[:, i]``, every other slot empty. Text positions
    count the tokens (p = i), so this is the slot p mod W that a decode
    step writes; the M-RoPE positions of an image repeat its temporal
    index, and its tokens stay apart by index, as in the reference's
    prefill."""
    S, W = pos2d.shape[1], cache["pos"].shape[1]
    n = min(S, W)
    idx = (torch.arange(S - n, S, device=pos2d.device) % W).expand(
        pos2d.shape[0], n)  # (B, n)
    for name, src in leaves.items():
        dst = cache[name]
        dst.zero_()
        rows = idx.reshape(*idx.shape, *(1,) * (src.dim() - 2))
        dst.scatter_(1, rows.expand(-1, -1, *src.shape[2:]),
                     src[:, S - n:].to(dst.dtype))
    cache["pos"].fill_(-1)
    cache["pos"].scatter_(1, idx, pos2d[:, S - n:].to(torch.int32))


def attention_block(params, cfg: ModelConfig, x, positions, *, local: bool,
                    mode: str = "train", cache=None, causal: bool = True):
    """Returns (output, cache). positions: (B, S), or (3, B, S) for
    M-RoPE, absolute. The cache is written in place in "prefill" and
    "decode" mode. ``causal=False`` (whisper's encoder) masks nothing;
    it takes no cache."""
    if cfg.attn_logit_softcap > 0.0:
        raise ValueError("attn_logit_softcap: the flash-attention kernel "
                         "has no logit soft-cap yet (a later slice)")
    B, S, _ = x.shape
    pos2d = positions[0] if positions.dim() == 3 else positions
    q, k, v = _project_qkv(params, cfg, x, positions)
    window = cfg.local_window if local else 0
    scale = _attn_scale(cfg)
    if mode in ("train", "prefill"):
        # the kernel masks by index in the sequence, as the reference's
        # pallas route does (positions only turn the RoPE); its default
        # route masks by position values, which differs where M-RoPE
        # positions repeat (an image's tokens; ROADMAP.md section 3)
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     scale=scale)
        if mode == "prefill" and cache is not None:
            _fill_cache(cache, {"k": k, "v": v}, pos2d)
    elif mode == "decode":
        _write_slot(cache, {"k": k, "v": v}, pos2d)
        out = attend_full(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                          pos2d, cache["pos"], causal=True,
                          window=window, scale=scale)
    else:
        raise ValueError(mode)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return nn.linear(params["wo"], out), cache


def _write_slot(cache, leaves, pos2d):
    """Decode: the one new position p of each ``leaves[name]`` (B, 1, ...)
    at ring index p mod W of ``cache[name]``."""
    if cache is None or pos2d.shape[1] != 1:
        raise ValueError("decode takes one token and a cache")
    B, W = pos2d.shape[0], cache["pos"].shape[1]
    slot = torch.remainder(pos2d[:, 0], W).long()  # (B,)
    bidx = torch.arange(B, device=pos2d.device)
    for name, src in leaves.items():
        cache[name][bidx, slot] = src[:, 0].to(cache[name].dtype)
    cache["pos"][bidx, slot] = pos2d[:, 0].to(torch.int32)


def attention_block_bidirectional(params, cfg: ModelConfig, x, positions):
    """Encoder self-attention: no mask, no cache."""
    return attention_block(params, cfg, x, positions, local=False,
                           mode="train", cache=None, causal=False)


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------

def encode_cross_kv(params, cfg: ModelConfig, enc_out):
    """k/v (B, T, KH, hd) of the encoder output ``enc_out`` (B, T, d)."""
    B, T, _ = enc_out.shape
    KH, hd = cfg.n_kv_heads, cfg.head_dim
    k = nn.linear(params["wk"], enc_out).reshape(B, T, KH, hd)
    v = nn.linear(params["wv"], enc_out).reshape(B, T, KH, hd)
    return {"k": k, "v": v}


def cross_attention_block(params, cfg: ModelConfig, x, enc_kv, *,
                          mode: str = "train"):
    """Every query of x (B, S, d) over every key of ``enc_kv`` (k/v
    (B, T, KH, hd)): through the kernel wrapper without a mask in
    "train" and "prefill" mode (k/v freshly projected, contiguous), with
    materialized scores over the cross cache in "decode" mode."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = nn.linear(params["wq"], x).reshape(B, S, H, hd)
    k, v = enc_kv["k"].to(q.dtype), enc_kv["v"].to(q.dtype)
    scale = _attn_scale(cfg)
    if mode in ("train", "prefill"):
        out = fa_ops.flash_attention(q, k, v, causal=False, window=0,
                                     scale=scale)
    elif mode == "decode":
        T = k.shape[1]
        out = attend_full(q, k, v,
                          torch.arange(S, device=x.device).expand(B, S),
                          torch.arange(T, device=x.device).expand(B, T),
                          causal=False, window=0, scale=scale)
    else:
        raise ValueError(mode)
    return nn.linear(params["wo"], out.reshape(B, S, H * hd))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2) attention block
# ---------------------------------------------------------------------------

def mla_init(init: nn.Init, cfg: ModelConfig):
    """DeepSeek-V2 Multi-head Latent Attention parameters."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": nn.linear_init(init, d, H * qk_dim),
        # joint down-projection: compressed kv + decoupled rope key
        "w_dkv": nn.linear_init(init, d, m.kv_lora_rank + m.qk_rope_head_dim),
        "kv_norm": nn.norm_init(init, "rmsnorm", m.kv_lora_rank),
        "w_uk": nn.linear_init(init, m.kv_lora_rank, H * m.qk_nope_head_dim),
        "w_uv": nn.linear_init(init, m.kv_lora_rank, H * m.v_head_dim),
        "wo": nn.linear_init(init, H * m.v_head_dim, d),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, length: int,
                   dtype=torch.bfloat16, device="cpu"):
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, length, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, length, m.qk_rope_head_dim),
                             dtype=dtype, device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32,
                          device=device),
    }


def mla_block(params, cfg: ModelConfig, x, positions, *, mode="train",
              cache=None):
    """Returns (output, cache). positions: (B, S) or (3, B, S) (row 0 is
    used) absolute. The cache is written in place in "prefill" and
    "decode" mode."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope, rank = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    pos2d = positions[0] if positions.dim() == 3 else positions
    scale = 1.0 / math.sqrt(nope + rope)

    q = nn.linear(params["wq"], x).reshape(B, S, H, nope + rope)
    q_nope, q_rope = q.split([nope, rope], -1)
    q_rope = nn.apply_rope(q_rope, pos2d, cfg.rope_theta)
    ckv, k_rope = nn.linear(params["w_dkv"], x).split([rank, rope], -1)
    ckv = nn.apply_norm(params["kv_norm"], "rmsnorm", ckv)
    k_rope = nn.apply_rope(k_rope[:, :, None, :], pos2d,
                           cfg.rope_theta)[:, :, 0, :]

    if mode == "decode":
        _write_slot(cache, {"ckv": ckv, "krope": k_rope}, pos2d)
        ckv_all = cache["ckv"].to(x.dtype)
        krope_all = cache["krope"].to(x.dtype)
        # absorbed decode: score = q_nope W_uk^T ckv + q_rope k_rope, in
        # the reference's order of products and types
        wuk = params["w_uk"]["w"].to(x.dtype).reshape(rank, H, nope)
        q_abs = torch.einsum("bshd,rhd->bshr", q_nope, wuk)  # (B,1,H,rank)
        sc = torch.einsum("bshr,btr->bhst", q_abs, ckv_all) * scale
        sc = sc + torch.einsum("bshd,btd->bhst", q_rope, krope_all) * scale
        kpos = cache["pos"][:, None, None, :]
        mask = (kpos >= 0) & (pos2d[:, None, :, None] - kpos >= 0)
        probs = _softmax(sc, mask).to(x.dtype)
        ctx = torch.einsum("bhst,btr->bshr", probs, ckv_all)
        wuv = params["w_uv"]["w"].to(x.dtype).reshape(rank, H, m.v_head_dim)
        out = torch.einsum("bshr,rhv->bshv", ctx, wuv)
    elif mode in ("train", "prefill"):
        if mode == "prefill" and cache is not None:
            _fill_cache(cache, {"ckv": ckv, "krope": k_rope}, pos2d)
        k_nope = nn.linear(params["w_uk"], ckv).reshape(B, S, H, nope)
        v = nn.linear(params["w_uv"], ckv).reshape(B, S, H, m.v_head_dim)
        k_full = torch.cat(
            [k_nope, k_rope[:, :, None, :].expand(B, S, H, rope)], -1)
        q_full = torch.cat([q_nope, q_rope], -1)
        # q/k head dim nope + rope (192 at full width), v's v_head_dim (128)
        out = fa_ops.flash_attention(q_full, k_full, v, causal=True,
                                     window=0, scale=scale)
    else:
        raise ValueError(mode)
    out = out.reshape(B, S, H * m.v_head_dim)
    return nn.linear(params["wo"], out), cache
