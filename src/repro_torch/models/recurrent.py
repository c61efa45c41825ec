"""Griffin recurrent block (conv1d + RG-LRU): ``repro/models/recurrent.py``
(``:29-190``) in PyTorch.

The full-sequence RG-LRU (train, prefill) goes through the kernel
wrapper ``kernels.rg_lru.ops.linear_scan`` (the CUDA kernel on the
card, its plain version on the CPU); one decode step is plain tensor
code, as in the reference. The gates are computed in the compute type,
the recurrence in float32.

Caches are written in place: ``griffin_block`` in "prefill" and
"decode" mode copies the new state into ``cache["conv"]`` (the last
``conv1d_width - 1`` pre-conv inputs, in the cache's type, bfloat16 by
default) and ``cache["h"]`` (float32), and returns the same dict. The
xLSTM blocks of the reference come with a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rg_lru import ops as lru_ops
from repro_torch.models import nn
from repro_torch.models.config import ModelConfig

_LRU_C = 8.0  # Griffin's fixed temperature on the recurrence gate


# ---------------------------------------------------------------------------
# Causal depthwise conv1d
# ---------------------------------------------------------------------------

def conv1d_init(init: nn.Init, width: int, channels: int):
    return {"w": init.param((width, channels), scale=nn.fanin_scale(width)),
            "b": init.param((channels,), mode="zeros")}


def conv1d_causal(params, x):
    """x: (B, S, C). y[t] = sum_k w[k] * x[t-k] + b."""
    w = params["w"].to(x.dtype)
    S = x.shape[1]
    out = x * w[0]
    for k in range(1, w.shape[0]):
        shifted = F.pad(x, (0, 0, k, 0))[:, :S]
        out = out + shifted * w[k]
    return out + params["b"].to(x.dtype)


def conv1d_decode(params, x_t, conv_cache):
    """x_t: (B, 1, C); conv_cache: (B, width-1, C), most recent last.
    Returns (y_t, the new history)."""
    w = params["w"].to(x_t.dtype)
    hist = torch.cat([conv_cache.to(x_t.dtype), x_t], dim=1)
    out = torch.einsum("btc,tc->bc", hist, w.flip(0))[:, None, :]
    return out + params["b"].to(x_t.dtype), hist[:, 1:]


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _block_diag_init(init: nn.Init, n_heads: int, dim: int):
    hd = dim // n_heads
    return {"w": init.param((n_heads, hd, hd), scale=nn.fanin_scale(hd)),
            "b": init.param((dim,), mode="zeros")}


def _block_diag_apply(params, x, n_heads: int):
    B, S, C = x.shape
    xh = x.reshape(B, S, n_heads, C // n_heads)
    y = torch.einsum("bshi,hij->bshj", xh, params["w"].to(x.dtype))
    return y.reshape(B, S, C) + params["b"].to(x.dtype)


def rg_lru_init(init: nn.Init, cfg: ModelConfig):
    lw = cfg.lru_width
    # Lambda parametrized so that a = exp(-c*softplus(L)) starts in
    # (0.9, 0.999) as in Griffin: U(0.2, 0.85); read in float32
    return {"lambda": init.param((lw,), mode="lru_lambda", f32=True),
            "gate_a": _block_diag_init(init, cfg.n_heads, lw),
            "gate_x": _block_diag_init(init, cfg.n_heads, lw)}


def _lru_log_a(params, gate_a):
    """log a_t in float32; gate_a: (B, S, C) pre-sigmoid."""
    softplus_l = F.softplus(params["lambda"].float())
    r = torch.sigmoid(gate_a.float())
    return -_LRU_C * softplus_l * r  # (B, S, C), <= 0


def _gated_input(params, cfg: ModelConfig, x):
    """(log a, b) of the recurrence h_t = a_t h_{t-1} + b_t, float32."""
    ga = _block_diag_apply(params["gate_a"], x, cfg.n_heads)
    gx = _block_diag_apply(params["gate_x"], x, cfg.n_heads)
    log_a = _lru_log_a(params, ga)
    gated_x = torch.sigmoid(gx.float()) * x.float()
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return log_a, beta * gated_x


def rg_lru_scan(params, cfg: ModelConfig, x, h0=None):
    """Full-sequence RG-LRU. x: (B, S, C) conv output. Returns (y in x's
    type, h_last float32)."""
    log_a, b = _gated_input(params, cfg, x)
    y, h_last = lru_ops.linear_scan(torch.exp(log_a), b, h0)
    return y.to(x.dtype), h_last


def rg_lru_step(params, cfg: ModelConfig, x_t, h):
    """One decode step. x_t: (B, 1, C); h: (B, C) float32."""
    log_a, b = _gated_input(params, cfg, x_t)
    h_new = torch.exp(log_a[:, 0]) * h + b[:, 0]
    return h_new.to(x_t.dtype)[:, None, :], h_new


# ---------------------------------------------------------------------------
# Griffin block
# ---------------------------------------------------------------------------

def griffin_block_init(init: nn.Init, cfg: ModelConfig):
    """Recurrent block: two branches, conv1d + RG-LRU on one."""
    d, lw = cfg.d_model, cfg.lru_width
    return {"wx": nn.linear_init(init, d, lw),
            "wy": nn.linear_init(init, d, lw),
            "conv": conv1d_init(init, cfg.conv1d_width, lw),
            "lru": rg_lru_init(init, cfg),
            "wo": nn.linear_init(init, lw, d)}


def griffin_block(params, cfg: ModelConfig, x, *, mode: str = "train",
                  cache=None):
    """x: (B, S, D) normed input; cache: {"conv", "h"}, updated in place
    in "prefill" and "decode" mode. Returns (out, cache)."""
    gate = nn.gelu(nn.linear(params["wx"], x))
    y = nn.linear(params["wy"], x)
    if mode == "decode":
        y, hist = conv1d_decode(params["conv"], y, cache["conv"])
        y, h = rg_lru_step(params["lru"], cfg, y, cache["h"])
        cache["conv"].copy_(hist)
        cache["h"].copy_(h)
    else:
        pre_conv = y
        y = conv1d_causal(params["conv"], y)
        y, h_last = rg_lru_scan(params["lru"], cfg, y)
        if mode == "prefill" and cache is not None:
            # conv history = the last (width - 1) pre-conv inputs, with
            # zeros before the first token of a short prompt
            width = cfg.conv1d_width - 1
            tail = pre_conv[:, -width:]
            tail = F.pad(tail, (0, 0, width - tail.shape[1], 0))
            cache["conv"].copy_(tail)
            cache["h"].copy_(h_last)
    return nn.linear(params["wo"], y * gate), cache


def init_griffin_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                       device="cpu"):
    return {
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, cfg.lru_width),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
    }
