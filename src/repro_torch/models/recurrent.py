"""Recurrent layer kinds, ``repro/models/recurrent.py`` in PyTorch: the
Griffin block (conv1d + RG-LRU, ``:29-190``) and the xLSTM blocks (mLSTM
``:192-358`` and sLSTM ``:365-465``).

The full-sequence RG-LRU (train, prefill) goes through the kernel
wrapper ``kernels.rg_lru.ops.linear_scan`` and the full-sequence mLSTM
through ``kernels.mlstm.ops.mlstm_chunkwise`` (the CUDA kernels on the
card, their plain versions on the CPU); one decode step of either is
plain tensor code, as in the reference. On the card the RG-LRU's
gradient is the scan's backward kernel and the mLSTM's the mLSTM's
backward kernel, so Griffin and xLSTM models train there. The sLSTM has
no TPU kernel in the reference (a ``lax.scan`` of jnp ops): here it is a
Python loop over time, its steps stacked once at the end (under autograd
a write per step into one tensor would clone that tensor's whole
gradient at every step of the backward). Under autograd in "train" mode
the loop is :class:`_SLSTMScan`, whose backward is written out:
autograd through the loop keeps a node for every op of every step and
adds into w_rec's gradient at every step. Gates are computed in the
compute type, recurrences and states in float32 (float64 under a float64
compute type, the tests' float64 evaluation).

Caches are written in place: the blocks in "prefill" and "decode" mode
copy the new state into the cache dict they are given and return it.
A conv history holds the last ``conv1d_width - 1`` pre-conv inputs in
the cache's type (bfloat16 by default), with zeros before the first
token of a short prompt; every recurrent state is float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm import ops as mlstm_ops
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


def _conv_history(cfg: ModelConfig, pre_conv):
    """The conv history after a prefill: the last (width - 1) pre-conv
    inputs, with zeros before the first token of a short prompt."""
    width = cfg.conv1d_width - 1
    tail = pre_conv[:, -width:]
    return F.pad(tail, (0, 0, width - tail.shape[1], 0))


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
            cache["conv"].copy_(_conv_history(cfg, pre_conv))
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


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block)
# ---------------------------------------------------------------------------

def mlstm_block_init(init: nn.Init, cfg: ModelConfig):
    d = cfg.d_model
    di = 2 * d  # proj_factor 2
    H = cfg.n_heads
    return {"up": nn.linear_init(init, d, 2 * di),
            "conv": conv1d_init(init, cfg.conv1d_width, di),
            "wq": _block_diag_init(init, H, di),
            "wk": _block_diag_init(init, H, di),
            "wv": _block_diag_init(init, H, di),
            "wi": nn.linear_init(init, di, H),
            "wf": nn.linear_init(init, di, H),
            "hnorm": nn.norm_init(init, "rmsnorm", di),  # over all 2 d
            "down": nn.linear_init(init, di, d)}


def mlstm_step(q, k, v, log_i, log_f, state):
    """One decode step. q, k, v: (B, 1, H, hd); gates (B, 1, H) float32;
    state (C (B, H, hd, hd), n (B, H, hd), m (B, H)) float32. Returns
    (h (B, 1, H, hd) in q's type, the new state)."""
    C, n, m = state
    q32, k32, v32 = (x.float()[:, 0] for x in (q, k, v))
    li, lf = log_i[:, 0], log_f[:, 0]  # (B, H)
    m_new = torch.maximum(lf + m, li)
    fgate = torch.exp(lf + m - m_new)[..., None]
    igate = torch.exp(li - m_new)[..., None]
    C_new = (fgate[..., None] * C
             + igate[..., None] * (k32[..., :, None] * v32[..., None, :]))
    n_new = fgate * n + igate * k32
    num = (q32[..., None, :] @ C_new)[..., 0, :]
    den = (q32 * n_new).sum(-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h[:, None].to(q.dtype), (C_new, n_new, m_new)


def mlstm_block(params, cfg: ModelConfig, x, *, mode: str = "train",
                cache=None):
    """x: (B, S, D) normed input; cache: {"conv", "state": (C, n, m)},
    updated in place in "prefill" and "decode" mode. Returns (out,
    cache). In "train" mode the state is dropped, so a gradient reaches
    the mLSTM through h alone, as the wrapper's backward asks."""
    B, S, d = x.shape
    di = 2 * d
    H = cfg.n_heads
    hd = di // H
    up = nn.linear(params["up"], x)
    x1, x2 = up[..., :di], up[..., di:]
    if mode == "decode":
        c, hist = conv1d_decode(params["conv"], x1, cache["conv"])
    else:
        c = conv1d_causal(params["conv"], x1)
    c = F.silu(c)
    q = _block_diag_apply(params["wq"], c, H).reshape(B, S, H, hd)
    k = (_block_diag_apply(params["wk"], c, H).reshape(B, S, H, hd)
         / math.sqrt(hd))  # in the compute type, as the reference
    v = _block_diag_apply(params["wv"], x1, H).reshape(B, S, H, hd)
    sd = nn.state_dtype(x.dtype)
    log_i = nn.linear(params["wi"], c).to(sd)  # (B, S, H)
    log_f = F.logsigmoid(nn.linear(params["wf"], c).to(sd))

    if mode == "decode":
        h, state = mlstm_step(q, k, v, log_i, log_f, cache["state"])
    else:
        h, state = mlstm_ops.mlstm_chunkwise(q, k, v, log_i, log_f,
                                             chunk=256)
    if mode in ("prefill", "decode") and cache is not None:
        cache["conv"].copy_(hist if mode == "decode"
                            else _conv_history(cfg, x1))
        for dst, src in zip(cache["state"], state):
            dst.copy_(src)
    h = nn.apply_norm(params["hnorm"], "rmsnorm", h.reshape(B, S, di))
    return nn.linear(params["down"], h * F.silu(x2)), cache


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device="cpu"):
    di = 2 * cfg.d_model
    H = cfg.n_heads
    hd = di // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, di), dtype=dtype,
                            device=device),
        "state": (torch.zeros((batch, H, hd, hd), **f32),
                  torch.zeros((batch, H, hd), **f32),
                  torch.full((batch, H), -1e30, **f32)),
    }


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory block)
# ---------------------------------------------------------------------------

SLSTM_GATES = ("z", "i", "f", "o")


def slstm_block_init(init: nn.Init, cfg: ModelConfig):
    d = cfg.d_model
    H = cfg.n_heads
    params = {"conv": conv1d_init(init, cfg.conv1d_width, d)}
    for g in SLSTM_GATES:
        params[f"w{g}"] = nn.linear_init(init, d, d)
    for g in SLSTM_GATES:
        params[f"r{g}"] = _block_diag_init(init, H, d)
    params["hnorm"] = nn.norm_init(init, "rmsnorm", d)
    params["ffn"] = nn.mlp_init(init, "geglu", d, (4 * d) // 3)
    return params


def _slstm_recurrent(params, dtype):
    """The four block-diagonal recurrent weights as one (H, hd, 4 hd)
    matrix of the state's type ``dtype``, gate g in columns
    [g hd, (g + 1) hd), and their biases (4, d): cast once per call, as
    ``_block_diag_apply`` casts them to the float32 state's type."""
    w = torch.cat([params[f"r{g}"]["w"].to(dtype) for g in SLSTM_GATES], -1)
    b = torch.stack([params[f"r{g}"]["b"].to(dtype) for g in SLSTM_GATES])
    return w, b


def _slstm_step(w_rec, pre, state):
    """One step for every sequence. w_rec (H, hd, 4 hd); pre (H, B, 4 hd)
    the input-side pre-activations plus the recurrent biases; state
    (c, n, h, m), each (H, B, hd) float32. Returns the new state and what
    :class:`_SLSTMScan`'s backward reads: the stabilised gates i_s and
    f_s, tanh(z), sigmoid(o) and the forget pre-activation f."""
    c, n, h, m = state
    hd = c.shape[-1]
    r = torch.baddbmm(pre, h, w_rec)  # (H, B, 4 hd)
    z, log_i, f, o = r.split(hd, dim=-1)
    log_f_m = F.logsigmoid(f) + m
    m_new = torch.maximum(log_f_m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f_m - m_new)
    tz = torch.tanh(z)
    c_new = f_s * c + i_s * tz
    n_new = f_s * n + i_s
    so = torch.sigmoid(o)
    h_new = so * c_new / torch.clamp_min(n_new, 1e-6)
    return (c_new, n_new, h_new, m_new), (i_s, f_s, tz, so, f)


def _slstm_cell(w_rec, pre, state):
    """One step for every sequence (:func:`_slstm_step`'s new state)."""
    return _slstm_step(w_rec, pre, state)[0]


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM's recurrence over S steps from a fresh state, under
    autograd: the loop of :func:`_slstm_step` with no graph (so no
    autograd node, saved-tensor hook or gradient accumulation a step), and
    its backward written out, a loop from the last step. Takes w_rec
    (H, hd, 4 hd) and pre (S, H, B, 4 hd); returns h of every step
    (S, H, B, hd) and the last (c, n, m), whose cotangents it refuses.

    As in the mLSTM, h = sigmoid(o) c / n does not depend on the
    stabilizer m (c and n carry the same exp(-m)), so every m is a
    constant of the gradient; n >= 1 at every step (one of f_s, i_s is 1
    and n starts at 1), so the clamp of n never acts. With dh the
    cotangent of a step's h (its own plus dr_{t+1} w_rec^T), dc and dn
    those of its c and n (their own terms plus the carry f_s dc', f_s dn'):
    dz = dc i_s (1 - tanh^2 z), dlog_i = (dc tanh z + dn) i_s,
    df = (dc c_{t-1} + dn n_{t-1}) f_s sigmoid(-f), do = dh c / n
    sigmoid'(o); d pre_t = dr_t = (dz, dlog_i, df, do), and d w_rec =
    sum_t h_{t-1}^T dr_t in one product at the end."""

    @staticmethod
    def forward(ctx, w_rec, pre, c0, n0, h0, m0):
        ctx.set_materialize_grads(False)
        state = (c0, n0, h0, m0)
        steps = []
        for t in range(pre.shape[0]):
            state, gates = _slstm_step(w_rec, pre[t], state)
            steps.append((*state[:3], *gates))
        saved = [torch.stack(x) for x in zip(*steps)]
        ctx.save_for_backward(w_rec, c0, n0, h0, *saved)
        return saved[2], state[0], state[1], state[3]

    @staticmethod
    def backward(ctx, g_hs, g_c, g_n, g_m):
        if any(g is not None for g in (g_c, g_n, g_m)):
            raise ValueError("the sLSTM scan takes no gradient through its "
                             "last state")
        w_rec, c0, n0, h0, cs, ns, hs, i_s, f_s, tz, so, f = ctx.saved_tensors
        if g_hs is None:
            return (None,) * 6
        w_t = w_rec.transpose(1, 2)
        d_pre = torch.empty(hs.shape[:-1] + (w_rec.shape[-1],),
                            dtype=hs.dtype, device=hs.device)
        dh, dc, dn = (torch.zeros_like(h0) for _ in range(3))
        for t in reversed(range(hs.shape[0])):
            c_prev, n_prev = (cs[t - 1], ns[t - 1]) if t else (c0, n0)
            dh = dh + g_hs[t]
            dch = dh * so[t] / ns[t]
            dc = dc + dch
            dn = dn - dch * cs[t] / ns[t]
            torch.cat([dc * i_s[t] * (1 - tz[t] * tz[t]),
                       (dc * tz[t] + dn) * i_s[t],
                       (dc * c_prev + dn * n_prev) * f_s[t]
                       * torch.sigmoid(-f[t]),
                       dh * cs[t] / ns[t] * so[t] * (1 - so[t])],
                      dim=-1, out=d_pre[t])
            dh = torch.bmm(d_pre[t], w_t)
            dc, dn = dc * f_s[t], dn * f_s[t]
        h_prev = torch.cat([h0[None], hs[:-1]])
        d_w = torch.einsum("shbd,shbe->hde", h_prev, d_pre)
        return d_w, d_pre, None, None, None, None


def slstm_block(params, cfg: ModelConfig, x, *, mode: str = "train",
                cache=None):
    """x: (B, S, D) normed input; cache: {"conv", "state": (c, n, h, m)},
    each state leaf (B, D) float32, updated in place in "prefill" and
    "decode" mode. Returns (out, cache)."""
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    if mode == "decode":
        cx, hist = conv1d_decode(params["conv"], x, cache["conv"])
    else:
        cx = conv1d_causal(params["conv"], x)
    cx = F.silu(cx)
    pre = torch.stack([nn.linear(params["wz"], x), nn.linear(params["wi"], cx),
                       nn.linear(params["wf"], cx), nn.linear(params["wo"], x)],
                      dim=2)  # (B, S, 4, d)
    sd = nn.state_dtype(x.dtype)
    pre = pre.to(sd)
    w_rec, b_rec = _slstm_recurrent(params, sd)
    pre = pre + b_rec
    # (B, S, 4, H, hd) -> (S, H, B, 4 hd): one step is one batched product
    pre = pre.reshape(B, S, 4, H, hd).permute(1, 3, 0, 2, 4).reshape(
        S, H, B, 4 * hd).contiguous()

    def heads(t):  # (B, d) -> (H, B, hd)
        return t.reshape(B, H, hd).transpose(0, 1).contiguous()

    if mode == "decode":
        state = tuple(heads(t) for t in cache["state"])
    else:
        zeros = torch.zeros(H, B, hd, dtype=sd, device=x.device)
        state = (zeros, zeros, zeros, torch.full_like(zeros, -1e30))
    if mode == "train" and torch.is_grad_enabled():
        hs, *_ = _SLSTMScan.apply(w_rec, pre, *state)  # (S, H, B, hd)
    else:
        hs = []
        for t in range(S):
            state = _slstm_cell(w_rec, pre[t], state)
            hs.append(state[2])
        hs = torch.stack(hs)  # (S, H, B, hd)
    if mode in ("prefill", "decode") and cache is not None:
        cache["conv"].copy_(hist if mode == "decode"
                            else _conv_history(cfg, x))
        for dst, src in zip(cache["state"], state):
            dst.copy_(src.transpose(0, 1).reshape(B, d))
    hs = hs.permute(2, 0, 1, 3).reshape(B, S, d).to(x.dtype)
    hs = nn.apply_norm(params["hnorm"], "rmsnorm", hs)
    return hs + nn.apply_mlp(params["ffn"], "geglu", hs), cache


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device="cpu"):
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, d), dtype=dtype,
                            device=device),
        "state": (torch.zeros((batch, d), **f32),
                  torch.zeros((batch, d), **f32),
                  torch.zeros((batch, d), **f32),
                  torch.full((batch, d), -1e30, **f32)),
    }
