"""Layer library of the port: ``repro/models/nn.py`` in PyTorch.

Parameters keep the reference's layout, so that they cross between the
packages without a transpose: a linear layer is ``{"w": (d_in, d_out)}``
and computes ``y = x @ w + b``; a gated MLP is ``{"wi": (d, 2, d_ff),
"wo": (d_ff, d)}``, the gelu MLP two biased linears ``{"in", "out"}``;
an embedding is ``{"table": (vocab, d)}``.

The reference keeps every parameter in float32 and casts it to the
compute type (``cfg.dtype``) at each use. The port holds the parameters
read in the compute type in that type once (:class:`Init` with a
``dtype``; ``models.params.cast_params`` for carried weights), which
gives the same products with half the memory in bfloat16. The leaves
read in float32 (norm scales and biases, the RG-LRU ``lambda``, the MoE
router) stay float32. An :class:`Init` on the ``meta`` device draws
nothing: it gives the parameter tree's structure and shapes.
A float64 compute type (tests only: the reference the float32 runs of
both packages are measured against) keeps norms and recurrent states in
float64 too (:func:`state_dtype`).

:class:`Linear` is the linear layer as a module, for ``core.model``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # fan-in scaled normal weights and zero bias, the scheme of
        # repro.models.nn.linear_init (the draws differ from jax.random)
        self.w = nn.Parameter(
            torch.randn(d_in, d_out, generator=generator)
            / math.sqrt(max(d_in, 1)))
        self.b = nn.Parameter(torch.zeros(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w.to(x.dtype)
        if self.b is not None:
            y = y + self.b.to(x.dtype)
        return y


# ---------------------------------------------------------------------------
# Seeded initialisation
# ---------------------------------------------------------------------------

class Init:
    """Draws parameters from a ``torch.Generator`` with the distributions
    of ``repro.models.nn.Init`` (not its draws): ``normal`` x scale,
    ``zeros``, ``ones`` and ``lru_lambda`` U(0.2, 0.85).

    Every draw is made in float32 on ``generator``'s device and then
    stored in ``dtype`` (the compute type), or in float32 for leaves
    the reference reads in float32 (``f32=True``).
    """

    def __init__(self, generator: Optional[torch.Generator],
                 dtype=torch.float32, device=None):
        self.generator = generator
        self.device = (generator.device if generator is not None
                       else torch.device(device))
        self.dtype = dtype

    def param(self, shape, scale: float = 1.0, mode: str = "normal",
              f32: bool = False) -> torch.Tensor:
        shape = tuple(shape)
        dtype = torch.float32 if f32 else self.dtype
        if self.device.type == "meta":  # the tree's structure only
            return torch.empty(shape, device=self.device, dtype=dtype)
        kw = dict(device=self.device, dtype=torch.float32)
        if mode == "zeros":
            return torch.zeros(shape, device=self.device, dtype=dtype)
        if mode == "ones":
            return torch.ones(shape, device=self.device, dtype=dtype)
        if mode == "normal":
            arr = torch.randn(shape, generator=self.generator, **kw)
            arr.mul_(scale)
        elif mode == "lru_lambda":  # Griffin Lambda init: U(0.2, 0.85)
            arr = torch.rand(shape, generator=self.generator, **kw)
            arr.mul_(0.85 - 0.2).add_(0.2)
        else:
            raise ValueError(mode)
        return arr.to(dtype)


def fanin_scale(fan_in: int) -> float:
    return 1.0 / math.sqrt(max(fan_in, 1))


# ---------------------------------------------------------------------------
# Linear / embeddings
# ---------------------------------------------------------------------------

def linear_init(init: Init, d_in: int, d_out: int, bias: bool = False,
                scale: Optional[float] = None):
    scale = fanin_scale(d_in) if scale is None else scale
    params = {"w": init.param((d_in, d_out), scale=scale)}
    if bias:
        params["b"] = init.param((d_out,), mode="zeros")
    return params


def linear(params, x):
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def embed_init(init: Init, vocab: int, d_model: int):
    return {"table": init.param((vocab, d_model), scale=1.0)}


def embed(params, ids, dtype):
    return params["table"][ids].to(dtype)


def unembed(params, x):
    """Logits via the (tied) embedding table."""
    return x @ params["table"].to(x.dtype).T


# ---------------------------------------------------------------------------
# Norms (RMSNorm, LayerNorm; computed in float32)
# ---------------------------------------------------------------------------

def state_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type of norms and recurrent states for a compute type:
    float32, or float64 when the compute type is float64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def norm_init(init: Init, kind: str, dim: int):
    if kind == "rmsnorm":
        return {"scale": init.param((dim,), mode="ones", f32=True)}
    if kind == "layernorm":
        return {"scale": init.param((dim,), mode="ones", f32=True),
                "bias": init.param((dim,), mode="zeros", f32=True)}
    if kind == "nonparametric_ln":
        return {}
    raise ValueError(f"the port has no norm {kind!r}")


def apply_norm(params, kind: str, x, eps: float = 1e-6):
    """RMSNorm, or LayerNorm with (``layernorm``) or without
    (``nonparametric_ln``) its scale and bias, evaluated in float32 (in
    float64 for a float64 compute type) and returned in x's type."""
    if kind not in ("rmsnorm", "layernorm", "nonparametric_ln"):
        raise ValueError(f"the port has no norm {kind!r}")
    xf = x.to(state_dtype(x.dtype))
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        y = y * params["scale"].to(xf.dtype)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if params:
            y = y * params["scale"].to(xf.dtype) + params["bias"].to(xf.dtype)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs: gated (swiglu, geglu) and whisper's gelu
# ---------------------------------------------------------------------------

def mlp_init(init: Init, kind: str, d_model: int, d_ff: int):
    if kind in ("swiglu", "geglu"):
        return {"wi": init.param((d_model, 2, d_ff),
                                 scale=fanin_scale(d_model)),
                "wo": init.param((d_ff, d_model), scale=fanin_scale(d_ff))}
    if kind == "gelu":  # two biased linears (whisper)
        return {"in": linear_init(init, d_model, d_ff, bias=True),
                "out": linear_init(init, d_ff, d_model, bias=True)}
    raise ValueError(f"the port has no MLP {kind!r}")


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(params, kind: str, x):
    if kind == "gelu":
        return linear(params["out"], gelu(linear(params["in"], x)))
    wi = params["wi"].to(x.dtype)
    d, _, d_ff = wi.shape
    # (d, 2, d_ff) as (d, 2*d_ff): columns [0, d_ff) gate, [d_ff, 2 d_ff) up
    h = x @ wi.reshape(d, 2 * d_ff)
    gate, up = h[..., :d_ff], h[..., d_ff:]
    act = F.silu(gate) if kind == "swiglu" else gelu(gate)
    return (act * up) @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (half-split RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions[..., None].float() * freqs  # (..., seq, hd/2)
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections=(1, 1, 2)):
    """Qwen2-VL's M-RoPE: the rotary frequencies split into temporal,
    height and width groups, each turned by its own row of positions.

    x: (batch, seq, heads, head_dim); positions3: (3, batch, seq).
    ``sections`` are relative fractions of head_dim/2 for (t, h, w), as
    in ``repro/models/nn.py::apply_mrope``. Three equal rows give
    :func:`apply_rope`."""
    half = x.shape[-1] // 2
    total = sum(sections)
    splits = [half * s // total for s in sections]
    splits[-1] = half - sum(splits[:-1])
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (half,)
    parts, start = [], 0
    for i, n in enumerate(splits):
        pos = positions3[i][..., None].float()  # (b, s, 1)
        parts.append(pos * freqs[start:start + n])
        start += n
    ang = torch.cat(parts, -1)  # (b, s, half)
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, dim: int, device=None) -> torch.Tensor:
    """(n, dim) float32 table: sin at the even columns, cos at the odd,
    of position x 10000^(-2i/dim) (whisper's encoder positions)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros((n, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe
