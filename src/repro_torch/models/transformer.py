"""LM assembly: embedding -> head/body/tail layers -> final norm ->
logits; ``repro/models/transformer.py`` in PyTorch for the layer kinds
"attn", "local_attn", "moe_attn", "mla_attn", "mla_moe_attn", "rg_lru",
"mlstm", "slstm" and whisper's "enc_attn" and "xattn". A "moe_attn"
layer is an attention layer whose feed-forward is the MoE of
``models.moe``; its load-balancing loss is
returned by :func:`layer_apply` and summed by :func:`forward`, which
returns it third as the reference does, and serving ignores it. The
"mla_*" kinds are DeepSeek-V2's latent attention with a dense or an MoE
feed-forward. The xLSTM kinds are self-contained blocks: no ``norm2`` /
``mlp``, ``x + block(norm1(x))``.

:func:`forward` and :func:`prefill` take ``tokens`` or, for a
vision-language model whose frontend is a stub (Qwen2-VL), precomputed
``embeddings`` (B, S, d_model); positions are (B, S) or, for M-RoPE,
(3, B, S) (temporal, height, width rows), and :func:`decode_step` gives
an "mrope" model three equal rows.

Parameters and caches keep the reference's tree: ``params["body"][i]``
holds layer ``i`` of the period with every leaf stacked over a leading
``n_periods`` axis, ``params["head"]`` / ``params["tail"]`` are lists of
per-layer trees. Caches do the same, so a body cache leaf is ``(n_periods,
B, ...)`` (batch axis 1) and a head/tail cache leaf is ``(B, ...)`` (batch
axis 0). The reference scans the body with ``lax.scan``; here a Python
loop over ``n_periods`` takes views ``leaf[p]`` of the stacked leaves.

Whisper is an encoder-decoder: :func:`run_encoder` takes precomputed
frame embeddings (B, 1500, d_model) (the conv frontend is a stub, as in
the reference) through ``params["encoder"]``, one layer tree whose
leaves are stacked over ``n_encoder_layers``, and ``enc_norm``; its
decoder layers ("xattn") add a cross-attention over k/v projected from
the encoder output, which :func:`prefill` (given ``frames``) writes into
each layer's cache ``{"self", "cross"}`` and a decode step reads there.
Its positions are a learned table (``params["pos_embed"]``) added at the
embedding.

Layers write their caches in place, so :func:`prefill` and
:func:`decode_step` update the cache they are given and return it.

Training: :func:`loss_fn` (the reference's, with its vocab-chunked CE)
runs the no-cache forward in "train" mode, differentiable end to end
(on the card the attention's gradient is the flash kernel's backward,
the RG-LRU's the scan's backward kernel and the mLSTM's the mLSTM's
backward kernel). Under autograd with
``cfg.remat != "none"`` each body period runs under
``torch.utils.checkpoint`` (non-reentrant): only its input is kept, and
the backward runs the period again (the reference's ``_remat``, a
``jax.checkpoint`` of the scanned period); :func:`run_encoder` does the
same for each encoder layer. ``"dots"``, whose reference
policy saves the products' outputs, recomputes the whole period here as
``"full"`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import nn
from repro_torch.models import recurrent as rec
from repro_torch.models.config import ModelConfig

ATTN_KINDS = ("attn", "local_attn", "moe_attn")
MLA_KINDS = ("mla_attn", "mla_moe_attn")
MOE_KINDS = ("moe_attn", "mla_moe_attn")
XLSTM_KINDS = ("mlstm", "slstm")
KINDS = ATTN_KINDS + MLA_KINDS + ("rg_lru",) + XLSTM_KINDS + ("xattn",)

# float64 serves the CPU tests' float64 evaluation of the small models
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _check_kinds(cfg: ModelConfig):
    other = sorted(set(cfg.layer_kinds) - set(KINDS))
    if other:
        raise ValueError(f"{cfg.name}: the port has no layer kinds {other}")
    if ("xattn" in cfg.layer_kinds) != bool(cfg.n_encoder_layers):
        raise ValueError(f"{cfg.name}: cross-attention layers and an "
                         f"encoder come together")


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# Single layer init / apply / cache
# ---------------------------------------------------------------------------

def layer_init(init: nn.Init, cfg: ModelConfig, kind: str):
    params = {"norm1": nn.norm_init(init, cfg.norm, cfg.d_model)}
    if kind in ATTN_KINDS + ("enc_attn", "xattn"):
        params["attn"] = attn.attention_init(init, cfg)
    elif kind in MLA_KINDS:
        params["attn"] = attn.mla_init(init, cfg)
    elif kind == "rg_lru":
        params["mix"] = rec.griffin_block_init(init, cfg)
    elif kind == "mlstm":
        params["mix"] = rec.mlstm_block_init(init, cfg)
        return params  # self-contained block
    elif kind == "slstm":
        params["mix"] = rec.slstm_block_init(init, cfg)
        return params
    else:
        raise ValueError(kind)
    if kind == "xattn":
        params["norm_x"] = nn.norm_init(init, cfg.norm, cfg.d_model)
        params["xattn"] = attn.attention_init(init, cfg)
    params["norm2"] = nn.norm_init(init, cfg.norm, cfg.d_model)
    if kind in MOE_KINDS:
        params["moe"] = moe_lib.moe_init(init, cfg)
    else:
        params["mlp"] = nn.mlp_init(init, cfg.mlp, cfg.d_model, cfg.d_ff)
    return params


def layer_apply(params, cfg: ModelConfig, kind: str, x, positions, *,
                mode: str, cache=None, enc_out=None):
    """One layer. Returns (x, cache, aux loss); the aux loss is 0.0 but in
    MoE layers. An "xattn" layer's cache is ``{"self": kv cache,
    "cross": {"k", "v"}}``; it takes ``enc_out`` (B, T, d), the encoder
    output, in "train" and "prefill" mode, where a prefill writes the
    cross k/v into the cache in place, and reads them there in "decode"
    mode."""
    aux = 0.0
    rm = cfg.residual_multiplier
    h = nn.apply_norm(params["norm1"], cfg.norm, x)
    if kind in ATTN_KINDS + ("xattn",):
        self_cache = (cache["self"] if kind == "xattn" and cache is not None
                      else cache)
        y, _ = attn.attention_block(params["attn"], cfg, h, positions,
                                    local=(kind == "local_attn"), mode=mode,
                                    cache=self_cache)
    elif kind == "enc_attn":
        y, _ = attn.attention_block_bidirectional(params["attn"], cfg, h,
                                                  positions)
    elif kind in MLA_KINDS:
        y, cache = attn.mla_block(params["attn"], cfg, h, positions,
                                  mode=mode, cache=cache)
    elif kind == "rg_lru":
        y, cache = rec.griffin_block(params["mix"], cfg, h, mode=mode,
                                     cache=cache)
    elif kind in XLSTM_KINDS:
        block = rec.mlstm_block if kind == "mlstm" else rec.slstm_block
        y, cache = block(params["mix"], cfg, h, mode=mode, cache=cache)
        return x + y * rm, cache, aux  # self-contained block
    else:
        raise ValueError(kind)
    x = x + y * rm
    if kind == "xattn":
        x = x + _cross(params, cfg, x, mode, cache, enc_out)
    h2 = nn.apply_norm(params["norm2"], cfg.norm, x)
    if kind in MOE_KINDS:
        y2, aux = moe_lib.moe_apply(params["moe"], cfg, h2)
    else:
        y2 = nn.apply_mlp(params["mlp"], cfg.mlp, h2)
    return x + y2 * rm, cache, aux


def _cross(params, cfg: ModelConfig, x, mode, cache, enc_out):
    """The cross-attention of an "xattn" layer (its residual's term)."""
    hx = nn.apply_norm(params["norm_x"], cfg.norm, x)
    if mode in ("train", "prefill"):
        if enc_out is None:
            raise ValueError(f"{cfg.name}: a {mode} of a decoder with "
                             f"cross-attention takes the encoder output")
        xkv = attn.encode_cross_kv(params["xattn"], cfg, enc_out)
        if mode == "prefill" and cache is not None:
            for name, t in xkv.items():
                cache["cross"][name].copy_(t)
    else:
        xkv = cache["cross"]
    return attn.cross_attention_block(params["xattn"], cfg, hx, xkv,
                                      mode=mode)


def layer_cache(cfg: ModelConfig, kind: str, batch: int, length: int,
                dtype=torch.bfloat16, device="cpu"):
    if kind in ATTN_KINDS:
        return attn.init_kv_cache(cfg, batch, length,
                                  local=(kind == "local_attn"), dtype=dtype,
                                  device=device)
    if kind in MLA_KINDS:
        return attn.init_mla_cache(cfg, batch, length, dtype=dtype,
                                   device=device)
    if kind == "rg_lru":
        return rec.init_griffin_cache(cfg, batch, dtype=dtype, device=device)
    if kind == "mlstm":
        return rec.init_mlstm_cache(cfg, batch, dtype=dtype, device=device)
    if kind == "slstm":
        return rec.init_slstm_cache(cfg, batch, dtype=dtype, device=device)
    if kind == "xattn":
        shape = (batch, cfg.n_audio_frames, cfg.n_kv_heads, cfg.head_dim)
        return {"self": attn.init_kv_cache(cfg, batch, length, local=False,
                                           dtype=dtype, device=device),
                "cross": {name: torch.zeros(shape, dtype=dtype,
                                            device=device)
                          for name in ("k", "v")}}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Whole-model init / cache
# ---------------------------------------------------------------------------

class _StackedInit(nn.Init):
    """Prepends an ``n_periods`` axis to every parameter."""

    def __init__(self, base: nn.Init, n: int):
        super().__init__(base.generator, base.dtype, base.device)
        self.n = n

    def param(self, shape, scale: float = 1.0, mode: str = "normal",
              f32: bool = False):
        return super().param((self.n,) + tuple(shape), scale=scale,
                             mode=mode, f32=f32)


def model_init(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    """Seeded parameters on ``generator``'s device, in the compute type
    (float32 for the leaves read in float32: norm scales and biases, the
    RG-LRU ``lambda``, the MoE router)."""
    return _init(cfg, nn.Init(generator, dtype=compute_dtype(cfg)))


def model_template(cfg: ModelConfig) -> Dict:
    """The tree of :func:`model_init` with ``meta`` tensors of its
    shapes and types: the structure that a flat checkpoint is read
    into (``models.params.lm_params``), empty nodes included."""
    return _init(cfg, nn.Init(None, dtype=compute_dtype(cfg),
                              device="meta"))


def _init(cfg: ModelConfig, init: nn.Init) -> Dict:
    _check_kinds(cfg)
    params: Dict[str, Any] = {
        "embed": nn.embed_init(init, cfg.vocab_size, cfg.d_model)}
    if cfg.rope_style == "learned":
        params["pos_embed"] = {"table": init.param(
            (cfg.max_seq, cfg.d_model), scale=0.02)}
    if cfg.n_encoder_layers:  # one tree, leaves stacked over the layers
        params["encoder"] = layer_init(
            _StackedInit(init, cfg.n_encoder_layers), cfg, "enc_attn")
        params["enc_norm"] = nn.norm_init(init, cfg.norm, cfg.d_model)
    for group, pattern in (("head", cfg.head_pattern),
                           ("tail", cfg.tail_pattern)):
        if pattern:
            params[group] = [layer_init(init, cfg, k) for k in pattern]
    body = _StackedInit(init, cfg.n_periods)
    params["body"] = [layer_init(body, cfg, k) for k in cfg.body_pattern]
    params["final_norm"] = nn.norm_init(init, cfg.norm, cfg.d_model)
    if not cfg.tie_embeddings:
        params["lm_head"] = nn.linear_init(init, cfg.d_model, cfg.vocab_size)
    return params


def model_cache(cfg: ModelConfig, batch: int, length: int,
                dtype=torch.bfloat16, device="cpu") -> Dict:
    _check_kinds(cfg)
    cache: Dict[str, Any] = {}
    for group, pattern in (("head", cfg.head_pattern),
                           ("tail", cfg.tail_pattern)):
        if pattern:
            cache[group] = [layer_cache(cfg, k, batch, length, dtype, device)
                            for k in pattern]
    cache["body"] = [
        tree_map(lambda x: x[None].repeat((cfg.n_periods,)
                                          + (1,) * x.dim()),
                 layer_cache(cfg, k, batch, length, dtype, device))
        for k in cfg.body_pattern]
    return cache


def _period(params, cfg: ModelConfig, p: int, x, positions, mode, cache,
            enc_out):
    """Period ``p`` of the body: views ``leaf[p]`` of the stacked leaves,
    every layer of ``body_pattern`` in turn. Returns (x, summed aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, kind in enumerate(cfg.body_pattern):
        lp = tree_map(lambda a: a[p], params["body"][i])
        lc = (None if cache is None
              else tree_map(lambda a: a[p], cache["body"][i]))
        x, _, a = layer_apply(lp, cfg, kind, x, positions, mode=mode,
                              cache=lc, enc_out=enc_out)
        aux = aux + a
    return x, aux


def cache_rows(cache, rows: slice):
    """Views of the batch rows ``rows`` of every cache leaf (batch axis 1
    in the body, 0 in head and tail): writing into them writes into
    ``cache``."""
    out = {}
    for group, tree in cache.items():
        if group == "body":
            out[group] = tree_map(lambda a: a[:, rows], tree)
        else:
            out[group] = tree_map(lambda a: a[rows], tree)
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def run_encoder(params, cfg: ModelConfig, frames):
    """Whisper's encoder over precomputed frame embeddings (B, T, d) (the
    conv frontend is a stub, as in the reference): fixed sinusoidal
    positions, cast to the frames' type before the add, then the
    ``n_encoder_layers`` "enc_attn" layers and ``enc_norm``. Under
    autograd with ``cfg.remat != "none"`` each layer runs under
    non-reentrant ``torch.utils.checkpoint``, as the reference's
    ``_remat(body, cfg)``."""
    B, T, D = frames.shape
    x = frames + nn.sinusoidal_positions(T, D, frames.device)[None].to(
        frames.dtype)
    positions = torch.arange(T, device=x.device).expand(B, T)
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for i in range(cfg.n_encoder_layers):
        if remat:  # keep the layer's input, recompute the rest
            x = checkpoint(_encoder_layer, params, cfg, i, x, positions,
                           use_reentrant=False)
        else:
            x = _encoder_layer(params, cfg, i, x, positions)
    return nn.apply_norm(params["enc_norm"], cfg.norm, x)


def _encoder_layer(params, cfg: ModelConfig, i: int, x, positions):
    """Encoder layer ``i``: views ``leaf[i]`` of the stacked leaves."""
    lp = tree_map(lambda a: a[i], params["encoder"])
    return layer_apply(lp, cfg, "enc_attn", x, positions, mode="train")[0]


def encode(params, cfg: ModelConfig, frames):
    """:func:`run_encoder` on frames of ``n_audio_frames`` rows, in the
    compute type; frames of another length are refused (the cross cache
    is a fixed buffer of that many rows)."""
    if frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: its prefill "
                         f"takes frames (B, {cfg.n_audio_frames}, "
                         f"{cfg.d_model})")
    if tuple(frames.shape[1:]) != (cfg.n_audio_frames, cfg.d_model):
        raise ValueError(f"{cfg.name}: frames must be (B, "
                         f"{cfg.n_audio_frames}, {cfg.d_model}), got "
                         f"{tuple(frames.shape)}")
    return run_encoder(params, cfg, frames.to(compute_dtype(cfg)))


def forward(params, cfg: ModelConfig, *, tokens=None, embeddings=None,
            positions=None, mode: str = "train", cache=None,
            enc_out=None, skip_unembed: bool = False):
    """Decoder forward from tokens (B, S) integers or embeddings (B, S,
    d_model). Returns (logits or the final hidden state, cache, the
    summed aux loss (a float32 0-d tensor, 0 without MoE layers)); the
    cache (prefill /
    decode) is written in place. A decoder with cross-attention takes
    the encoder output ``enc_out`` in "train" and "prefill" mode; learned
    positions are added at the embedding, at ``clip(pos, 0, max_seq -
    1)``, in the compute type."""
    if (tokens is None) == (embeddings is None):
        raise ValueError("forward takes tokens or embeddings, one of them")
    if embeddings is None:
        x = nn.embed(params["embed"], tokens, compute_dtype(cfg))
    else:
        x = embeddings.to(compute_dtype(cfg))
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    B, S = x.shape[:2]
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    if cfg.rope_style == "learned":
        table = params["pos_embed"]["table"]
        pos2d = positions[0] if positions.dim() == 3 else positions
        x = x + table[pos2d.clamp(0, table.shape[0] - 1)].to(x.dtype)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def group(name, pattern, x, aux_total):
        for i, kind in enumerate(pattern):
            x, _, aux = layer_apply(params[name][i], cfg, kind, x, positions,
                                    mode=mode,
                                    cache=None if cache is None
                                    else cache[name][i], enc_out=enc_out)
            aux_total = aux_total + aux
        return x, aux_total

    x, aux_total = group("head", cfg.head_pattern, x, aux_total)
    remat = (mode == "train" and cfg.remat != "none"
             and torch.is_grad_enabled())
    for p in range(cfg.n_periods):
        if remat:  # keep the period's input, recompute the rest
            x, aux = checkpoint(_period, params, cfg, p, x, positions, mode,
                                cache, enc_out, use_reentrant=False)
        else:
            x, aux = _period(params, cfg, p, x, positions, mode, cache,
                             enc_out)
        aux_total = aux_total + aux
    x, aux_total = group("tail", cfg.tail_pattern, x, aux_total)
    x = nn.apply_norm(params["final_norm"], cfg.norm, x)
    out = x if skip_unembed else unembed(params, cfg, x)
    return out, cache, aux_total


def unembed(params, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        logits = nn.unembed(params["embed"], x)
    else:
        logits = nn.linear(params["lm_head"], x)
    return logits / cfg.logits_scaling


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels):
    """Mean CE in float32; logits (..., V), labels (...) integers."""
    logits = logits.to(torch.float32)
    m = logits.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    correct = logits.gather(-1, labels[..., None].long())[..., 0]
    return torch.mean(lse - correct)


def _chunk_ce(params, cfg: ModelConfig, hidden, labels):
    return cross_entropy(unembed(params, cfg, hidden), labels)


def loss_fn(params, cfg: ModelConfig, batch):
    """``repro/models/transformer.py::loss_fn``. batch keys:
    tokens|embeddings, labels, [positions], [frames]. Returns
    (total loss, {"ce", "aux"}), float32 0-d tensors; the total is
    ``ce + aux``.

    With ``cfg.chunked_ce > 0`` dividing S (gemma3 and RecurrentGemma set
    512), the logits are taken ``chunked_ce`` positions at a time, each
    chunk's CE under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` of the scanned chunk), so no more than one chunk's
    (B, C, V) float32 logits live at once, in the forward and in the
    backward; the chunk means are summed and scaled by C / S."""
    enc_out = None
    if cfg.n_encoder_layers:
        enc_out = run_encoder(params, cfg,
                              batch["frames"].to(compute_dtype(cfg)))
    kwargs = dict(mode="train", cache=None, enc_out=enc_out)
    if "positions" in batch:
        kwargs["positions"] = batch["positions"]
    if "embeddings" in batch:
        kwargs["embeddings"] = batch["embeddings"]
    else:
        kwargs["tokens"] = batch["tokens"]

    labels = batch["labels"]
    S = labels.shape[1]
    if cfg.chunked_ce > 0 and S % cfg.chunked_ce == 0:
        hidden, _, aux = forward(params, cfg, skip_unembed=True, **kwargs)
        C = cfg.chunked_ce
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(0, S, C):
            h_i, y_i = hidden[:, i:i + C], labels[:, i:i + C]
            if torch.is_grad_enabled():
                total = total + checkpoint(_chunk_ce, params, cfg, h_i, y_i,
                                           use_reentrant=False)
            else:
                total = total + _chunk_ce(params, cfg, h_i, y_i)
        ce = total * (C / S)
    else:
        logits, _, aux = forward(params, cfg, **kwargs)
        ce = cross_entropy(logits, labels)
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(params, cfg: ModelConfig, cache, *, tokens=None,
            embeddings=None, positions=None, frames=None):
    """Run the whole prompt (tokens or embeddings), fill the cache in
    place; returns (last-position logits (B, V), cache). An
    encoder-decoder (whisper) takes ``frames`` (B, n_audio_frames,
    d_model), runs the encoder over them and writes the cross k/v of
    every layer into the cache."""
    enc_out = encode(params, cfg, frames) if cfg.n_encoder_layers else None
    hidden, cache, _ = forward(params, cfg, tokens=tokens,
                               embeddings=embeddings, positions=positions,
                               mode="prefill", cache=cache, enc_out=enc_out,
                               skip_unembed=True)
    return unembed(params, cfg, hidden[:, -1:])[:, 0], cache


def decode_step(params, cfg: ModelConfig, tokens, pos, cache):
    """One token for every sequence. tokens (B, 1); pos (B,) absolute;
    an "mrope" model turns it by three equal position rows."""
    positions = pos[:, None]
    if cfg.rope_style == "mrope":
        positions = positions[None].expand(3, *positions.shape)
    logits, cache, _ = forward(params, cfg, tokens=tokens,
                               positions=positions, mode="decode",
                               cache=cache)
    return logits[:, 0], cache
