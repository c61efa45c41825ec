"""Whisper-small in the port against the JAX package, and the golden
file of the small whisper for the card.

- The configuration (full and ``scaled_down``) and the parameter tree
  (the encoder's one tree of leaves stacked over its layers,
  ``pos_embed``, ``enc_norm``, each decoder layer's ``norm_x`` and
  ``xattn``, the gelu MLP's biased linears).
- ``sinusoidal_positions``, the gelu MLP, ``run_encoder``,
  ``encode_cross_kv`` and ``cross_attention_block`` against the
  reference's on its ``Model.init(PRNGKey(0))`` parameters.
- The flash kernel's plain version with ``causal=False`` (the encoder's
  S = T and the cross-attention's S != T) against the reference's
  ``attend_full`` and its Pallas kernel in interpret mode.
- The small whisper, ``whisper-small`` ``scaled_down(dtype="float32")``
  (one encoder layer over 8 frames, one decoder layer): the no-cache
  forward with the encoder output, ``prefill(frames=)`` of 16 tokens and
  three decode steps (float32 caches), and a greedy decode of four steps,
  against JAX. The JAX outputs are computed once a module (one eager init
  and one set of compiles) and shared by the tests, the golden file's
  freshness test included.
- One slot's prefill through ``transformer.cache_rows``, frames of the
  wrong length, and the port's ``SlotServer`` refusing an
  encoder-decoder; the reference's ``SlotServer`` failing on whisper
  (it passes no frames) is pinned on the JAX side only.

``src/repro_torch/assets/lm_zoo_whisper_small_golden.npz`` holds
``config``, ``params/<path>``, ``frames``, ``enc_out``, ``prefill/*``,
``cache_len``, ``cache_dtype``, ``decode/*`` and ``greedy/tokens``
(``models.params.load_whisper_golden``). Regenerate it (about 10 s on a
CPU) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_whisper.py --write
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ASSETS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "assets"
GOLDEN = ASSETS / "lm_zoo_whisper_small_golden.npz"

ARCH = "whisper-small"
SEED = 0
B, S, CACHE_LEN, DECODE_STEPS, GREEDY_STEPS = 2, 16, 24, 3, 4
ATOL = 1e-4  # float32 on both sides, summed in different orders
BLOCK_ATOL = 1e-5  # one block, float32 on both sides
FLASH_ATOL = 2e-5  # the reference's float32 kernel tolerance
POS_ATOL = 1e-6
CACHE_DTYPE = "float32"


def jax_config():
    from repro.configs import get_config

    return get_config(ARCH).scaled_down(dtype="float32")


def port_config():
    from repro_torch.configs import get_config

    return get_config(ARCH).scaled_down(dtype="float32")


def inputs(cfg):
    """(frames (B, n_audio_frames, d_model), tokens (B, S +
    DECODE_STEPS))."""
    rng = np.random.default_rng(SEED)
    frames = rng.standard_normal(
        (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size,
                          (B, S + DECODE_STEPS)).astype(np.int32)
    return frames, tokens


def jax_case():
    """The JAX package's parameters (numpy) and outputs."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as jtfm
    from repro.models.model_zoo import build_model

    cfg = jax_config()
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(SEED))  # eager: cheaper here
    frames, tokens = inputs(cfg)
    enc = jax.jit(lambda p, f: jtfm.run_encoder(p, cfg, f))
    enc_out = enc(params, jnp.asarray(frames))
    forward = jax.jit(lambda p, t, e: jtfm.forward(p, cfg, tokens=t,
                                                   enc_out=e)[0])
    prefill = jax.jit(model.prefill)
    decode = jax.jit(model.decode_step)
    cache = model.init_cache(B, CACHE_LEN, dtype=jnp.float32)
    lp, after = prefill(params, cache, tokens=jnp.asarray(tokens[:, :S]),
                        frames=jnp.asarray(frames))
    dec, cache = [], after
    for i in range(DECODE_STEPS):
        ld, cache = decode(params, jnp.asarray(tokens[:, S + i:S + i + 1]),
                           jnp.full((B,), S + i, jnp.int32), cache)
        dec.append(np.asarray(ld, np.float32))
    # a greedy decode from the same prefill (JAX's caches are values)
    greedy, cache = [np.asarray(jnp.argmax(lp, -1), np.int32)], after
    for i in range(GREEDY_STEPS):
        ld, cache = decode(params, jnp.asarray(greedy[-1])[:, None],
                           jnp.full((B,), S + i, jnp.int32), cache)
        greedy.append(np.asarray(jnp.argmax(ld, -1), np.int32))
    return {
        "cfg": cfg, "frames": frames, "tokens": tokens,
        "enc_out": np.asarray(enc_out),
        "forward": np.asarray(forward(params, jnp.asarray(tokens),
                                      enc_out)),
        "prefill": np.asarray(lp, np.float32), "decode": np.stack(dec),
        "prefill_cache": jax.tree_util.tree_map(np.asarray, after),
        "greedy": np.stack(greedy, 1),
        "params": jax.tree_util.tree_map(np.asarray, params)}


@pytest.fixture(scope="module")
def run():
    """The JAX outputs of the small whisper, computed once."""
    return jax_case()


def port_params(run):
    from repro_torch.models.params import lm_params

    return lm_params(run["params"], port_config(), device="cpu")


def t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


# ------------------------------------------------------------ configuration
def test_config_matches_reference():
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    full, ref = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref)
    assert full.layer_kinds == ref.layer_kinds == ("xattn",) * 12
    assert (full.n_encoder_layers, full.n_audio_frames, full.rope_style,
            full.mlp, full.norm) == (12, 1500, "learned", "gelu",
                                     "layernorm")
    small = get_config(ARCH).scaled_down(dtype="float32")
    assert dataclasses.asdict(small) == dataclasses.asdict(jax_config())
    assert (small.n_encoder_layers, small.n_audio_frames) == (1, 8)


def test_param_tree_matches_reference_layout():
    """Seeded init keeps the reference's paths and shapes; LayerNorm
    scales and biases stay float32, the linear biases (``b``) and the
    position table take the compute type."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models.model_zoo import build_model as jax_build
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import F32_LEAVES

    params = build_model(get_config(ARCH).scaled_down()).init(
        0, device="cpu")  # bfloat16
    shapes = jax_build(jax_get_config(ARCH).scaled_down()).abstract_params()
    ref = jax.tree_util.tree_flatten_with_path(shapes)
    ours = jax.tree_util.tree_flatten_with_path(params)
    assert (jax.tree_util.tree_structure(shapes)
            == jax.tree_util.tree_structure(params))
    for (path, sds), (_, leaf) in zip(ref[0], ours[0]):
        assert tuple(leaf.shape) == sds.shape, path
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        f32 = any(name.endswith(end) for end in F32_LEAVES)
        assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16), name
    assert params["encoder"]["attn"]["wq"]["w"].shape == (1, 64, 64)
    assert params["encoder"]["mlp"]["in"]["b"].dtype == torch.bfloat16
    assert params["enc_norm"]["bias"].dtype == torch.float32
    assert params["pos_embed"]["table"].shape == (64, 64)
    assert sorted(params["body"][0]) == ["attn", "mlp", "norm1", "norm2",
                                         "norm_x", "xattn"]


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("n,dim", [(8, 64), (16, 768)])
def test_sinusoidal_positions_match_jax(n, dim):
    from repro.models import nn as jnn
    from repro_torch.models import nn

    got = nn.sinusoidal_positions(n, dim)
    assert got.dtype == torch.float32 and got.shape == (n, dim)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jnn.sinusoidal_positions(n, dim)),
                               atol=POS_ATOL, rtol=0)


def test_sinusoidal_positions_at_1500_frames_differ_by_the_exp_ulp():
    """At whisper's 1500 frames the tables part by more than 1e-6: XLA's
    and PyTorch's float32 ``exp`` give frequencies 1 ulp apart for some
    columns (neither is correctly rounded everywhere), position p scales
    that to p ulp of the angle, and the angle p * div (up to 1499) is
    rounded to float32 on either side of that. Each entry stays within
    that bound (plus 2 ulp of sin / cos) of JAX's."""
    import math

    from repro.models import nn as jnn
    from repro_torch.models import nn

    n, dim = 1500, 768
    got = nn.sinusoidal_positions(n, dim).numpy()
    want = np.asarray(jnn.sinusoidal_positions(n, dim))
    div = np.repeat(np.exp(np.arange(0, dim, 2)
                           * (-math.log(10000.0) / dim)), 2)[None]
    angle = np.arange(n)[:, None] * div
    bound = (angle * 2.0 ** -23 + np.spacing(angle.astype(np.float32))
             + 2.0 ** -22)
    diff = np.abs(got - want)
    assert diff.max() > POS_ATOL  # the amplification is real
    assert (diff <= bound).all(), float((diff - bound).max())


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_gelu_mlp_matches_jax(run):
    """gelu(x @ in + b) @ out + b, tanh gelu, on the decoder layer's
    parameters."""
    import jax.numpy as jnp

    from repro.models import nn as jnn
    from repro_torch.models import nn

    jp = run["params"]["body"][0]["mlp"]
    jp = {k: {n: a[0] for n, a in v.items()} for k, v in jp.items()}
    x = _x((B, 5, 64), 1)
    expect = jnn.apply_mlp(jp, "gelu", jnp.asarray(x))
    got = nn.apply_mlp({k: {n: t(a) for n, a in v.items()}
                        for k, v in jp.items()}, "gelu", t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                               atol=BLOCK_ATOL, rtol=0)


def test_run_encoder_matches_jax(run):
    from repro_torch.models import transformer as tfm

    with torch.no_grad():
        got = tfm.run_encoder(port_params(run), port_config(),
                              t(run["frames"]))
    assert got.shape == run["enc_out"].shape
    np.testing.assert_allclose(got.numpy(), run["enc_out"],
                               atol=BLOCK_ATOL, rtol=0)


def _xattn_params(run):
    jp = run["params"]["body"][0]["xattn"]
    return {k: {n: a[0] for n, a in v.items()} for k, v in jp.items()}


def test_encode_cross_kv_matches_jax(run):
    import jax.numpy as jnp

    from repro.models import attention as jattn
    from repro_torch.models import attention as attn

    jp = _xattn_params(run)
    expect = jattn.encode_cross_kv(jp, jax_config(),
                                   jnp.asarray(run["enc_out"]))
    got = attn.encode_cross_kv({k: {n: t(a) for n, a in v.items()}
                                for k, v in jp.items()}, port_config(),
                               t(run["enc_out"]))
    for name in ("k", "v"):
        assert got[name].shape == (B, 8, 2, 16)
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(expect[name]),
                                   atol=BLOCK_ATOL, rtol=0)


@pytest.mark.parametrize("mode,S_in", [("train", 11), ("prefill", 16),
                                       ("decode", 1)])
def test_cross_attention_block_matches_jax(run, mode, S_in):
    """Queries over the encoder's 8 keys: through the flash wrapper
    (train, prefill) and with materialized scores (decode)."""
    import jax.numpy as jnp

    from repro.models import attention as jattn
    from repro_torch.models import attention as attn

    jp = _xattn_params(run)
    kv = jattn.encode_cross_kv(jp, jax_config(), jnp.asarray(run["enc_out"]))
    x = _x((B, S_in, 64), 2)
    expect = jattn.cross_attention_block(jp, jax_config(), jnp.asarray(x),
                                         kv)
    got = attn.cross_attention_block(
        {k: {n: t(a) for n, a in v.items()} for k, v in jp.items()},
        port_config(), t(x), {k: t(np.asarray(v)) for k, v in kv.items()},
        mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                               atol=BLOCK_ATOL, rtol=0)


# --------------------------------------------------- flash, no mask
@pytest.mark.parametrize("Bq,H,KH,Sq,T", [
    (2, 4, 2, 24, 40), (1, 4, 4, 48, 48), (2, 6, 3, 40, 24),
    (1, 12, 12, 1, 64)])
def test_plain_flash_without_a_mask_matches_jax(Bq, H, KH, Sq, T):
    """``causal=False``: every query over every key, S = T (the encoder)
    and S != T (the cross-attention, S > T included), against the
    reference's ``attend_full`` and its Pallas kernel in interpret mode
    (blocks of min(512, S) and min(512, T))."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.flash_attention import ops as jops
    from repro.models import attention as jattn
    from repro_torch.kernels.flash_attention import ops

    D = 16
    q, k, v = (_x((Bq, n, h, D), i) for i, (n, h) in enumerate(
        ((Sq, H), (T, KH), (T, KH))))
    scale = 1.0 / np.sqrt(D)
    got = ops.flash_attention(t(q), t(k), t(v), causal=False).numpy()
    full = jax.jit(jattn.attend_full,
                   static_argnames=("causal", "window", "scale"))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.broadcast_to(jnp.arange(Sq), (Bq, Sq)),
        jnp.broadcast_to(jnp.arange(T), (Bq, T)), causal=False, window=0,
        scale=scale)
    pallas = jax.jit(lambda q, k, v: jops.flash_attention(
        q, k, v, causal=False, interpret=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert got.shape == (Bq, Sq, H, D)
    for name, expect in (("attend_full", full), ("pallas", pallas)):
        np.testing.assert_allclose(got, np.asarray(expect), atol=FLASH_ATOL,
                                   rtol=FLASH_ATOL, err_msg=name)


# ------------------------------------------------------- parity with JAX
def test_forward_with_enc_out_matches_jax(run):
    from repro_torch.models import transformer as tfm

    with torch.no_grad():
        logits, _, _ = tfm.forward(port_params(run), port_config(),
                                   tokens=t(run["tokens"]),
                                   enc_out=t(run["enc_out"]))
    np.testing.assert_allclose(logits.numpy(), run["forward"], atol=ATOL,
                               rtol=0)


def check_prefill_and_decode(params, cfg, frames, tokens, prefill_logits,
                             decode_logits, greedy, atol, device="cpu"):
    """Prefill of S tokens over ``frames`` and the decode steps fed
    ``tokens[:, S:]`` (float32 caches), then a fresh prefill and a greedy
    decode; returns the prefill's cache."""
    from repro_torch.models.model_zoo import build_model

    model = build_model(cfg)
    frames = torch.as_tensor(frames, device=device)
    tokens = torch.as_tensor(tokens, device=device).long()
    Bt = tokens.shape[0]
    with torch.no_grad():
        cache = model.init_cache(Bt, CACHE_LEN, dtype=torch.float32,
                                 device=device)
        lp, cache = model.prefill(params, cache, tokens=tokens[:, :S],
                                  frames=frames)
        np.testing.assert_allclose(lp.cpu().numpy(), prefill_logits,
                                   atol=atol, rtol=0)
        prefill_cache = {k: v.clone() for k, v in
                         cache["body"][0]["cross"].items()}
        for i in range(len(decode_logits)):
            ld, cache = model.decode_step(
                params, tokens[:, S + i:S + i + 1],
                torch.full((Bt,), S + i, device=device), cache)
            np.testing.assert_allclose(ld.cpu().numpy(), decode_logits[i],
                                       atol=atol, rtol=0)
        cache = model.init_cache(Bt, CACHE_LEN, dtype=torch.float32,
                                 device=device)
        lp, cache = model.prefill(params, cache, tokens=tokens[:, :S],
                                  frames=frames)
        got = [lp.argmax(-1)]
        for i in range(greedy.shape[1] - 1):
            ld, cache = model.decode_step(
                params, got[-1][:, None],
                torch.full((Bt,), S + i, device=device), cache)
            got.append(ld.argmax(-1))
    assert torch.stack(got, 1).cpu().numpy().tolist() == greedy.tolist()
    return prefill_cache


def test_prefill_and_decode_match_jax(run):
    """Prefill from tokens and frames, three decode steps (float32
    caches), a four-step greedy decode; the cross cache the prefill
    wrote equals JAX's."""
    cross = check_prefill_and_decode(
        port_params(run), port_config(), run["frames"], run["tokens"],
        run["prefill"], run["decode"], run["greedy"], ATOL)
    jcross = run["prefill_cache"]["body"][0]["cross"]
    for name in ("k", "v"):
        np.testing.assert_allclose(cross[name].numpy(), jcross[name],
                                   atol=BLOCK_ATOL, rtol=0)


def test_slot_prefill_through_cache_rows_equals_the_batched_row(run):
    """One row prefilled alone into ``cache_rows`` of a two-row cache
    gives that row's logits and cache leaves of a batched prefill, and
    leaves the other row untouched."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model_zoo import build_model

    cfg = port_config()
    model = build_model(cfg)
    params = port_params(run)
    frames, tokens = t(run["frames"]), t(run["tokens"][:, :S]).long()
    with torch.no_grad():
        batched = model.init_cache(B, CACHE_LEN, dtype=torch.float32,
                                   device="cpu")
        lb, _ = model.prefill(params, batched, tokens=tokens, frames=frames)
        slotted = model.init_cache(B, CACHE_LEN, dtype=torch.float32,
                                   device="cpu")
        rows = tfm.cache_rows(slotted, slice(1, 2))
        ls, _ = model.prefill(params, rows, tokens=tokens[1:2],
                              frames=frames[1:2])
    np.testing.assert_allclose(ls[0].numpy(), lb[1].numpy(),
                               atol=BLOCK_ATOL, rtol=0)
    got, want = [], []
    tfm.tree_map(got.append, slotted)
    tfm.tree_map(want.append, batched)
    for a, b in zip(got, want):  # body leaves: (n_periods, B, ...)
        np.testing.assert_allclose(a[:, 1].numpy(), b[:, 1].numpy(),
                                   atol=BLOCK_ATOL, rtol=0)
        empty = -1 if a.dtype == torch.int32 else 0
        assert bool((a[:, 0] == empty).all())


def test_frames_of_the_wrong_length_are_refused(run):
    from repro_torch.models.model_zoo import build_model

    cfg = port_config()
    model = build_model(cfg)
    params = port_params(run)
    tokens = t(run["tokens"][:, :S]).long()
    cache = model.init_cache(B, CACHE_LEN, device="cpu")
    for frames in (torch.zeros(B, cfg.n_audio_frames - 1, cfg.d_model),
                   torch.zeros(B, cfg.n_audio_frames + 1, cfg.d_model)):
        with pytest.raises(ValueError, match=r"frames must be \(B, 8, 64\)"):
            model.prefill(params, cache, tokens=tokens, frames=frames)
    with pytest.raises(ValueError, match="takes frames"):
        model.prefill(params, cache, tokens=tokens)


def test_prefill_attention_goes_through_the_flash_wrapper(run, monkeypatch):
    """A prefill launches the wrapper three times a layer pair: the
    encoder's self-attention without a mask over the 8 frames, the
    decoder's causal self-attention, and its cross-attention without a
    mask over the 8 encoder keys; a decode step launches nothing."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.model_zoo import build_model

    calls = []
    wrapped = fa_ops.flash_attention

    def spy(q, k, v, **kwargs):
        calls.append((q.shape[1], k.shape[1], kwargs["causal"]))
        return wrapped(q, k, v, **kwargs)

    monkeypatch.setattr(fa_ops, "flash_attention", spy)
    model = build_model(port_config())
    params = port_params(run)
    with torch.no_grad():
        cache = model.init_cache(B, CACHE_LEN, device="cpu")
        model.prefill(params, cache, tokens=t(run["tokens"][:, :12]).long(),
                      frames=t(run["frames"]))
        assert calls == [(8, 8, False), (12, 12, True), (12, 8, False)]
        model.decode_step(params, t(run["tokens"][:, 12:13]).long(),
                          torch.full((B,), 12), cache)
    assert len(calls) == 3


# ------------------------------------------------------------- serving
def test_slot_server_refuses_an_encoder_decoder(run, capsys):
    """The port's ``SlotServer`` refuses whisper with a ``ValueError``
    naming the model API it is driven by; ``serve.py --arch
    whisper-small`` ends in that message, before any weight is drawn."""
    from repro_torch.launch import serve
    from repro_torch.models.model_zoo import build_model

    with pytest.raises(ValueError, match=r"passes no frames.*"
                                         r"Model.prefill\(params, cache, "
                                         r"tokens=, frames=\)"):
        serve.SlotServer(build_model(port_config()), port_params(run),
                         n_slots=2, max_len=32)
    with pytest.raises(SystemExit, match="whisper-small is an "
                                         "encoder-decoder"):
        serve.main(["--arch", ARCH, "--device", "cpu"])


def test_reference_slot_server_cannot_serve_whisper(run):
    """The JAX package's ``SlotServer`` prefills a slot with tokens alone
    (``repro/launch/serve.py``), so its encoder meets ``frames=None``
    (ROADMAP.md section 3); the port serves whisper through the model
    API. Only the JAX package runs here."""
    import jax
    import jax.numpy as jnp

    from repro.launch.serve import Request, SlotServer
    from repro.models.model_zoo import build_model

    params = jax.tree_util.tree_map(jnp.asarray, run["params"])
    server = SlotServer(build_model(jax_config()), params, n_slots=2,
                        max_len=32)
    with pytest.raises(AttributeError, match="'NoneType' object has no "
                                             "attribute 'astype'"):
        server.serve([Request(rid=0, prompt=run["tokens"][0, :4],
                              max_new=2)])


# ------------------------------------------------------ checkpoint format
def test_lm_params_reads_a_checkpoint_the_reference_wrote(run, tmp_path):
    """A ``step_<n>.npz`` of the small whisper, written by the
    reference's ``CheckpointManager``, holds the encoder stack,
    ``pos_embed``, ``norm_x`` and ``xattn`` under their paths and reads
    into the port's tree."""
    import jax

    from repro.checkpointing.manager import CheckpointManager
    from repro_torch.models.params import lm_params

    CheckpointManager(tmp_path, async_save=False).save(3, run["params"])
    with np.load(tmp_path / "step_3.npz") as z:
        flat = {k: z[k] for k in z.files}
    for key in ("encoder/attn/wq/w", "encoder/mlp/in/b", "enc_norm/bias",
                "pos_embed/table", "body/0/norm_x/scale",
                "body/0/xattn/wk/w"):
        assert key in flat, key
    got = lm_params(flat, port_config(), device="cpu")
    want = port_params(run)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert torch.equal(a, b)


# ------------------------------------------------------------ golden file
def golden_payload(run):
    from repro.common.tree import tree_flatten_with_paths

    return {
        "config": np.asarray(json.dumps(dataclasses.asdict(run["cfg"]))),
        **{f"params/{p}": leaf
           for p, leaf in tree_flatten_with_paths(run["params"])},
        "frames": run["frames"],
        "enc_out": run["enc_out"],
        "prefill/tokens": run["tokens"][:, :S],
        "prefill/logits": run["prefill"],
        "cache_len": np.asarray(CACHE_LEN),
        "cache_dtype": np.asarray(CACHE_DTYPE),
        "decode/tokens": run["tokens"][:, S:].T.copy(),
        "decode/logits": run["decode"],
        "greedy/tokens": run["greedy"],
    }


def write(path: Path = GOLDEN) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **golden_payload(jax_case()))
    print(f"wrote {path} ({path.stat().st_size} bytes)")


def test_golden_file_is_small():
    assert GOLDEN.stat().st_size < 500_000


def test_golden_is_fresh(run):
    """The stored entries are those the recipe gives now: configuration,
    inputs, parameters (an XLA build on another CPU may round a last bit
    differently), the JAX outputs and the greedy tokens."""
    import jax

    from repro_torch.models.params import load_whisper_golden, restore

    golden = load_whisper_golden(GOLDEN)
    fresh = golden_payload(run)
    assert set(np.load(GOLDEN).files) == set(fresh)
    assert dataclasses.asdict(golden.config) == dataclasses.asdict(
        run["cfg"])
    np.testing.assert_array_equal(golden.frames, run["frames"])
    np.testing.assert_array_equal(golden.prefill_tokens,
                                  run["tokens"][:, :S])
    np.testing.assert_array_equal(golden.decode_tokens,
                                  run["tokens"][:, S:].T)
    assert (golden.cache_len, golden.cache_dtype) == (CACHE_LEN,
                                                      CACHE_DTYPE)
    expect = restore({k[len("params/"):]: v for k, v in fresh.items()
                      if k.startswith("params/")}, golden.config)
    for a, b in zip(jax.tree_util.tree_leaves(golden.params),
                    jax.tree_util.tree_leaves(expect)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7,
                                   rtol=1e-6)
    for got, want in ((golden.enc_out, run["enc_out"]),
                      (golden.prefill_logits, run["prefill"]),
                      (golden.decode_logits, run["decode"])):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(golden.greedy_tokens, run["greedy"])


def test_port_on_cpu_matches_golden():
    """What ``chip_smoke.py`` holds the card to (its own helper), on the
    CPU."""
    from test_torch_train import chip_smoke

    from repro_torch.models.params import load_whisper_golden

    out = chip_smoke().whisper_golden_errors(load_whisper_golden(GOLDEN),
                                             device="cpu")
    assert out["finite"] and out["greedy_equal"]
    assert max([out["encoder"], out["prefill"]] + out["decode"]) <= ATOL


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_whisper.py --write")
    write()
