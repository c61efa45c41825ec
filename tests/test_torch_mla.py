"""DeepSeek-V2-Lite's Multi-head Latent Attention (MLA) in the port
against the JAX package, and the golden file of the small DeepSeek and
the small Qwen2-VL for the card.

- The flash kernel's plain version with a value head dim unlike the
  query's (q/k 16 + 8 wide, v 16 in the small model; 192 and 128 at full
  width) against the reference's ``attend_full``.
- ``mla_block`` in train, prefill and decode mode (the absorbed decode)
  against ``repro.models.attention.mla_block`` on the reference's
  ``mla_init`` parameters, caches included.
- The small DeepSeek, ``deepseek-v2-lite-16b`` ``scaled_down(dtype=
  "float32")`` (a dense MLA layer, then an MLA layer with an MoE of 4
  experts top-2 and shared experts) with the JAX package's
  ``Model.init(PRNGKey(0))`` parameters: the no-cache forward over 19
  tokens, the prefill of 16 tokens and three decode steps (float32
  caches) and the tokens the JAX ``SlotServer`` serves five requests
  (4 slots, ``max_len`` 64, ``max_new`` 8). The JAX outputs of an arch
  are computed once a module (one eager init and one set of compiles)
  and shared by its tests, the golden file's freshness test included.
- The reference's own fault: its Pallas route sizes v and the output by
  the query's head dim and cannot run MLA (ROADMAP.md section 3); the
  test that pins it runs only the JAX package.

``src/repro_torch/assets/lm_zoo_mla_mrope_small_golden.npz`` holds, for
both archs under the prefix ``<arch>/``, the keys of
``tests/test_torch_lm_zoo.py``'s file; Qwen2-VL's also ``embeddings/*``:
a prefill of seeded embeddings with (3, B, S) M-RoPE positions whose
rows differ (an image between two runs of text) and its JAX logits,
through the reference's Pallas route, which masks by index as the port's
kernel does (``tests/test_torch_mrope.py``).
Regenerate it (about 20 s on a CPU) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_mla.py --write
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_golden import (B, CACHE_LEN, DECODE_STEPS,  # noqa: E402
                                  MAX_LEN, MAX_NEW, S, SLOTS, Jitted,
                                  check_port_on_cpu, jax_outputs)

ASSETS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "assets"
GOLDEN = ASSETS / "lm_zoo_mla_mrope_small_golden.npz"

SEED = 0
ATOL = 1e-4  # float32 on both sides, summed in different orders
FLASH_ATOL = 2e-5  # the reference's float32 kernel tolerance
BLOCK_ATOL = 1e-5  # one attention block, float32 on both sides
CACHE_DTYPE = "float32"
# the served prompts: two lengths (one JAX prefill compile each), a fifth
# request that waits for a slot
PROMPT_LENGTHS = (16, 9, 9, 16, 16)
MLA = "deepseek-v2-lite-16b"
VL = "qwen2-vl-7b"
ARCHS = (MLA, VL)
# Qwen2-VL's embeddings prefill: row b has TEXT_BEFORE[b] text tokens,
# one image of a VL_GRID patch grid merged 2 x 2, then text to S tokens
TEXT_BEFORE = (2, 5)
VL_GRID = (4, 6)


def jax_config(arch):
    from repro.configs import get_config

    return get_config(arch).scaled_down(dtype="float32")


def port_config(arch):
    from repro_torch.configs import get_config

    return get_config(arch).scaled_down(dtype="float32")


def inputs(arch):
    """(tokens (B, S + DECODE_STEPS), prompts) of an arch."""
    rng = np.random.default_rng(SEED + ARCHS.index(arch))
    vocab = jax_config(arch).vocab_size
    tokens = rng.integers(0, vocab, (B, S + DECODE_STEPS)).astype(np.int32)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in PROMPT_LENGTHS]
    return tokens, prompts


def vl_positions(n_before, grid, length, merge=2):
    """(3, length) M-RoPE positions, as Qwen2-VL's ``get_rope_index``
    lays them out: ``n_before`` text tokens at 0.. on all three rows, one
    image of ``grid`` (h, w) patches merged ``merge`` x ``merge`` (t
    fixed at ``n_before``, h and w along the merged grid from there),
    then text from the largest position + 1."""
    h, w = grid[0] // merge, grid[1] // merge
    text = np.broadcast_to(np.arange(n_before), (3, n_before))
    hh, ww = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    image = n_before + np.stack([np.zeros(h * w, np.int64), hh.ravel(),
                                 ww.ravel()])
    after = n_before + max(h, w) + np.arange(length - n_before - h * w)
    return np.concatenate([text, image, np.broadcast_to(
        after, (3, len(after)))], 1).astype(np.int32)


def vl_inputs(d_model):
    """(embeddings (B, S, d_model), positions (3, B, S)) of Qwen2-VL's
    embeddings prefill; the rows of each batch row's positions differ."""
    rng = np.random.default_rng(SEED + 7)
    emb = rng.standard_normal((B, S, d_model)).astype(np.float32)
    pos = np.stack([vl_positions(n, VL_GRID, S) for n in TEXT_BEFORE], 1)
    return emb, pos


def jax_case(arch):
    """The JAX package's parameters (numpy) and outputs for one arch."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as jtfm
    from repro.models.model_zoo import build_model

    cfg = jax_config(arch)
    # eager: compiling the whole init costs more than it saves here
    params = build_model(cfg).init(jax.random.PRNGKey(SEED))
    tokens, prompts = inputs(arch)
    forward = jax.jit(lambda p, t: jtfm.forward(p, cfg, tokens=t)[0])
    out = jax_outputs(cfg, params, tokens, prompts, max_len=MAX_LEN,
                      cache_dtype=CACHE_DTYPE)
    out.update(cfg=cfg, tokens=tokens, prompts=prompts,
               forward=np.asarray(forward(params, jnp.asarray(tokens))))
    if cfg.rope_style == "mrope":
        # the embeddings through the Pallas route (interpret mode), which
        # masks by index as the port's kernel (and Qwen2-VL) do; the
        # default route masks by the positions' values, which repeat in
        # an image (ROADMAP.md section 3)
        emb, pos = vl_inputs(cfg.d_model)
        pallas = dataclasses.replace(cfg, attn_impl="pallas")
        model = Jitted(build_model(pallas))
        cache = model.init_cache(B, CACHE_LEN, dtype=jnp.float32)
        logits, cache = model.prefill(params, cache,
                                      embeddings=jnp.asarray(emb),
                                      positions=jnp.asarray(pos))
        out.update(embeddings=emb, positions=pos,
                   emb_prefill=np.asarray(logits, np.float32),
                   emb_cache=jax.tree_util.tree_map(np.asarray, cache))
        for name, c in (("emb_forward", pallas), ("emb_forward_default", cfg)):
            fwd = jax.jit(lambda p, e, q, c=c: jtfm.forward(
                p, c, embeddings=e, positions=q)[0])
            out[name] = np.asarray(fwd(params, jnp.asarray(emb),
                                       jnp.asarray(pos)))
    out["params"] = jax.tree_util.tree_map(np.asarray, params)
    return out


def port_params(run, arch):
    from repro_torch.models.params import lm_params

    return lm_params(run["params"], port_config(arch), device="cpu")


@pytest.fixture(scope="module")
def deepseek():
    """The JAX outputs of the small DeepSeek, computed once."""
    return jax_case(MLA)


# ----------------------------------------------------- flash, v narrower
@pytest.mark.parametrize("Bq,H,KH,Sq,D,DV", [
    (2, 4, 4, 33, 24, 16), (1, 4, 2, 70, 192, 128), (2, 6, 3, 17, 24, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_with_a_narrower_v_matches_attend_full(Bq, H, KH, Sq, D,
                                                           DV, causal):
    """The plain version (through the wrapper, in the model's layout) with
    v's head dim below q's, against the reference's materialized-scores
    attention; the output takes v's head dim and the scale stays 1/sqrt(D)
    (the reference's Pallas oracle reshapes the output to D and cannot
    run this)."""
    import jax
    import jax.numpy as jnp

    from repro.models import attention as jattn
    from repro_torch.kernels.flash_attention import ops

    rng = np.random.default_rng(11)
    q = rng.standard_normal((Bq, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((Bq, Sq, KH, D)).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, KH, DV)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sq), (Bq, Sq))
    scale = 1.0 / np.sqrt(D)
    attend = jax.jit(jattn.attend_full,
                     static_argnames=("causal", "window", "scale"))
    expect = attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(pos), jnp.asarray(pos), causal=causal,
                    window=0, scale=scale)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    assert got.shape == (Bq, Sq, H, DV)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                               atol=FLASH_ATOL, rtol=FLASH_ATOL)


def test_wrapper_takes_the_mla_pairs_and_refuses_the_rest():
    """(192, 128) on both routes, (24, 16) on the float32 route only: the
    bfloat16 route refuses it naming the pair; a v that does not match
    k's (B, T, KH) is refused."""
    from repro_torch.kernels.flash_attention import ops

    def inputs(D, DV, dtype=torch.float32):
        return (torch.zeros(1, 8, 4, D, dtype=dtype),
                torch.zeros(1, 8, 2, D, dtype=dtype),
                torch.zeros(1, 8, 2, DV, dtype=dtype))

    for dtype in ops.DTYPES:
        ops._check(*inputs(192, 128, dtype), 0)
    ops._check(*inputs(24, 16), 0)
    assert ops.route(torch.float32, 24, 16) == "cuda_core"
    assert ops.route(torch.bfloat16, 192, 128) == "tensor_core"
    with pytest.raises(ValueError, match=r"\(24, 16\)"):
        ops._check(*inputs(24, 16, torch.bfloat16), 0)
    with pytest.raises(ValueError, match=r"\(192, 64\)"):
        ops.route(torch.float32, 192, 64)
    q, k, v = inputs(192, 128)
    with pytest.raises(ValueError, match="does not match k"):
        ops._check(q, k, v[:, :, :1], 0)


# --------------------------------------------------------- the MLA block
def _mla_block_pair(jparams, mode, cache_len=24, S_in=12, seed=5):
    """(JAX output, JAX cache, port output, port cache) of one block on
    the reference's ``mla_init`` parameters ``jparams`` (numpy)."""
    import functools

    import jax
    import jax.numpy as jnp

    from repro.models import attention as jattn
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm

    jcfg, cfg = jax_config(MLA), port_config(MLA)
    params = tfm.tree_map(torch.from_numpy, jparams)
    block = jax.jit(functools.partial(jattn.mla_block, jparams, jcfg),
                    static_argnames="mode")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S_in, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S_in), (2, S_in)).astype(np.int32)
    if mode == "train":
        jout, _ = block(jnp.asarray(x), jnp.asarray(pos))
        out, _ = attn.mla_block(params, cfg, torch.from_numpy(x),
                                torch.from_numpy(pos).long())
        return np.asarray(jout), None, out.numpy(), None
    jcache = jattn.init_mla_cache(jcfg, 2, cache_len, dtype=jnp.float32)
    cache = attn.init_mla_cache(cfg, 2, cache_len, dtype=torch.float32)
    jout, jcache = block(jnp.asarray(x), jnp.asarray(pos), mode="prefill",
                         cache=jcache)
    out, cache = attn.mla_block(params, cfg, torch.from_numpy(x),
                                torch.from_numpy(pos).long(),
                                mode="prefill", cache=cache)
    if mode == "decode":  # two steps after the prefill
        for i in range(2):
            xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
            pd = np.full((2, 1), S_in + i, np.int32)
            jout, jcache = block(jnp.asarray(xd), jnp.asarray(pd),
                                 mode="decode", cache=jcache)
            out, cache = attn.mla_block(params, cfg, torch.from_numpy(xd),
                                        torch.from_numpy(pd).long(),
                                        mode="decode", cache=cache)
    return (np.asarray(jout), {k: np.asarray(v) for k, v in jcache.items()},
            out.numpy(), {k: v.numpy() for k, v in cache.items()})


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mla_block_matches_jax(deepseek, mode):
    """Output and cache of one MLA block on the reference's parameters
    (the small DeepSeek's first layer): the no-cache forward, a prefill
    of 12 tokens into a 24-slot cache, and two absorbed decode steps
    after it (the latent and rotary key at index p, the position at p,
    -1 elsewhere)."""
    jout, jcache, out, cache = _mla_block_pair(
        deepseek["params"]["head"][0]["attn"], mode)
    assert out.shape == jout.shape
    np.testing.assert_allclose(out, jout, atol=BLOCK_ATOL, rtol=0)
    if jcache is not None:
        assert cache.keys() == jcache.keys()
        for name in cache:
            np.testing.assert_allclose(cache[name], jcache[name],
                                       atol=BLOCK_ATOL, rtol=0)


# ------------------------------------------------------------ configuration
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    full, ref = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref)
    assert full.layer_kinds == ref.layer_kinds
    assert (dataclasses.asdict(full.scaled_down(dtype="float32"))
            == dataclasses.asdict(ref.scaled_down(dtype="float32")))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference_layout(arch):
    """Seeded init keeps the reference's paths and shapes (the MLA leaves,
    Qwen2-VL's biases); the leaves read in float32 stay float32."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models.model_zoo import build_model as jax_build
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import F32_LEAVES

    params = build_model(get_config(arch).scaled_down()).init(
        0, device="cpu")  # bfloat16
    shapes = jax_build(jax_get_config(arch).scaled_down()).abstract_params()
    ref = jax.tree_util.tree_flatten_with_path(shapes)
    ours = jax.tree_util.tree_flatten_with_path(params)
    assert (jax.tree_util.tree_structure(shapes)
            == jax.tree_util.tree_structure(params))
    for (path, sds), (_, t) in zip(ref[0], ours[0]):
        assert tuple(t.shape) == sds.shape, path
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        f32 = any(name.endswith(end) for end in F32_LEAVES)
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), name
    if arch == MLA:
        assert sorted(params["head"][0]["attn"]) == [
            "kv_norm", "w_dkv", "w_uk", "w_uv", "wo", "wq"]


# ------------------------------------------------------- parity with JAX
def test_forward_matches_jax(deepseek):
    from repro_torch.models import transformer as tfm

    with torch.no_grad():
        logits, _, _ = tfm.forward(port_params(deepseek, MLA),
                                   port_config(MLA),
                                   tokens=torch.from_numpy(deepseek["tokens"]))
    np.testing.assert_allclose(logits.numpy(), deepseek["forward"],
                               atol=ATOL, rtol=0)


def check_prefill_and_decode(run, arch):
    """Prefill of 16 tokens and three decode steps, float32 caches on
    both sides, against JAX's logits."""
    from repro_torch.models.model_zoo import build_model

    model = build_model(port_config(arch))
    params = port_params(run, arch)
    tokens = torch.from_numpy(run["tokens"])
    with torch.no_grad():
        cache = model.init_cache(B, CACHE_LEN, dtype=torch.float32,
                                 device="cpu")
        lp, cache = model.prefill(params, cache, tokens=tokens[:, :S])
        np.testing.assert_allclose(lp.numpy(), run["prefill"], atol=ATOL,
                                   rtol=0)
        for i in range(DECODE_STEPS):
            ld, cache = model.decode_step(params, tokens[:, S + i:S + i + 1],
                                          torch.full((B,), S + i), cache)
            np.testing.assert_allclose(ld.numpy(), run["decode"][i],
                                       atol=ATOL, rtol=0)


def test_prefill_and_decode_match_jax(deepseek):
    check_prefill_and_decode(deepseek, MLA)


def check_served_tokens(run, arch):
    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.models.model_zoo import build_model

    server = SlotServer(build_model(port_config(arch)),
                        port_params(run, arch), n_slots=SLOTS,
                        max_len=MAX_LEN)
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(run["prompts"])]
    done = {r.rid: r.tokens for r in server.serve(reqs)["completed"]}
    assert [done[i] for i in range(len(reqs))] == run["served"]


def test_slot_server_tokens_match_jax(deepseek):
    check_served_tokens(deepseek, MLA)


def test_prefill_attention_goes_through_the_flash_wrapper(monkeypatch):
    """Every MLA layer of a prefill and of the no-cache forward calls the
    kernel wrapper once, with q/k 16 + 8 wide and v 16 wide at the scale
    1/sqrt(24); decode does not."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model_zoo import build_model

    calls = []
    wrapped = fa_ops.flash_attention

    def spy(q, k, v, **kwargs):
        calls.append((q.shape[-1], k.shape[-1], v.shape[-1],
                      kwargs["scale"]))
        return wrapped(q, k, v, **kwargs)

    monkeypatch.setattr(fa_ops, "flash_attention", spy)
    cfg = port_config(MLA)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    one = [(24, 24, 16, 1.0 / np.sqrt(24))] * cfg.n_layers
    toks = torch.arange(12)[None] % cfg.vocab_size
    with torch.no_grad():
        cache = model.init_cache(1, 24, device="cpu")
        model.prefill(params, cache, tokens=toks)
        assert calls == one
        model.decode_step(params, toks[:, :1], torch.tensor([12]), cache)
        assert calls == one
        tfm.forward(params, cfg, tokens=toks)
    assert calls == 2 * one


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_serves_small_on_cpu(arch, capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--scale", "small", "--device", "cpu",
                      "--requests", "3", "--max-new", "3", "--slots", "2",
                      "--max-len", "32"])
    assert len(out["completed"]) == 3
    assert all(len(r.tokens) == 3 for r in out["completed"])
    assert f"{arch} (small) on cpu" in capsys.readouterr().out


# ------------------------------------------------- the reference's fault
def test_reference_pallas_route_cannot_run_mla(deepseek):
    """The JAX package's Pallas flash route sizes v's block and the
    output by q's head dim (``repro/kernels/flash_attention/kernel.py``),
    so its forward of the small DeepSeek with ``attn_impl="pallas"``
    fails where the MLA block reshapes that output (ROADMAP.md section
    3); the port holds MLA to the reference's default route. Only the
    JAX package runs here."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as jtfm

    cfg = dataclasses.replace(jax_config(MLA), attn_impl="pallas")
    params = jax.tree_util.tree_map(jnp.asarray, deepseek["params"])
    with pytest.raises(TypeError, match="cannot reshape"):
        jtfm.forward(params, cfg,
                     tokens=jnp.asarray(deepseek["tokens"][:1, :8]))


# ------------------------------------------------------ checkpoint format
def test_lm_params_reads_a_checkpoint_the_reference_wrote(deepseek,
                                                          tmp_path):
    """A ``step_<n>.npz`` of the small DeepSeek, written by the
    reference's ``CheckpointManager``, holds the MLA leaves under their
    paths and reads into the port's tree."""
    import jax

    from repro.checkpointing.manager import CheckpointManager
    from repro_torch.models.params import lm_params

    CheckpointManager(tmp_path, async_save=False).save(3, deepseek["params"])
    with np.load(tmp_path / "step_3.npz") as z:
        flat = {k: z[k] for k in z.files}
    for leaf in ("wq", "w_dkv", "kv_norm/scale", "w_uk", "w_uv", "wo"):
        assert any(k.startswith(f"body/0/attn/{leaf}") for k in flat), leaf
    cfg = port_config(MLA)
    got = lm_params(flat, cfg, device="cpu")
    want = port_params(deepseek, MLA)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert torch.equal(a, b)


# ------------------------------------------------------------ golden file
def golden_payload(arch, run):
    """The golden file's entries of one arch, under ``<arch>/``."""
    from repro.common.tree import tree_flatten_with_paths

    cfg, prompts = run["cfg"], run["prompts"]
    entries = {
        "config": np.asarray(json.dumps(dataclasses.asdict(cfg))),
        **{f"params/{p}": leaf
           for p, leaf in tree_flatten_with_paths(run["params"])},
        "prefill/tokens": run["tokens"][:, :S],
        "prefill/logits": run["prefill"],
        "cache_len": np.asarray(CACHE_LEN),
        "cache_dtype": np.asarray(CACHE_DTYPE),
        "decode/tokens": run["tokens"][:, S:].T.copy(),
        "decode/logits": run["decode"],
        "serve/prompt_lengths": np.asarray([len(p) for p in prompts]),
        "serve/prompts": np.concatenate(prompts),
        "serve/max_new": np.asarray(MAX_NEW),
        "serve/slots": np.asarray(SLOTS),
        "serve/max_len": np.asarray(MAX_LEN),
        "serve/token_counts": np.asarray([len(t) for t in run["served"]]),
        "serve/tokens": np.concatenate(run["served"]).astype(np.int32),
    }
    if "embeddings" in run:
        entries.update({"embeddings/inputs": run["embeddings"],
                        "embeddings/positions": run["positions"],
                        "embeddings/logits": run["emb_prefill"],
                        "embeddings/cache_len": np.asarray(CACHE_LEN)})
    return {f"{arch}/{k}": v for k, v in entries.items()}


def write(path: Path = GOLDEN) -> None:
    payload = {}
    for arch in ARCHS:
        payload.update(golden_payload(arch, jax_case(arch)))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **payload)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


def load(arch):
    from repro_torch.models.params import load_lm_golden

    return load_lm_golden(GOLDEN, prefix=f"{arch}/")


def check_fresh(arch, run):
    """The stored entries of ``arch`` are those the recipe gives now:
    configuration, inputs, parameters (an XLA build on another CPU may
    round a last bit differently) and the JAX outputs."""
    import jax

    from repro_torch.models.params import restore

    golden = load(arch)
    stored = dict(np.load(GOLDEN))
    assert dataclasses.asdict(golden.config) == dataclasses.asdict(
        run["cfg"])
    np.testing.assert_array_equal(golden.prefill_tokens,
                                  run["tokens"][:, :S])
    np.testing.assert_array_equal(golden.decode_tokens,
                                  run["tokens"][:, S:].T)
    assert [p.tolist() for p in golden.prompts] == \
        [p.tolist() for p in run["prompts"]]
    assert (golden.cache_dtype, golden.max_len, golden.slots,
            golden.max_new) == (CACHE_DTYPE, MAX_LEN, SLOTS, MAX_NEW)
    fresh = golden_payload(arch, run)
    assert {k for k in stored if k.startswith(f"{arch}/")} == set(fresh)
    expect = restore({k[len(f"{arch}/params/"):]: v for k, v in fresh.items()
                      if k.startswith(f"{arch}/params/")}, golden.config)
    for a, b in zip(jax.tree_util.tree_leaves(golden.params),
                    jax.tree_util.tree_leaves(expect)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7,
                                   rtol=1e-6)
    np.testing.assert_allclose(golden.prefill_logits, run["prefill"],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(golden.decode_logits, run["decode"],
                               atol=ATOL, rtol=0)
    assert golden.served == run["served"]
    if "embeddings" in run:
        e = golden.embeddings
        np.testing.assert_array_equal(e["inputs"], run["embeddings"])
        np.testing.assert_array_equal(e["positions"], run["positions"])
        np.testing.assert_allclose(e["logits"], run["emb_prefill"],
                                   atol=ATOL, rtol=0)
    else:
        assert golden.embeddings is None


def test_golden_file_is_small():
    assert GOLDEN.stat().st_size < 1_500_000


def test_golden_is_fresh(deepseek):
    check_fresh(MLA, deepseek)


def test_port_on_cpu_matches_golden():
    """What ``chip_smoke.py`` holds the card to, on the CPU."""
    check_port_on_cpu(load(MLA), ATOL)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_mla.py --write")
    write()
