"""The xLSTM slice of the port: configuration, parameter and cache
layout, the mLSTM and sLSTM blocks (prefill and decode), the whole small
xLSTM (forward, prefill, decode, served tokens) against the JAX package
on the same parameters, and decode after prefill against the port's own
no-cache forward."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.launch.serve import SlotServer as JaxSlotServer  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model_zoo import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.mlstm import ops as mlstm_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.params import cast_params, lm_params  # noqa: E402

ARCH = "xlstm-1.3b"
# one block, float32 on both sides, summed in different orders
BLOCK_ATOL = 1e-4
# Whole model, float32 on both sides. Eight random-weight xLSTM blocks
# grow rounding about tenfold (layer by layer at S = 21: 1.5e-6 after the
# first block, 2.8e-5 at the last, on a residual stream up to 8.5), and
# the logits reach 45, so the two packages differ by up to 1.0e-4 at
# S <= 21 (measured); the reference's own two mLSTM routes differ by up
# to 6.1e-5 there. Held at 2e-4.
MODEL_ATOL = 2e-4
B, S, STEPS = 2, 16, 3
LONG = 21  # the no-cache forward's length: one run serves every S <= 20
SELF_S = (21, 256, 300, 512)  # decode after prefill vs the port's forward
# float32 logits of either package vs the port's float64 evaluation at
# these lengths: twice the largest error measured for either (7.5e-4)
F64_S = (256, 300, 512)
F64_ATOL = 1.5e-3


def jax_config():
    return jax_get_config(ARCH).scaled_down(dtype="float32")


def port_cfg():
    return get_config(ARCH).scaled_down(dtype="float32")


def flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.fixture(scope="module")
def lm():
    """JAX parameters and outputs, computed once: the forward over LONG
    tokens for both mLSTM routes, prefill + decode with float32 caches,
    and the tokens the JAX SlotServer serves three prompts of 8."""
    cfg = jax_config()
    model = jax_build(cfg)
    jp = jax.jit(model.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, LONG)).astype(np.int32)
    out = {"jp": jp, "tokens": tokens, "forward": {}}
    for impl in ("reference", "pallas"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        fwd = jax.jit(lambda p, t, c=c: jtfm.forward(p, c, tokens=t)[0])
        out["forward"][impl] = np.asarray(fwd(jp, jnp.asarray(tokens)))
    prefill, decode = jax.jit(model.prefill), jax.jit(model.decode_step)
    cache = model.init_cache(B, S + STEPS, dtype=jnp.float32)
    lp, cache = prefill(jp, cache, tokens=jnp.asarray(tokens[:, :S]))
    dec = []
    for i in range(STEPS):
        ld, cache = decode(jp, jnp.asarray(tokens[:, S + i:S + i + 1]),
                           jnp.full((B,), S + i, jnp.int32), cache)
        dec.append(np.asarray(ld))
    out["prefill"], out["decode"] = np.asarray(lp), np.stack(dec)
    prompts = [rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
               for _ in range(3)]
    server = JaxSlotServer(model, jp, n_slots=2, max_len=24)
    done = {r.rid: r.tokens for r in server.serve(
        [JaxRequest(rid=i, prompt=p, max_new=5)
         for i, p in enumerate(prompts)])["completed"]}
    out["prompts"] = prompts
    out["served"] = [done[i] for i in range(len(prompts))]
    out["params"] = lm_params(jax.tree_util.tree_map(np.asarray, jp),
                              port_cfg(), device="cpu")
    return out


# ------------------------------------------------------------ configuration
def test_config_matches_reference():
    full, ref = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref)
    assert full.layer_kinds == ref.layer_kinds
    assert full.layer_kinds.count("mlstm") == 42
    assert full.layer_kinds.count("slstm") == 6
    assert (dataclasses.asdict(full.scaled_down(max_seq=128))
            == dataclasses.asdict(ref.scaled_down(max_seq=128)))


# --------------------------------------------------------- parameter layout
def test_param_tree_matches_reference_layout():
    """Seeded init keeps the reference's paths and shapes (block-diagonal
    {"w": (n_periods, H, hd, hd), "b"}, conv, hnorm, the sLSTM's geglu
    with d_ff = 4 d // 3); norm scales stay float32, the rest is in the
    compute type."""
    cfg = get_config(ARCH).scaled_down()  # bfloat16
    params = build_model(cfg).init(0, device="cpu")
    shapes = jax_build(jax_get_config(ARCH).scaled_down()).abstract_params()
    ref, ours = flat(shapes), flat(tfm.tree_map(lambda t: t, params))
    assert ref.keys() == ours.keys()
    for path, sds in ref.items():
        assert tuple(ours[path].shape) == sds.shape, path
        f32 = str(path[-1].key) == "scale"
        assert ours[path].dtype == (torch.float32 if f32
                                    else torch.bfloat16), path
    mix = params["body"][0]["mix"]
    assert tuple(mix["wq"]["w"].shape) == (1, 4, 32, 32)
    assert "norm2" not in params["body"][0] and "mlp" not in params["body"][7]
    assert tuple(params["body"][7]["mix"]["ffn"]["wo"].shape) == (1, 85, 64)


def test_full_width_parameter_count():
    shapes = jax_build(jax_get_config(ARCH)).abstract_params()
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert n == 1_918_085_120


def test_lm_params_reads_nested_and_flat_forms(lm):
    from repro.common.tree import tree_flatten_with_paths

    source = dict(tree_flatten_with_paths(
        jax.tree_util.tree_map(np.asarray, lm["jp"])))
    a = flat(lm_params(source, port_cfg(), device="cpu"))
    b = flat(lm["params"])
    assert a.keys() == b.keys() == flat(lm["jp"]).keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    for path, leaf in flat(lm["jp"]).items():
        np.testing.assert_array_equal(b[path].numpy(), np.asarray(leaf))


def test_cache_layout_matches_reference():
    """bfloat16 conv histories, float32 states (C, n, m) and (c, n, h,
    m), m starting at -1e30; batch axis 1 in the body."""
    ref = jax_build(jax_config()).init_cache(3, 40)
    ours = build_model(port_cfg()).init_cache(3, 40, device="cpu")
    a, b = flat(ref), flat(ours)
    assert a.keys() == b.keys()
    for path, arr in a.items():
        assert tuple(b[path].shape) == arr.shape, path
        assert str(b[path].dtype).split(".")[-1] == str(arr.dtype), path
        np.testing.assert_array_equal(b[path].float().numpy(),
                                      np.asarray(arr, np.float32))


# ------------------------------------------------------------ the blocks
def _block_params(lm, i):
    jp = jax.tree_util.tree_map(lambda a: a[0], lm["jp"]["body"][i]["mix"])
    tp = tfm.tree_map(lambda a: a[0], lm["params"]["body"][i]["mix"])
    return jp, tp


def _state_leaves(cache):
    return [np.asarray(x, np.float32)
            for x in jax.tree_util.tree_leaves(cache)]


@pytest.mark.parametrize("kind,index", [("mlstm", 0), ("slstm", 7)])
def test_block_prefill_and_decode_match_jax(lm, kind, index):
    """Prefill of 13 steps (the conv history and the state written into
    the cache in place), then three decode steps, float32 caches."""
    jcfg, cfg = jax_config(), port_cfg()
    jp, tp = _block_params(lm, index)
    jblock = jrec.mlstm_block if kind == "mlstm" else jrec.slstm_block
    block = rec.mlstm_block if kind == "mlstm" else rec.slstm_block
    jinit = jrec.init_mlstm_cache if kind == "mlstm" else jrec.init_slstm_cache
    init = rec.init_mlstm_cache if kind == "mlstm" else rec.init_slstm_cache
    x = np.random.default_rng(4).standard_normal((2, 16, 64)).astype(
        np.float32)
    jcache = jinit(jcfg, 2, dtype=jnp.float32)
    cache = init(cfg, 2, dtype=torch.float32)
    jy, jcache = jblock(jp, jcfg, jnp.asarray(x[:, :13]), mode="prefill",
                        cache=jcache)
    with torch.no_grad():
        y, same = block(tp, cfg, torch.from_numpy(x[:, :13]), mode="prefill",
                        cache=cache)
    assert same is cache
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=BLOCK_ATOL,
                               rtol=0)
    for t in range(13, 16):
        jy, jcache = jblock(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                            mode="decode", cache=jcache)
        with torch.no_grad():
            y, _ = block(tp, cfg, torch.from_numpy(x[:, t:t + 1]),
                         mode="decode", cache=cache)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                                   atol=BLOCK_ATOL, rtol=0)
    for a, e in zip(_state_leaves(tfm.tree_map(lambda t: t.numpy(), cache)),
                    _state_leaves(jcache)):
        np.testing.assert_allclose(a, e, atol=BLOCK_ATOL, rtol=BLOCK_ATOL)


def test_mlstm_step_matches_jax():
    rng = np.random.default_rng(5)
    Bq, H, hd = 3, 4, 32
    q, k, v = (rng.standard_normal((Bq, 1, H, hd)).astype(np.float32)
               for _ in range(3))
    li = rng.standard_normal((Bq, 1, H)).astype(np.float32)
    lf = -np.logaddexp(0.0, -rng.standard_normal((Bq, 1, H))).astype(
        np.float32)
    C = rng.standard_normal((Bq, H, hd, hd)).astype(np.float32)
    n = rng.standard_normal((Bq, H, hd)).astype(np.float32)
    m = rng.standard_normal((Bq, H)).astype(np.float32)
    m[0, 0] = -1e30  # a fresh row
    jh, jstate = jrec.mlstm_step(*(jnp.asarray(a) for a in (q, k, v, li, lf)),
                                 tuple(jnp.asarray(a) for a in (C, n, m)))
    h, state = rec.mlstm_step(*(torch.from_numpy(a)
                                for a in (q, k, v, li, lf)),
                              tuple(torch.from_numpy(a) for a in (C, n, m)))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=BLOCK_ATOL,
                               rtol=0)
    for a, e in zip(state, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=BLOCK_ATOL,
                                   rtol=0)


def test_short_prompt_conv_history_is_left_padded(lm):
    """A prompt shorter than conv1d_width - 1 leaves zeros before its
    first token in the conv history, so decode after it equals the
    no-cache forward."""
    cfg = port_cfg()
    model = build_model(cfg)
    toks = torch.from_numpy(lm["tokens"][:, :3]).long()
    with torch.no_grad():
        cache = model.init_cache(B, 8, dtype=torch.float32, device="cpu")
        model.prefill(lm["params"], cache, tokens=toks[:, :2])
        conv = cache["body"][0]["conv"][0].clone()  # period 0, (B, 3, 2 d)
        ld, _ = model.decode_step(lm["params"], toks[:, 2:3],
                                  torch.full((B,), 2), cache)
        full, _, _ = tfm.forward(lm["params"], cfg, tokens=toks)
    assert not conv[:, 0].any() and conv[:, 1:].abs().amax(-1).gt(0).all()
    np.testing.assert_allclose(ld.numpy(), full[:, 2].numpy(),
                               atol=MODEL_ATOL, rtol=0)


# -------------------------------------------------- the whole small model
@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_forward_matches_jax(lm, impl):
    with torch.no_grad():
        logits, _, _ = tfm.forward(lm["params"], port_cfg(),
                                   tokens=torch.from_numpy(lm["tokens"]).long())
    np.testing.assert_allclose(logits.numpy(), lm["forward"][impl],
                               atol=MODEL_ATOL, rtol=0)


def test_prefill_and_decode_match_jax(lm):
    """float32 caches on both sides."""
    model = build_model(port_cfg())
    tokens = lm["tokens"]
    with torch.no_grad():
        cache = model.init_cache(B, S + STEPS, dtype=torch.float32,
                                 device="cpu")
        lp, cache = model.prefill(lm["params"], cache,
                                  tokens=torch.from_numpy(tokens[:, :S]))
        np.testing.assert_allclose(lp.numpy(), lm["prefill"],
                                   atol=MODEL_ATOL, rtol=0)
        for i in range(STEPS):
            ld, cache = model.decode_step(
                lm["params"], torch.from_numpy(tokens[:, S + i:S + i + 1]),
                torch.full((B,), S + i), cache)
            np.testing.assert_allclose(ld.numpy(), lm["decode"][i],
                                       atol=MODEL_ATOL, rtol=0)


def test_slot_server_tokens_match_jax(lm):
    model = build_model(port_cfg())
    server = serve.SlotServer(model, lm["params"], n_slots=2, max_len=24)
    reqs = [serve.Request(rid=i, prompt=p, max_new=5)
            for i, p in enumerate(lm["prompts"])]
    done = {r.rid: r.tokens for r in server.serve(reqs)["completed"]}
    assert [done[i] for i in range(len(reqs))] == lm["served"]
    assert server.decode_tokens == sum(len(t) - 1 for t in done.values())


@pytest.fixture(scope="module")
def self_forward(lm):
    """The port's own no-cache forward over max(SELF_S) + 1 tokens."""
    rng = np.random.default_rng(6)
    long = torch.from_numpy(rng.integers(
        0, 256, (1, max(SELF_S) + 1)).astype(np.int64))
    with torch.no_grad():
        logits, _, _ = tfm.forward(lm["params"], port_cfg(), tokens=long)
    return long, logits


@pytest.mark.parametrize("S_", SELF_S)
def test_decode_after_prefill_matches_own_forward(lm, self_forward, S_):
    """Decode at position S after a prefill of S tokens (the mLSTM state
    handed from the chunkwise form, short last chunk included, to
    mlstm_step) equals the no-cache forward at S. The forward's chunks
    of 256 hold other stabilizers than a prefill of S rows; float32
    caches."""
    long, forward = self_forward
    model = build_model(port_cfg())
    with torch.no_grad():
        cache = model.init_cache(1, S_ + 4, dtype=torch.float32,
                                 device="cpu")
        lp, cache = model.prefill(lm["params"], cache, tokens=long[:, :S_])
        ld, _ = model.decode_step(lm["params"], long[:, S_:S_ + 1],
                                  torch.full((1,), S_), cache)
    np.testing.assert_allclose(lp.numpy(), forward[:, S_ - 1].numpy(),
                               atol=MODEL_ATOL, rtol=0)
    np.testing.assert_allclose(ld.numpy(), forward[:, S_].numpy(),
                               atol=MODEL_ATOL, rtol=0)


@pytest.fixture(scope="module")
def float64_logits(lm):
    """Past S = 21 the two packages' float32 logits differ by up to about
    1e-3. Which one is off? Both are measured against the port's plain
    path evaluated in float64 on the reference's parameters: per length
    S, the JAX (plain mLSTM route) and port float32 logits and the
    float64 ones, over one 512-token prompt."""
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 256, (1, max(F64_S))).astype(np.int32)
    cfg64 = dataclasses.replace(port_cfg(), dtype="float64")
    p64 = lm_params(jax.tree_util.tree_map(np.asarray, lm["jp"]), cfg64,
                    device="cpu")
    fwd = jax.jit(lambda p, t: jtfm.forward(p, jax_config(), tokens=t)[0])
    out = {}
    for S_ in F64_S:
        t = torch.from_numpy(tokens[:, :S_]).long()
        with torch.no_grad():
            f64 = tfm.forward(p64, cfg64, tokens=t)[0]
            f32 = tfm.forward(lm["params"], port_cfg(), tokens=t)[0]
        assert f64.dtype == torch.float64 and f32.dtype == torch.float32
        out[S_] = {"float64": f64.numpy(), "port": f32.double().numpy(),
                   "jax": np.asarray(fwd(lm["jp"], jnp.asarray(
                       tokens[:, :S_])), np.float64)}
    return out


@pytest.mark.parametrize("S_", F64_S)
def test_float32_logits_match_float64_as_closely_as_the_references(
        float64_logits, S_):
    """Both packages sit at float32 rounding noise from float64, and the
    port no further than the reference: its root-mean-square error over
    the logits is within 1.25x JAX's (measured 0.93-1.09x per 128
    positions), its largest error within F64_ATOL (measured 5.8e-4,
    5.8e-4, 7.5e-4 at S = 256, 300, 512; JAX 4.9e-4, 6.3e-4, 4.9e-4)."""
    logits = float64_logits[S_]
    err = {name: logits[name] - logits["float64"] for name in ("port", "jax")}
    rms = {name: float(np.sqrt(np.mean(e ** 2))) for name, e in err.items()}
    assert rms["port"] <= 1.25 * rms["jax"], rms
    for name, e in err.items():
        assert float(np.abs(e).max()) <= F64_ATOL, name


def test_prefill_goes_through_the_mlstm_wrapper(monkeypatch, lm):
    """Every mLSTM layer of a prefill and of the no-cache forward calls
    the kernel wrapper once, with the reference's chunk of 256; decode
    does not."""
    calls = []
    wrapped = mlstm_ops.mlstm_chunkwise

    def spy(*args, **kwargs):
        calls.append(kwargs["chunk"])
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(mlstm_ops, "mlstm_chunkwise", spy)
    cfg = port_cfg()
    model = build_model(cfg)
    n = cfg.layer_kinds.count("mlstm")
    toks = torch.from_numpy(lm["tokens"]).long()
    with torch.no_grad():
        cache = model.init_cache(B, 30, device="cpu")
        model.prefill(lm["params"], cache, tokens=toks)
        assert calls == [256] * n
        model.decode_step(lm["params"], toks[:, :1], torch.full((B,), 21),
                          cache)
        assert len(calls) == n
        tfm.forward(lm["params"], cfg, tokens=toks)
    assert len(calls) == 2 * n


def test_cache_rows_write_through_the_recurrent_state(lm):
    """Prefilling into a slot's row views fills the live cache (conv
    histories and every recurrent state) exactly as a batch-of-one
    prefill fills its own cache, and leaves the other rows fresh."""
    model = build_model(port_cfg())
    toks = torch.from_numpy(lm["tokens"][:1, :9]).long()
    with torch.no_grad():
        live = model.init_cache(3, 16, device="cpu")
        a, _ = model.prefill(lm["params"], tfm.cache_rows(live, slice(1, 2)),
                             tokens=toks)
        alone = model.init_cache(1, 16, device="cpu")
        b, _ = model.prefill(lm["params"], alone, tokens=toks)
    assert torch.equal(a, b)
    got, want = flat(tfm.cache_rows(live, slice(1, 2))), flat(alone)
    assert all(torch.equal(got[k], want[k]) for k in want)
    rest = flat(tfm.cache_rows(live, slice(2, 3)))
    fresh = flat(model.init_cache(1, 16, device="cpu"))
    assert all(torch.equal(rest[k], fresh[k]) for k in fresh)


# ------------------------------------------------------------ entry point
def test_serve_main_runs_xlstm_on_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                      "--max-new", "3", "--slots", "2", "--max-len", "32"])
    assert len(out["completed"]) == 3
    assert all(len(r.tokens) == 3 for r in out["completed"])
    assert "xlstm-1.3b (small) on cpu" in capsys.readouterr().out


def test_xlstm_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--requests", "1"])


# ------------------------------------------- the full-width check's helpers
@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke.py``'s helpers: the script imports nothing of the
    card at import time."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHECK_S = 300  # a whole chunk of 256 and a short one


@pytest.fixture(scope="module")
def check_prompt():
    return np.random.default_rng(11).integers(0, port_cfg().vocab_size,
                                              CHECK_S)


def _small(lm, dtype):
    cfg = dataclasses.replace(port_cfg(), dtype=dtype)
    return build_model(cfg), cast_params(lm["params"], cfg, "cpu")


@pytest.mark.parametrize("route", ["kernels", "plain"])
def test_capture_records_one_call_per_mlstm_layer(lm, smoke, check_prompt,
                                                  route):
    model, params = _small(lm, "float32")
    cfg = model.cfg
    H = cfg.n_heads
    hd = 2 * cfg.d_model // H
    calls = []
    wrapper = mlstm_ops.mlstm_chunkwise
    with torch.no_grad():
        smoke._prefill_logits(model, params, check_prompt, route,
                              calls=calls)
    assert mlstm_ops.mlstm_chunkwise is wrapper  # restored on exit
    assert len(calls) == cfg.layer_kinds.count("mlstm")
    for call in calls:
        q, k, v, li, lf = call["inputs"]
        assert q.shape == k.shape == v.shape == (1, CHECK_S, H, hd)
        assert li.shape == lf.shape == (1, CHECK_S, H)
        assert call["chunk"] == 256
        assert call["h"].shape == q.shape
    # the recorded layers are distinct: each one's input differs
    assert len({float(c["inputs"][0].double().sum()) for c in calls}) == \
        len(calls)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_replayed_mlstm_calls_reproduce_each_layer_bit_for_bit(
        lm, smoke, check_prompt, dtype):
    model, params = _small(lm, dtype)
    calls = []
    with torch.no_grad():
        smoke._prefill_logits(model, params, check_prompt, "plain",
                              calls=calls)
        for call in calls:
            h, state = mlstm_ops.mlstm_chunkwise(*call["inputs"],
                                                 chunk=call["chunk"])
            assert h.dtype == getattr(torch, dtype)
            assert torch.equal(h, call["h"])
            assert all(torch.equal(a, b) for a, b in zip(state,
                                                          call["state"]))
        # (a) of the full-width check passes with every h element equal
        out = smoke._mlstm_layers_vs_plain(
            calls, CHECK_S, expected=model.cfg.layer_kinds.count("mlstm"))
    assert out["h_unequal"] == [0] * len(calls)
    assert out["worst"]["h_rel_l2"] == 0.0


def test_distance_to_float32_is_equal_for_two_plain_routes(lm, smoke,
                                                           check_prompt):
    """On the CPU the kernels route is the plain versions, so (b) reads
    e_k == e_p, and passes its gate; a float64 mLSTM lands elsewhere."""
    model, params = _small(lm, "bfloat16")
    model32, params32 = _small(lm, "float32")
    with torch.no_grad():
        bf16 = {route: smoke._prefill_logits(model, params, check_prompt,
                                             route)
                for route in ("kernels", "plain", "plain_f64_mlstm")}
        reference = smoke._prefill_logits(model32, params32, check_prompt,
                                          "plain")
    dist = smoke._distances_to_f32(bf16, reference)
    assert dist["kernels"] == dist["plain"] > 0.0
    assert dist["plain_f64_mlstm"] != dist["plain"]
    gate = smoke._f32_gate(dist, CHECK_S)
    assert gate["limit"] == max(smoke.FULL_BF16_REL_TOL,
                                smoke.XLSTM_F32_MARGIN * dist["plain"])


def test_f32_gate_refuses_a_kernel_past_the_margin(smoke):
    e_p = 0.3
    ok = {"kernels": 1.25 * e_p, "plain": e_p, "plain_f64_mlstm": e_p}
    assert smoke._f32_gate(ok, CHECK_S)["limit"] == 1.25 * e_p
    with pytest.raises(RuntimeError, match="check failed"):
        smoke._f32_gate(dict(ok, kernels=1.26 * e_p), CHECK_S)
    # below FULL_BF16_REL_TOL the floor holds, however close e_p is
    small = {"kernels": 0.09, "plain": 1e-3, "plain_f64_mlstm": 1e-3}
    assert smoke._f32_gate(small, CHECK_S)["limit"] == 0.1
