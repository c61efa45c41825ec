"""The LM slice of the port (RecurrentGemma): configuration, parameter
layout, caches, and forward / prefill / decode logits and served tokens
against the JAX package on the same parameters, for the reference's
``attn_impl`` "reference" and "pallas" (interpret mode)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_golden import (B, S, jax_config, jax_outputs,  # noqa: E402
                                  jax_params, inputs)

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model_zoo import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.params import lm_params  # noqa: E402

ATOL = 1e-4  # float32 on both sides, summed in different orders
IMPLS = ("reference", "pallas")
LONG = 33  # the no-cache forward's length: one run serves every S <= 32
RING_S = (12, 16, 21, 32)  # W = 16: below, at, off and on a multiple


@pytest.fixture(scope="module")
def lm():
    """The JAX outputs, computed once: forward over LONG tokens and
    prefill + decode (bfloat16 caches) per impl, and the served tokens."""
    cfg = jax_config()
    jp = jax_params(cfg)
    tokens, prompts = inputs(cfg.vocab_size)
    long = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, LONG)).astype(np.int32)
    out = {"cfg": cfg, "jp": jp, "tokens": tokens, "prompts": prompts,
           "long": long, "forward": {}, "cached": {}}
    for impl in IMPLS:
        c = dataclasses.replace(cfg, attn_impl=impl)
        fwd = jax.jit(lambda p, t, c=c: jtfm.forward(p, c, tokens=t)[0])
        out["forward"][impl] = np.asarray(fwd(jp, jnp.asarray(long)))
        out["cached"][impl] = jax_outputs(
            c, jp, tokens, prompts if impl == "reference" else None)
    out["params"] = lm_params(jax.tree_util.tree_map(np.asarray, jp),
                              get_config("recurrentgemma-9b").scaled_down(
                                  dtype="float32"), device="cpu")
    return out


def port_cfg():
    return get_config("recurrentgemma-9b").scaled_down(dtype="float32")


# ------------------------------------------------------------ configuration
def test_config_matches_reference():
    full, ref = get_config("recurrentgemma-9b"), jax_get_config(
        "recurrentgemma-9b")
    assert dataclasses.asdict(full) == dataclasses.asdict(ref)
    assert full.layer_kinds == ref.layer_kinds
    assert (dataclasses.asdict(full.scaled_down(max_seq=128))
            == dataclasses.asdict(ref.scaled_down(max_seq=128)))


def test_get_config_names_the_later_slice_for_unported_archs():
    """Every arch of the reference's registry is served (``PORTED`` is
    ``ARCHS``, the reference's names in its order) and equals the
    reference's config; an unknown arch is refused."""
    from repro.configs import ARCHS as JAX_ARCHS
    from repro_torch.configs import ARCHS, PORTED

    assert ARCHS == JAX_ARCHS
    assert set(PORTED) == set(ARCHS)
    for arch in ARCHS:
        assert (dataclasses.asdict(get_config(arch))
                == dataclasses.asdict(jax_get_config(arch))), arch
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


# --------------------------------------------------------- parameter layout
def test_param_tree_matches_reference_layout():
    """Seeded init keeps the reference's paths and shapes; the leaves
    read in float32 stay float32, the rest is in the compute type."""
    cfg = get_config("recurrentgemma-9b").scaled_down()  # bfloat16
    params = build_model(cfg).init(0, device="cpu")
    shapes = jax_build(jax_get_config("recurrentgemma-9b").scaled_down()
                       ).abstract_params()
    flat = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    ours = dict(jax.tree_util.tree_flatten_with_path(
        tfm.tree_map(lambda t: t, params))[0])
    assert flat.keys() == ours.keys()
    for path, sds in flat.items():
        t = ours[path]
        assert tuple(t.shape) == sds.shape, path
        f32 = str(path[-1].key) in ("scale", "lambda")
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), path
    lam = params["body"][0]["mix"]["lru"]["lambda"]
    assert float(lam.min()) >= 0.2 and float(lam.max()) <= 0.85
    assert bool((params["final_norm"]["scale"] == 1).all())
    again = build_model(cfg).init(0, device="cpu")
    assert torch.equal(again["embed"]["table"], params["embed"]["table"])


def test_lm_params_reads_nested_and_flat_forms(lm):
    from repro.common.tree import tree_flatten_with_paths

    flat = dict(tree_flatten_with_paths(
        jax.tree_util.tree_map(np.asarray, lm["jp"])))
    from_flat = lm_params(flat, port_cfg(), device="cpu")
    a = dict(jax.tree_util.tree_flatten_with_path(from_flat)[0])
    b = dict(jax.tree_util.tree_flatten_with_path(lm["params"])[0])
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_cache_layout_matches_reference():
    """Types and shapes of the reference's default caches: bfloat16 K/V
    and conv history, float32 h, int32 positions; batch axis 1 in the
    body, 0 in the tail."""
    ref = jax_build(jax_config()).init_cache(3, 40)
    ours = build_model(port_cfg()).init_cache(3, 40, device="cpu")
    flat = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    mine = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    assert flat.keys() == mine.keys()
    for path, arr in flat.items():
        assert tuple(mine[path].shape) == arr.shape, path
        assert str(mine[path].dtype).split(".")[-1] == str(arr.dtype), path


# ------------------------------------------------------- parity with JAX
@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax(lm, impl):
    with torch.no_grad():
        logits, _, _ = tfm.forward(lm["params"], port_cfg(),
                                   tokens=torch.from_numpy(lm["long"]))
    np.testing.assert_allclose(logits.numpy(), lm["forward"][impl],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_jax(lm, impl):
    """bfloat16 caches on both sides (the reference's default)."""
    model = build_model(port_cfg())
    expect = lm["cached"][impl]
    tokens = lm["tokens"]
    with torch.no_grad():
        cache = model.init_cache(B, 24, device="cpu")
        lp, cache = model.prefill(lm["params"], cache,
                                  tokens=torch.from_numpy(tokens[:, :S]))
        np.testing.assert_allclose(lp.numpy(), expect["prefill"], atol=ATOL,
                                   rtol=0)
        for i in range(expect["decode"].shape[0]):
            ld, cache = model.decode_step(
                lm["params"], torch.from_numpy(tokens[:, S + i:S + i + 1]),
                torch.full((B,), S + i), cache)
            np.testing.assert_allclose(ld.numpy(), expect["decode"][i],
                                       atol=ATOL, rtol=0)


def test_slot_server_tokens_match_jax(lm):
    model = build_model(port_cfg())
    server = serve.SlotServer(model, lm["params"], n_slots=4, max_len=64)
    reqs = [serve.Request(rid=i, prompt=p, max_new=8)
            for i, p in enumerate(lm["prompts"])]
    out = server.serve(reqs)
    done = {r.rid: r.tokens for r in out["completed"]}
    assert [done[i] for i in range(len(reqs))] == \
        lm["cached"]["reference"]["served"]
    assert server.decode_tokens == sum(len(t) - 1 for t in done.values())


# ------------------------------------- the reference's ring fault, avoided
@pytest.mark.parametrize("S_", RING_S)
def test_decode_after_prefill_matches_jax_forward(lm, S_):
    """Decode at position S after a prefill of S tokens equals the JAX
    package's no-cache forward at S, within 1e-4, for prompts shorter
    than, equal to, off a multiple of (21) and on a multiple of the
    window W = 16. Caches are float32 here so that the cache type does
    not hide the comparison. (The reference's own decode misses its
    forward at S = 21, see ROADMAP.md section 3.)"""
    model = build_model(port_cfg())
    long = torch.from_numpy(lm["long"])
    with torch.no_grad():
        cache = model.init_cache(B, S_ + 4, dtype=torch.float32,
                                 device="cpu")
        lp, cache = model.prefill(lm["params"], cache, tokens=long[:, :S_])
        ld, _ = model.decode_step(lm["params"], long[:, S_:S_ + 1],
                                  torch.full((B,), S_), cache)
    forward = lm["forward"]["reference"]
    np.testing.assert_allclose(lp.numpy(), forward[:, S_ - 1], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(ld.numpy(), forward[:, S_], atol=ATOL, rtol=0)


def test_prefill_stores_position_p_at_ring_index_p_mod_w():
    cfg = port_cfg()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    W = cfg.local_window
    with torch.no_grad():
        cache = model.init_cache(1, 40, device="cpu")
        model.prefill(params, cache, tokens=torch.arange(21)[None] % 200)
    pos = cache["body"][2]["pos"][0, 0]  # the local_attn layer, period 0
    expect = torch.full((W,), -1, dtype=torch.int32)
    for p in range(21 - W, 21):
        expect[p % W] = p
    assert torch.equal(pos, expect)


def test_cache_rows_write_through():
    """Prefilling into a slot's row views fills the live cache exactly
    as a batch-of-one prefill fills its own cache."""
    cfg = port_cfg()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.arange(7)[None] * 3
    with torch.no_grad():
        live = model.init_cache(3, 24, device="cpu")
        a, _ = model.prefill(params, tfm.cache_rows(live, slice(1, 2)),
                             tokens=toks)
        alone = model.init_cache(1, 24, device="cpu")
        b, _ = model.prefill(params, alone, tokens=toks)
    assert torch.equal(a, b)
    got = dict(jax.tree_util.tree_flatten_with_path(
        tfm.cache_rows(live, slice(1, 2)))[0])
    want = dict(jax.tree_util.tree_flatten_with_path(alone)[0])
    assert all(torch.equal(got[k], want[k]) for k in want)
    empty = model.init_cache(1, 24, device="cpu")
    rest = dict(jax.tree_util.tree_flatten_with_path(
        tfm.cache_rows(live, slice(2, 3)))[0])
    fresh = dict(jax.tree_util.tree_flatten_with_path(empty)[0])
    assert all(torch.equal(rest[k], fresh[k]) for k in fresh)


# ------------------------------------------- prefill attention path
def test_prefill_attention_always_goes_through_the_flash_wrapper(
        monkeypatch):
    """Every attention layer of a prefill and of the no-cache forward
    calls the kernel wrapper once; decode does not."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    calls = []
    wrapped = fa_ops.flash_attention

    def spy(*args, **kwargs):
        calls.append(kwargs["window"])
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(fa_ops, "flash_attention", spy)
    cfg = port_cfg()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    n_attn = cfg.layer_kinds.count("local_attn")
    toks = torch.arange(21)[None] % 200
    with torch.no_grad():
        cache = model.init_cache(1, 40, device="cpu")
        model.prefill(params, cache, tokens=toks)
        assert calls == [cfg.local_window] * n_attn
        model.decode_step(params, toks[:, :1], torch.tensor([21]), cache)
        assert len(calls) == n_attn
        tfm.forward(params, cfg, tokens=toks)
    assert len(calls) == 2 * n_attn


@pytest.mark.parametrize("mode", ["prefill", "decode", "forward"])
def test_attention_logit_softcap_is_refused(mode):
    """The kernel has no logit soft-cap: a config that sets one is
    refused in every mode rather than served by another path."""
    cfg = dataclasses.replace(port_cfg(), attn_logit_softcap=50.0)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.arange(5)[None]
    with torch.no_grad(), pytest.raises(ValueError, match="softcap"):
        cache = model.init_cache(1, 16, device="cpu")
        if mode == "prefill":
            model.prefill(params, cache, tokens=toks)
        elif mode == "decode":
            model.decode_step(params, toks[:, :1], torch.tensor([0]), cache)
        else:
            tfm.forward(params, cfg, tokens=toks)


def test_time_to_first_token_counts_from_arrival():
    """TTFT runs from the request's arrival, so a request that waits for
    a slot counts the wait; prefill latency counts only its prefill."""
    model = build_model(port_cfg())
    params = model.init(0, device="cpu")
    server = serve.SlotServer(model, params, n_slots=1, max_len=32)
    reqs = serve.make_requests(3, model.cfg.vocab_size, 3, seed=0)
    out = server.serve(reqs)
    done = sorted(out["completed"], key=lambda r: r.rid)
    assert len({r.arrival_s for r in done}) == 1  # stamped by serve()
    for r in done:
        assert 0.0 < r.prefill_s <= r.ttft_s
    # one slot: each later request waits for the previous one to finish
    for earlier, later in zip(done, done[1:]):
        assert later.ttft_s - later.prefill_s >= earlier.ttft_s
    stamped = serve.make_requests(1, model.cfg.vocab_size, 2, seed=1)
    stamped[0].arrival_s = 0.0  # arrived long before: kept as given
    server.serve(stamped)
    assert stamped[0].arrival_s == 0.0 and stamped[0].ttft_s > 1.0


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_make_requests_draws_the_references_request_stream(n, seed):
    """The reference's ``main`` (repro/launch/serve.py:556-563) draws, for
    each request in turn, a length in [4, 16] and then its prompt; the
    same seed gives the same prompts token for token."""
    vocab, max_new = 256000, 5
    rng = np.random.default_rng(seed)
    expect = [rng.integers(0, vocab, rng.integers(4, 17)).astype(np.int32)
              for _ in range(n)]
    reqs = serve.make_requests(n, vocab, max_new, seed)
    assert [r.rid for r in reqs] == list(range(n))
    assert all(r.max_new == max_new for r in reqs)
    for r, prompt in zip(reqs, expect):
        assert r.prompt.dtype == np.int32
        np.testing.assert_array_equal(r.prompt, prompt)


def test_make_requests_keeps_given_lengths():
    reqs = serve.make_requests(3, 100, 2, seed=0, lengths=[5, 1, 9])
    assert [len(r.prompt) for r in reqs] == [5, 1, 9]
    rng = np.random.default_rng(0)
    for r, s in zip(reqs, (5, 1, 9)):
        np.testing.assert_array_equal(r.prompt, rng.integers(0, 100, s))


# ------------------------------------------------------------ entry point
def test_serve_main_runs_on_cpu(capsys):
    out = serve.main(["--device", "cpu", "--requests", "3", "--max-new",
                      "3", "--slots", "2", "--max-len", "32"])
    assert len(out["completed"]) == 3
    assert all(len(r.tokens) == 3 for r in out["completed"])
    assert "on cpu" in capsys.readouterr().out


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(port_cfg()).init(0)


def test_lm_params_go_to_the_card_unless_told_cpu(lm):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    source = jax.tree_util.tree_map(np.asarray, lm["jp"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_params(source, port_cfg())
    params = lm_params(source, port_cfg(), device="cpu")
    assert params["embed"]["table"].device.type == "cpu"
