"""The MoE feed-forward of the port (``models/moe.py``) and the small
granite-moe-1b-a400m against the JAX package: the router (weights, ids
and the aux loss, with forced ties), both dispatch implementations with
a capacity that drops choices and one that drops none, and the small
model's no-cache forward, prefill, decode steps and served tokens."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_zoo import (ATOL, MOE, check_fresh,  # noqa: E402
                               jax_case, port_config)

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.params import lm_params  # noqa: E402

MOE_ATOL = 1e-5  # one layer, float32 on both sides
S_LONG = 64
# capacity factors: 4.0 drops nothing at these sizes; 0.25 gives C = 8
# slots, against an expected load of 32 choices an expert in a scatter
# group of 64 tokens and of 8 in an einsum group of 16
NO_DROPS, DROPS = 4.0, 0.25


@pytest.fixture(scope="module")
def granite():
    """The JAX outputs of the small granite, computed once."""
    return jax_case(MOE)


def small_cfgs(impl="scatter", capacity_factor=1.25, group_size=256,
               shared=0):
    """The small granite config in both packages with the MoE fields
    replaced."""
    def one(get):
        cfg = get(MOE).scaled_down(dtype="float32")
        m = dataclasses.replace(cfg.moe, impl=impl,
                                capacity_factor=capacity_factor,
                                group_size=group_size,
                                n_shared_experts=shared,
                                shared_d_ff=32 if shared else 0)
        return dataclasses.replace(cfg, moe=m)

    return one(jax_get_config), one(get_config)


def moe_params(jcfg, seed=0):
    """JAX ``moe_init`` parameters (numpy) and the port's copy."""
    from repro.models import nn as jnn

    params, _ = jmoe.moe_init(jnn.Init(jax.random.PRNGKey(seed)), jcfg)
    params = jax.tree_util.tree_map(np.array, params)  # writable copies
    return params, tfm.tree_map(torch.from_numpy, params)


def jax_keep(ids, E, C):
    """The reference's slot assignment (repro/models/moe.py:145-150) on
    JAX's ids: keep (B, S*K)."""
    B = ids.shape[0]
    flat_ids = ids.reshape(B, -1)
    onehot = jax.nn.one_hot(flat_ids, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=1) - 1) * onehot, -1)
    return np.asarray(pos < C)


def x_of(S, seed=1, B=2, D=64):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D)).astype(np.float32)


# ------------------------------------------------------------------ router
@pytest.mark.parametrize("ties", ["none", "columns", "all"])
def test_router_topk_matches_jax(ties):
    """Weights, ids (in JAX's order) and the aux loss. "columns": two
    pairs of equal router columns, so every token has two pairs of equal
    probabilities; "all": x = 0, every probability 1/E, so the ids are
    0..K-1 in both packages."""
    jcfg, cfg = small_cfgs()
    params, tparams = moe_params(jcfg)
    w = params["router"]["w"]
    if ties == "columns":
        w[:, 2], w[:, 3] = w[:, 0], w[:, 1]
    x = x_of(16) if ties != "all" else np.zeros((2, 16, 64), np.float32)
    jw, jids, jaux = jmoe.router_topk(params, jcfg.moe, jnp.asarray(x))
    tw, tids, taux = moe.router_topk(
        tfm.tree_map(torch.from_numpy, params), cfg.moe, torch.from_numpy(x))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    if ties == "columns":  # the ties are really there
        probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(w), -1)
        assert torch.equal(probs[..., 0], probs[..., 2])
    if ties == "all":
        assert (tids.numpy() == np.arange(cfg.moe.top_k)).all()


def test_topk_breaks_ties_by_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3, 0.2]])
    assert moe._topk(probs, 4).tolist() == [[1, 2, 4, 3]]
    expect = jax.lax.top_k(jnp.asarray(probs.numpy()), 4)[1]
    assert moe._topk(probs, 4).tolist() == np.asarray(expect).tolist()


# ---------------------------------------------------------------- dispatch
@pytest.mark.parametrize("impl", ["scatter", "einsum"])
@pytest.mark.parametrize("capacity_factor", [NO_DROPS, DROPS])
def test_moe_apply_matches_jax(impl, capacity_factor):
    """Output and aux loss of both impls, and which choices were kept
    (the drop count), with a capacity that drops and one that does
    not. The einsum impl runs groups of 16 tokens."""
    jcfg, cfg = small_cfgs(impl, capacity_factor, group_size=16)
    params, tparams = moe_params(jcfg)
    x = x_of(S_LONG)
    jout, jaux = jmoe.moe_apply(params, jcfg, jnp.asarray(x))
    with moe.record_keep() as keeps:
        tout, taux = moe.moe_apply(tparams, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               atol=MOE_ATOL, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    # JAX's keep from JAX's ids, in the impl's groups
    _, jids, _ = jmoe.router_topk(params, jcfg.moe, jnp.asarray(x))
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    g = S_LONG if impl == "scatter" else 16
    C = moe._capacity(cfg.moe, g)
    expect = jax_keep(np.asarray(jids).reshape(-1, g, K), E, C)
    (keep,) = keeps
    assert keep.shape == (2, S_LONG, K)
    np.testing.assert_array_equal(keep.reshape(-1, g * K).numpy(), expect)
    dropped = int((~keep).sum())
    if capacity_factor == NO_DROPS:
        assert dropped == 0
    else:
        assert dropped > 0
        # a dropped choice contributes nothing: the output is the kept
        # choices' experts only
        assert not torch.allclose(tout, moe.moe_apply(
            tparams, small_cfgs(impl, NO_DROPS, 16)[1],
            torch.from_numpy(x))[0])


def test_moe_apply_with_shared_experts_matches_jax():
    """The shared experts (deepseek-v2's) add a swiglu MLP of x."""
    jcfg, cfg = small_cfgs(shared=1)
    params, tparams = moe_params(jcfg)
    assert "shared" in params
    x = x_of(16)
    jout, _ = jmoe.moe_apply(params, jcfg, jnp.asarray(x))
    tout, _ = moe.moe_apply(tparams, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               atol=MOE_ATOL, rtol=0)


def test_a_choice_past_capacity_goes_last_tokens_first():
    """Slots are taken in token-major order, so the dropped choices are
    the latest tokens' of each expert; one token (S = 1, decode) is
    never dropped at the full config's capacity."""
    full = get_config(MOE).moe
    assert moe._capacity(full, 1) >= full.top_k
    ids = torch.tensor([[[0, 1], [0, 2], [0, 1], [0, 3]]])  # (1, 4, 2)
    slot, keep = moe.dispatch_slots(ids, 4, 2)
    assert slot.tolist() == [[[0, 0], [1, 0], [2, 1], [3, 0]]]
    assert keep.tolist() == [[[True, True], [True, True], [False, True],
                              [False, True]]]


def test_einsum_impl_refuses_a_ragged_group():
    _, cfg = small_cfgs("einsum", group_size=16)
    _, tparams = moe_params(small_cfgs()[0])
    with pytest.raises(ValueError, match="group size"):
        moe.moe_apply(tparams, cfg, torch.zeros(1, 24, 64))


# -------------------------------------------------------- the small model
def test_forward_matches_jax(granite):
    params = lm_params(granite["params"], port_config(MOE), device="cpu")
    with torch.no_grad():
        logits, _, aux = tfm.forward(params, port_config(MOE),
                                     tokens=torch.from_numpy(
                                         granite["tokens"]))
    np.testing.assert_allclose(logits.numpy(), granite["forward"],
                               atol=ATOL, rtol=0)
    from repro.models import transformer as jtfm

    _, _, jaux = jax.jit(lambda p, t: jtfm.forward(p, granite["cfg"],
                                                   tokens=t))(
        granite["params"], jnp.asarray(granite["tokens"]))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_prefill_and_decode_match_jax(granite):
    """Prefill of 16 tokens and three decode steps, float32 caches on
    both sides; every decode step keeps all its choices."""
    cfg = port_config(MOE)
    model = build_model(cfg)
    params = lm_params(granite["params"], cfg, device="cpu")
    tokens = torch.from_numpy(granite["tokens"])
    B, S = 2, 16
    with torch.no_grad():
        cache = model.init_cache(B, 24, dtype=torch.float32, device="cpu")
        lp, cache = model.prefill(params, cache, tokens=tokens[:, :S])
        np.testing.assert_allclose(lp.numpy(), granite["prefill"],
                                   atol=ATOL, rtol=0)
        for i in range(granite["decode"].shape[0]):
            with moe.record_keep() as keeps:
                ld, cache = model.decode_step(
                    params, tokens[:, S + i:S + i + 1],
                    torch.full((B,), S + i), cache)
            assert all(bool(k.all()) for k in keeps)
            np.testing.assert_allclose(ld.numpy(), granite["decode"][i],
                                       atol=ATOL, rtol=0)


def test_slot_server_tokens_match_jax(granite):
    from repro_torch.launch.serve import Request, SlotServer

    cfg = port_config(MOE)
    model = build_model(cfg)
    params = lm_params(granite["params"], cfg, device="cpu")
    server = SlotServer(model, params, n_slots=4, max_len=64)
    reqs = [Request(rid=i, prompt=p, max_new=8)
            for i, p in enumerate(granite["prompts"])]
    done = {r.rid: r.tokens for r in server.serve(reqs)["completed"]}
    assert [done[i] for i in range(len(reqs))] == granite["served"]


def test_golden_is_fresh(granite):
    check_fresh(MOE, granite)
