"""The flash-attention backward's formulas and the forward's log-sum-exp
in the plain version (``ref.attention_bwd``, ``ref.attention_lse``)
against the JAX package's reference VJP, the port's autograd and a
float64 log-sum-exp, the wrapper's (out, L) pair and the backward's
routes, on the CPU. The kernels are held against these formulas on the
card (``chip_smoke.py`` phase [22a])."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

S = 40
# (causal, window, T): phase [22a]'s four modes (causal, causal with a
# window, no mask over T = S and over T != S), and the window over fewer
# keys than queries, where rows past T - 1 + window have no live key
MODES = {"causal": (True, 0, None), "window": (True, 8, None),
         "window_dead_rows": (True, 8, 13), "no_mask": (False, 0, None),
         "no_mask_T": (False, 0, 19)}
HEADS = {1: (4, 4), 3: (6, 2), 4: (8, 2)}  # GQA group: (H, KH)


def live_rows(T, causal, window):
    """(S,) bool: the query rows with a live key."""
    i, j = np.arange(S)[:, None], np.arange(T)[None, :]
    live = np.ones((S, T), bool)
    if causal:
        live &= j <= i
    if window > 0:
        live &= i - j < window
    return live.any(-1)


def inputs(mode, group, D):
    """float32 numpy q (B, H, S, D), k and v (B, KH, T, D), and a
    cotangent zeroed at the rows with no live key (as phase [22a] does:
    the kernels give 0 there, the reference the mean of v), with the
    mode's mask arguments."""
    causal, window, T = MODES[mode]
    T = S if T is None else T
    H, KH = HEADS[group]
    rng = np.random.default_rng([group, D, T, window, int(causal)])
    q = rng.standard_normal((2, H, S, D)).astype(np.float32)
    k = rng.standard_normal((2, KH, T, D)).astype(np.float32)
    v = rng.standard_normal((2, KH, T, D)).astype(np.float32)
    do = rng.standard_normal((2, H, S, D)).astype(np.float32)
    do[:, :, ~live_rows(T, causal, window)] = 0.0
    return q, k, v, do, dict(causal=causal, window=window)


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_vjp(q, k, v, do, causal, window):
    """``jax.vjp`` of the reference's oracle, compiled once a shape and
    mask (eager JAX compiles every op of the call anew)."""
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal=causal,
                                                    window=window), q, k, v)
    return vjp(do)


def plain_bwd(q, k, v, do, mask):
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    lse = ref.attention_lse(tq, tk, **mask)
    return ref.attention_bwd(tq, tk, tv, lse, tdo, **mask)


@pytest.mark.parametrize("group,D", [(3, 16), (4, 64)])
@pytest.mark.parametrize("mode", MODES)
def test_attention_bwd_matches_jax_vjp(mode, group, D):
    """The backward kernels' formulas against ``jax.vjp`` of the
    reference's oracle (``repro/kernels/flash_attention/ref.py``), which
    the reference's custom VJP (``ops.py:42-48``) differentiates."""
    q, k, v, do, mask = inputs(mode, group, D)
    got = plain_bwd(q, k, v, do, mask)
    want = _jax_vjp(*map(jnp.asarray, (q, k, v, do)), mask["causal"],
                    mask["window"])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("group", HEADS)
@pytest.mark.parametrize("mode", MODES)
def test_attention_bwd_matches_autograd(mode, group, D):
    """The same formulas against the port's autograd through
    ``ref.attention``, the plain version the card's checks hold the
    kernels to."""
    q, k, v, do, mask = inputs(mode, group, D)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.attention(*leaves, **mask), leaves,
                               torch.from_numpy(do))
    for a, b in zip(plain_bwd(q, k, v, do, mask), want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("group", HEADS)
def test_rows_with_no_live_key_get_no_gradient(group):
    """P is masked explicitly, not through exp(s - L): a row with no live
    key (its L about -1e30) adds nothing to dk and dv and gets dq = 0,
    whatever its cotangent."""
    q, k, v, do, mask = inputs("window_dead_rows", group, 16)
    dead = ~live_rows(k.shape[2], **mask)
    assert dead.sum() == S - (13 - 1 + 8)
    full = np.random.default_rng(1).standard_normal(do.shape)
    noisy = np.where(dead[None, None, :, None], full, do).astype(np.float32)
    lse = ref.attention_lse(torch.from_numpy(q), torch.from_numpy(k), **mask)
    assert float(lse[:, :, dead].max()) <= -1e29
    for a, b in zip(plain_bwd(q, k, v, noisy, mask),
                    plain_bwd(q, k, v, do, mask)):
        assert torch.equal(a, b)
    assert not plain_bwd(q, k, v, noisy, mask)[0][:, :, dead].any()


@pytest.mark.parametrize("group", HEADS)
@pytest.mark.parametrize("mode", MODES)
def test_lse_matches_float64_logsumexp(mode, group):
    """L of the plain version against a float64 log-sum-exp of the
    masked, scaled scores over each row's live keys."""
    q, k, _, _, mask = inputs(mode, group, 16)
    H, KH = HEADS[group]
    T = k.shape[2]
    s = np.einsum("bkgsd,bktd->bkgst",
                  q.astype(np.float64).reshape(2, KH, H // KH, S, 16),
                  k.astype(np.float64)) / np.sqrt(16)
    i, j = np.arange(S)[:, None], np.arange(T)[None, :]
    live = np.ones((S, T), bool)
    if mask["causal"]:
        live &= j <= i
    if mask["window"] > 0:
        live &= i - j < mask["window"]
    s = np.where(live, s, -np.inf)
    m = s.max(-1, keepdims=True)
    rows = live.any(-1)
    with np.errstate(invalid="ignore"):
        want = (m[..., 0] + np.log(np.exp(s - m).sum(-1))).reshape(2, H, S)
    got = ref.attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                            **mask).numpy()
    assert got.dtype == np.float32 and got.shape == (2, H, S)
    np.testing.assert_allclose(got[:, :, rows], want[:, :, rows], rtol=1e-6,
                               atol=1e-5)
    assert (got[:, :, ~rows] <= -1e29).all()


@pytest.mark.parametrize("mode", MODES)
def test_flash_attention_with_lse_on_the_cpu(mode):
    """The wrapper's (out, L) in the model's layout: the output equal to
    ``flash_attention``'s bit for bit, L the plain version's."""
    q, k, v, _, mask = inputs(mode, 3, 16)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
    out, lse = ops.flash_attention_with_lse(tq, tk, tv, **mask)
    assert torch.equal(out, ops.flash_attention(tq, tk, tv, **mask))
    assert torch.equal(lse, ref.attention_lse(torch.from_numpy(q),
                                              torch.from_numpy(k), **mask))
    assert lse.shape == (2, 6, S) and not lse.requires_grad


def test_bwd_route_names_both_routes_and_refuses_other_pairs():
    for D in ops.HEAD_DIMS:
        assert ops.bwd_route(torch.bfloat16, D) == "tensor_core"
        assert ops.bwd_route(torch.float32, D, D) == "cuda_core"
    # MLA's (192, 128) on both routes, the small DeepSeek's (24, 16) on the
    # float32 route only, as the forward takes them
    assert ops.bwd_route(torch.bfloat16, 192, 128) == "tensor_core"
    assert ops.bwd_route(torch.float32, 192, 128) == "cuda_core"
    assert ops.bwd_route(torch.float32, 24, 16) == "cuda_core"
    assert ops.BWD_PAIRS == ops.PAIRS
    with pytest.raises(ValueError, match=r"no backward at \(D, DV\) = "
                                         r"\(24, 16\) in torch.bfloat16"):
        ops.bwd_route(torch.bfloat16, 24, 16)
    for dtype in ops.DTYPES:
        with pytest.raises(ValueError, match=r"no backward.*\(192, 64\)"):
            ops.bwd_route(dtype, 192, 64)
    with pytest.raises(TypeError):
        ops.bwd_route(torch.float16, 64)
    assert ops.route(torch.bfloat16, 192, 128) == "tensor_core"
