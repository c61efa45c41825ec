"""Edge-softmax aggregation: the port's plain versions (forward and
backward) against the JAX package's Pallas kernel (interpret mode, its
custom VJP) and its oracle (autodiff), the autograd Function, the
wrapper's checks, and (on a card) the CUDA kernels against the plain
versions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.edge_softmax import ops as jops  # noqa: E402
from repro.kernels.edge_softmax import ref as jref  # noqa: E402
from repro_torch.kernels.edge_softmax import ops, ref  # noqa: E402

# the reference's kernel tolerances (tests/test_kernels.py:13)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

_jax_interpret = jax.jit(
    lambda q, k, v, m: jops.edge_softmax_aggregate(q, k, v, m,
                                                   interpret=True))


def make_inputs(N, P, H, hd, seed=0, p_keep=0.8):
    """float32 numpy inputs; single-head layout when H == 1."""
    rng = np.random.default_rng(seed * 1000 + N * 10 + P + H)
    lead = (N,) if H == 1 else (N, H)
    q = rng.standard_normal(lead + (hd,)).astype(np.float32)
    k = rng.standard_normal((N, P) + lead[1:] + (hd,)).astype(np.float32)
    v = rng.standard_normal((N, P) + lead[1:] + (hd,)).astype(np.float32)
    mask = rng.random((N, P)) < p_keep
    return q, k, v, mask


def run_port(q, k, v, mask, dtype="float32", device="cpu"):
    tdt = DTYPES[dtype][1]
    args = [torch.from_numpy(a).to(device=device, dtype=tdt)
            for a in (q, k, v)]
    with torch.no_grad():
        out, att = ops.edge_softmax_aggregate(
            *args, torch.from_numpy(mask).to(device))
    return out.float().cpu().numpy(), att.cpu().numpy()


SWEEP_N = (0, 7, 64, 100, 129, 513, 1800)


@functools.lru_cache(maxsize=None)
def jax_sweep(P, H, dtype):
    """The JAX kernel (interpret mode) and oracle over one input holding
    every N of the sweep end to end: both are row-independent, so one
    call per (P, H, dtype) serves every N (a Pallas interpret compile
    per shape would dominate the test time)."""
    hd = 32 if H == 1 else 8
    inputs = make_inputs(sum(SWEEP_N), P, H, hd)
    jdt = DTYPES[dtype][0]
    jargs = [jnp.asarray(a, jdt) for a in inputs[:3]]
    jargs.append(jnp.asarray(inputs[3]))
    outs = {}
    for name, fn in (("interpret", _jax_interpret),
                     ("ref", jax.jit(jref.edge_softmax_aggregate))):
        oj, aj = fn(*jargs)
        outs[name] = (np.asarray(oj, np.float32), np.asarray(aj))
    return inputs, outs


@pytest.mark.parametrize("N", SWEEP_N)
@pytest.mark.parametrize("P", [3, 5])
@pytest.mark.parametrize("H", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax(N, P, H, dtype):
    inputs, outs = jax_sweep(P, H, dtype)
    off = sum(SWEEP_N[:SWEEP_N.index(N)])
    rows = slice(off, off + N)
    out, att = run_port(*(a[rows] for a in inputs), dtype)
    tol = TOL[dtype]
    for name, (oj, aj) in outs.items():
        assert out.shape == oj[rows].shape, name
        assert att.shape == aj[rows].shape, name
        np.testing.assert_allclose(out, oj[rows], atol=tol, rtol=tol,
                                   err_msg=name)
        np.testing.assert_allclose(att, aj[rows], atol=tol, err_msg=name)


def test_fully_masked_rows_give_zero():
    q = torch.ones(8, 16)
    k = torch.ones(8, 3, 16)
    mask = torch.zeros(8, 3, dtype=torch.bool)
    out, att = ref.edge_softmax_aggregate(q, k, k, mask)
    assert float(out.abs().max()) == 0.0 and float(att.abs().max()) == 0.0


def test_attention_sums_to_one_over_valid_edges():
    q, k, v, mask = make_inputs(64, 3, 4, 8)
    mask[:, 0] = True
    _, att = run_port(q, k, v, mask)
    np.testing.assert_allclose(att.sum(-1), 1.0, atol=1e-5)
    assert np.all(att[~np.broadcast_to(mask[:, None, :], att.shape)] == 0)


@pytest.mark.parametrize("N,H,hd", [(100, 4, 16), (64, 2, 32), (200, 8, 8)])
def test_multi_head_equals_per_head(N, H, hd):
    q, k, v, mask = (torch.from_numpy(a)
                     for a in make_inputs(N, 3, H, hd, seed=1))
    out, att = ref.edge_softmax_aggregate(q, k, v, mask)
    for h in range(H):
        oh, ah = ref.edge_softmax_aggregate(q[:, h], k[:, :, h],
                                            v[:, :, h], mask)
        torch.testing.assert_close(out[:, h], oh, atol=2e-5, rtol=0)
        torch.testing.assert_close(att[:, h], ah, atol=2e-5, rtol=0)


def test_wrapper_takes_plain_version_for_cpu_tensors_only():
    q, k, v, mask = (torch.from_numpy(a) for a in make_inputs(50, 3, 4, 8))
    before = ops.LAUNCHES
    out, att = ops.edge_softmax_aggregate(q, k, v, mask)
    oe, ae = ref.edge_softmax_aggregate(q, k, v, mask)
    assert torch.equal(out, oe) and torch.equal(att, ae)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.edge_softmax_aggregate(q.to("meta"), k.to("meta"),
                                   v.to("meta"), mask.to("meta"))


def _good(N=10, P=3, H=4, hd=8):
    return (torch.zeros(N, H, hd), torch.zeros(N, P, H, hd),
            torch.zeros(N, P, H, hd), torch.ones(N, P, dtype=torch.bool))


@pytest.mark.parametrize("bad,match", [
    (lambda q, k, v, m: (q.double(), k.double(), v.double(), m), "share"),
    (lambda q, k, v, m: (q, k.half(), v, m), "share"),
    (lambda q, k, v, m: (q, k, v, m.float()), "mask must be"),
    (lambda q, k, v, m: (q, k, v[:, :2], m), "v"),
    (lambda q, k, v, m: (q, k, v, m[:, :2]), "mask"),
    (lambda q, k, v, m: (q[:, :, 0], k, v, m), "q must be"),
    (lambda q, k, v, m: (q, k[:, :, :2], v[:, :, :2], m), "does not match"),
    (lambda q, k, v, m: (q, k.transpose(0, 1).contiguous().transpose(0, 1),
                         v, m), "contiguous"),
    (lambda q, k, v, m: _good(hd=6), "power of two"),
    (lambda q, k, v, m: _good(H=32, hd=8), "H\\*hd"),
    (lambda q, k, v, m: _good(P=9), "P <="),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    with pytest.raises((ValueError, TypeError, RuntimeError), match=match):
        ops._check(*bad(*_good()))


def test_kernel_wrapper_accepts_the_main_path_shapes():
    ops._check(*_good(N=2048))
    q, k, v, m = _good(N=0)
    ops._check(q, k, v, m.to(torch.uint8))
    with torch.no_grad():
        ops._check(q.requires_grad_(), k, v, m)


# ---------------------------------------------------------------- backward
BWD_SWEEP_N = (0, 1, 7, 130, 513)
BWD_HEADS = ((1, 32), (4, 8))


def _jax_vjp(fn):
    @jax.jit
    def run(q, k, v, mask, g_out, g_att):
        _, pull = jax.vjp(lambda q, k, v: fn(q, k, v, mask), q, k, v)
        return pull((g_out, g_att))
    return run


_JAX_VJPS = {
    "custom_vjp": _jax_vjp(lambda q, k, v, m: jops.edge_softmax_aggregate(
        q, k, v, m, interpret=True)),
    "autodiff": _jax_vjp(jref.edge_softmax_aggregate),
}


def make_cotangents(N, P, H, hd, seed=0):
    rng = np.random.default_rng(seed * 1000 + N * 10 + P + H + 7)
    lead = (N,) if H == 1 else (N, H)
    return (rng.standard_normal(lead + (hd,)).astype(np.float32),
            rng.standard_normal(lead + (P,)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def jax_bwd_sweep(P, H, hd, dtype):
    """The JAX package's gradients over one input holding every N of the
    sweep end to end (row-independent, one compile per shape), for a
    zero and a random att cotangent."""
    total = sum(BWD_SWEEP_N)
    inputs = make_inputs(total, P, H, hd)
    g_out, g_att = make_cotangents(total, P, H, hd)
    jdt = DTYPES[dtype][0]
    jargs = [jnp.asarray(a, jdt) for a in inputs[:3]]
    jargs.append(jnp.asarray(inputs[3]))
    outs = {}
    for name, fn in _JAX_VJPS.items():
        for with_g_att in (False, True):
            ga = g_att if with_g_att else np.zeros_like(g_att)
            grads = fn(*jargs, jnp.asarray(g_out, jdt), jnp.asarray(ga))
            outs[name, with_g_att] = [np.asarray(g, np.float32)
                                      for g in grads]
    return inputs, (g_out, g_att), outs


def port_grads(q, k, v, mask, g_out, g_att, dtype="float32", device="cpu"):
    """(dq, dk, dv) through the wrapper and autograd; ``g_att`` None
    leaves att out of the graph, as the model does."""
    tdt = DTYPES[dtype][1]
    args = [torch.from_numpy(a).to(device=device, dtype=tdt)
            .requires_grad_() for a in (q, k, v)]
    out, att = ops.edge_softmax_aggregate(
        *args, torch.from_numpy(mask).to(device))
    outs, cots = [out], [torch.from_numpy(g_out).to(device=device,
                                                    dtype=tdt)]
    if g_att is not None:
        outs.append(att)
        cots.append(torch.from_numpy(g_att).to(device))
    grads = torch.autograd.grad(outs, args, cots)
    return [g.float().cpu().numpy() for g in grads]


@pytest.mark.parametrize("N", BWD_SWEEP_N)
@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("H,hd", BWD_HEADS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_g_att", [False, True])
def test_plain_backward_matches_jax(N, P, H, hd, dtype, with_g_att):
    inputs, (g_out, g_att), outs = jax_bwd_sweep(P, H, hd, dtype)
    off = sum(BWD_SWEEP_N[:BWD_SWEEP_N.index(N)])
    rows = slice(off, off + N)
    got = port_grads(*(a[rows] for a in inputs), g_out[rows],
                     g_att[rows] if with_g_att else None, dtype)
    tol = TOL[dtype]
    for name in _JAX_VJPS:
        for label, a, b in zip("qkv", got, outs[name, with_g_att]):
            assert a.shape == b[rows].shape, (name, label)
            np.testing.assert_allclose(a, b[rows], atol=tol, rtol=tol,
                                       err_msg=f"{name} d{label}")


@pytest.mark.parametrize("with_g_att", [False, True])
def test_backward_of_fully_masked_rows_is_zero(with_g_att):
    q, k, v, mask = make_inputs(40, 3, 4, 8, seed=3)
    mask[10:20] = False
    g_out, g_att = make_cotangents(40, 3, 4, 8, seed=3)
    grads = port_grads(q, k, v, mask, g_out,
                       g_att if with_g_att else None)
    for g in grads:
        assert np.abs(g[10:20]).max() == 0.0
        assert np.abs(g[:10]).max() > 0.0


@pytest.mark.parametrize("H", [1, 2])
def test_function_passes_gradcheck_in_float64(H):
    """The autograd Function (plain forward and backward on the CPU)
    against finite differences, through both outputs."""
    q, k, v, mask = make_inputs(6, 3, H, 4, seed=4)
    mask[2] = False
    args = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    m = torch.from_numpy(mask)
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.edge_softmax_aggregate(q, k, v, m), args)


def test_call_that_needs_a_gradient_goes_through_the_function():
    """In place of the old grad guard: a call under grad builds the
    autograd Function's node (the kernels on a card, the plain versions
    here); without grad it builds none, and the CPU launches nothing."""
    q, k, v, mask = (torch.from_numpy(a) for a in make_inputs(50, 3, 4, 8))
    fwd, bwd = ops.LAUNCHES, ops.BWD_LAUNCHES
    qg = q.clone().requires_grad_()
    out, att = ops.edge_softmax_aggregate(qg, k, v, mask)
    assert type(out.grad_fn).__name__ == "EdgeSoftmaxBackward"
    oe, ae = ref.edge_softmax_aggregate(q, k, v, mask)
    assert torch.equal(out.detach(), oe) and torch.equal(att.detach(), ae)
    (dq,) = torch.autograd.grad(out.sum(), qg)
    want, _, _ = ref.edge_softmax_backward(q, k, v, ae, torch.ones_like(q),
                                           None, 1 / 8 ** 0.5)
    assert torch.equal(dq, want)
    with torch.no_grad():
        out, _ = ops.edge_softmax_aggregate(qg, k, v, mask)
    assert out.grad_fn is None
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES) == (fwd, bwd)


def _good_bwd(N=10, P=3, H=4, hd=8):
    return (torch.zeros(N, H, hd), torch.zeros(N, H, P),
            torch.zeros(N, H, hd), torch.zeros(N, H, P))


@pytest.mark.parametrize("bad,match", [
    (lambda q, a, g, ga: (q, a, g.double(), ga), "g_out"),
    (lambda q, a, g, ga: (q, a, g[:, :2], ga), "g_out"),
    (lambda q, a, g, ga: (q, a[:, :2], g, ga), "att must be"),
    (lambda q, a, g, ga: (q, a.double(), g, ga), "att must be"),
    (lambda q, a, g, ga: (q, a, g, ga[:5]), "g_att must be"),
    (lambda q, a, g, ga: (q, a, g, ga.transpose(0, 1).contiguous()
                          .transpose(0, 1)), "contiguous"),
])
def test_backward_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    with pytest.raises(ValueError, match=match):
        ops._check_bwd(*bad(*_good_bwd()))


def test_backward_wrapper_accepts_a_missing_att_cotangent():
    q, a, g, _ = _good_bwd()
    ops._check_bwd(q, a, g, None)


@pytest.mark.gpu
@pytest.mark.parametrize("N,P,H,hd", [(2048, 3, 4, 8), (1080, 3, 4, 8),
                                      (513, 8, 1, 128), (130, 1, 2, 64),
                                      (7, 3, 1, 32), (0, 3, 4, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_g_att", [False, True])
def test_cuda_backward_matches_plain_version(N, P, H, hd, dtype, with_g_att):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, mask = make_inputs(N, P, H, hd, seed=5)
    mask[N // 3: N // 3 + N // 4] = False
    g_out, g_att = make_cotangents(N, P, H, hd, seed=5)
    g_att = g_att if with_g_att else None
    fwd, bwd = ops.LAUNCHES, ops.BWD_LAUNCHES
    got = port_grads(q, k, v, mask, g_out, g_att, dtype, device="cuda")
    torch.cuda.synchronize()
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES) == (fwd + (N > 0),
                                                bwd + (N > 0))
    want = port_grads(q, k, v, mask, g_out, g_att, dtype, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("N,P,H,hd", [(2048, 3, 4, 8), (1800, 3, 4, 8),
                                      (513, 5, 1, 128), (129, 3, 2, 64),
                                      (1, 3, 4, 8), (0, 3, 4, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(N, P, H, hd, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, mask = make_inputs(N, P, H, hd, seed=2)
    mask[N // 3: N // 3 + N // 4] = False
    before = ops.LAUNCHES
    out, att = run_port(q, k, v, mask, dtype, device="cuda")
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + (N > 0)
    oe, ae = run_port(q, k, v, mask, dtype, device="cpu")
    np.testing.assert_allclose(out, oe, atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(att, ae, atol=TOL[dtype])
