"""Edge-softmax aggregation: the port's plain version against the JAX
package's Pallas kernel (interpret mode) and its oracle, the wrapper's
checks, and (on a card) the CUDA kernel against the plain version."""

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
    (lambda q, k, v, m: (q.requires_grad_(), k, v, m), "no backward"),
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
