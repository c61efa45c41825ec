"""RG-LRU linear scan: the port's plain version against the JAX
package's Pallas kernel (interpret mode) and its oracle, with and
without h0, the wrapper's checks, and (on a card) the CUDA kernel
against the plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.rg_lru import ops as jops  # noqa: E402
from repro.kernels.rg_lru import ref as jref  # noqa: E402
from repro_torch.kernels.rg_lru import ops, ref  # noqa: E402

# the reference's own tolerance for this scan (tests/test_kernels.py:84-87):
# a sequential and an associative scan round in different orders
ATOL, RTOL = 3e-5, 1e-4

_jax_interpret = jax.jit(
    lambda a, b, h0: jops.linear_scan(a, b, h0, interpret=True))
_jax_interpret_no_h0 = jax.jit(
    lambda a, b: jops.linear_scan(a, b, None, interpret=True))
_jax_ref = jax.jit(jref.linear_scan)
_jax_ref_no_h0 = jax.jit(lambda a, b: jref.linear_scan(a, b, None))


def make_inputs(B, S, C, seed=0, b_dtype=np.float32):
    """a in (0.5, 0.999) as in tests/test_kernels.py, b normal (rounded
    to bfloat16 first when b_dtype is 'bfloat16'), h0 normal."""
    rng = np.random.default_rng(seed * 7919 + B * 1000 + S + C)
    a = rng.uniform(0.5, 0.999, (B, S, C)).astype(np.float32)
    b = rng.standard_normal((B, S, C)).astype(np.float32)
    if b_dtype == "bfloat16":
        b = np.asarray(jnp.asarray(b, jnp.bfloat16), np.float32)
    h0 = rng.standard_normal((B, C)).astype(np.float32)
    return a, b, h0


def run_port(a, b, h0, device="cpu"):
    args = [None if x is None else torch.from_numpy(x).to(device)
            for x in (a, b, h0)]
    with torch.no_grad():
        y, h = ops.linear_scan(*args)
    return y.cpu().numpy(), h.cpu().numpy()


# the sweep of tests/test_kernels.py:76-78, plus the no-h0 case
@pytest.mark.parametrize("B,S,C", [(2, 64, 128), (1, 256, 512),
                                   (3, 128, 256), (1, 512, 128)])
@pytest.mark.parametrize("b_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [True, False])
def test_plain_version_matches_jax_kernel_and_oracle(B, S, C, b_dtype,
                                                     with_h0):
    a, b, h0 = make_inputs(B, S, C, b_dtype=b_dtype)
    if not with_h0:
        h0 = None
    y, h = run_port(a, b, h0)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if with_h0:
        outs = {"interpret": _jax_interpret(ja, jb, jnp.asarray(h0)),
                "ref": _jax_ref(ja, jb, jnp.asarray(h0))}
    else:
        outs = {"interpret": _jax_interpret_no_h0(ja, jb),
                "ref": _jax_ref_no_h0(ja, jb)}
    for name, (ye, he) in outs.items():
        assert y.shape == ye.shape and h.shape == he.shape, name
        np.testing.assert_allclose(y, np.asarray(ye), atol=ATOL, rtol=RTOL,
                                   err_msg=name)
        np.testing.assert_allclose(h, np.asarray(he), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


# any S: the Pallas kernel asks S % 256 == 0 past 256, so ragged lengths
# go against the oracle only
@pytest.mark.parametrize("B,S,C", [(1, 1, 64), (2, 257, 96), (4, 100, 33),
                                   (1, 700, 8)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_plain_version_matches_jax_oracle_any_length(B, S, C, with_h0):
    a, b, h0 = make_inputs(B, S, C, seed=1)
    if not with_h0:
        h0 = None
    y, h = run_port(a, b, h0)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ye, he = (_jax_ref_no_h0(ja, jb) if h0 is None
              else _jax_ref(ja, jb, jnp.asarray(h0)))
    np.testing.assert_allclose(y, np.asarray(ye), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(h, np.asarray(he), atol=ATOL, rtol=RTOL)


def test_h_last_is_the_last_step_and_h0_carries():
    """Scanning [0, S) equals scanning [0, k) and then [k, S) from the
    first half's h_last."""
    a, b, h0 = (torch.from_numpy(x) for x in make_inputs(2, 50, 16))
    y, h = ref.linear_scan(a, b, h0)
    assert torch.equal(h, y[:, -1])
    y1, h1 = ref.linear_scan(a[:, :20], b[:, :20], h0)
    y2, h2 = ref.linear_scan(a[:, 20:], b[:, 20:], h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=0, rtol=0)
    torch.testing.assert_close(h2, h, atol=0, rtol=0)


def test_wrapper_takes_plain_version_for_cpu_tensors_only():
    a, b, h0 = (torch.from_numpy(x) for x in make_inputs(2, 30, 16))
    before = ops.LAUNCHES
    y, h = ops.linear_scan(a, b, h0)
    ye, he = ref.linear_scan(a, b, h0)
    assert torch.equal(y, ye) and torch.equal(h, he)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.linear_scan(a.to("meta"), b.to("meta"))


def _good(B=2, S=10, C=8):
    return torch.zeros(B, S, C), torch.zeros(B, S, C), torch.zeros(B, C)


@pytest.mark.parametrize("bad,match", [
    (lambda a, b, h: (a[0], b[0], h), "must be \\(B, S, C\\)"),
    (lambda a, b, h: (a, b[:, :3], h), "b "),
    (lambda a, b, h: (a, b, h[:, :3]), "h0"),
    (lambda a, b, h: (a.bfloat16(), b.bfloat16(), h), "float32"),
    (lambda a, b, h: (a, b, h.double()), "float32"),
    (lambda a, b, h: (a[:, :0], b[:, :0], h), ">= 1"),
    (lambda a, b, h: (a.transpose(0, 1).contiguous().transpose(0, 1), b, h),
     "contiguous"),
    (lambda a, b, h: (a, b.requires_grad_(), h), "no backward"),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    with pytest.raises((ValueError, TypeError, RuntimeError), match=match):
        ops._check(*bad(*_good()))


def test_kernel_wrapper_accepts_the_main_path_shapes():
    a, b, h0 = _good(B=1, S=257, C=4096)
    ops._check(a, b, None)  # the model's prefill passes no h0
    ops._check(a, b, h0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,C", [(1, 4096, 4096), (4, 257, 4096),
                                   (1, 1, 4096), (3, 100, 33)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_cuda_kernel_matches_plain_version(B, S, C, with_h0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b, h0 = make_inputs(B, S, C, seed=2)
    if not with_h0:
        h0 = None
    before = ops.LAUNCHES
    y, h = run_port(a, b, h0, device="cuda")
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    ye, he = run_port(a, b, h0)
    np.testing.assert_allclose(y, ye, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(h, he, atol=2e-5, rtol=2e-5)
