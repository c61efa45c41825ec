"""RG-LRU linear scan: the port's plain version against the JAX
package's Pallas kernel (interpret mode) and its oracle, with and
without h0, the wrapper's checks, and (on a card) the CUDA kernel
against the plain version. The kernel's order (chunk aggregates, a
forward recursion over them, a rescan; ``ref.linear_scan_chunked``) is
held against the JAX package too, and against float64 on inputs with
long memory, where two float32 orders round apart."""

import functools

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
    (lambda a, b, h: (a, b, h.to("meta")), "h0 is on meta"),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    with pytest.raises((ValueError, TypeError, RuntimeError), match=match):
        ops._check(*bad(*_good()))


def test_kernel_wrapper_takes_a_gradient_and_checks_the_cotangents():
    """Inputs that need a gradient are taken (the backward kernel runs on
    the card); the backward's cotangents are checked as the inputs."""
    a, b, h0 = _good()
    ops._check(a.requires_grad_(), b.requires_grad_(), h0.requires_grad_())
    ops._check(a, a, h0, [("g_y", b), ("g_last", h0)])
    with pytest.raises(ValueError, match="g_last"):
        ops._check(a, a, h0, [("g_y", b), ("g_last", b)])
    with pytest.raises(TypeError, match="g_y must be float32"):
        ops._check(a, a, None, [("g_y", b.double()), ("g_last", None)])


def test_backward_takes_plain_version_for_cpu_tensors_only():
    a, b, h0 = (torch.from_numpy(x) for x in make_inputs(2, 40, 16))
    y, _ = ref.linear_scan(a, b, h0)
    g_y, g_last = torch.randn(2, 40, 16), torch.randn(2, 16)
    before = ops.BWD_LAUNCHES
    got = ops.linear_scan_bwd(a, y, h0, g_y, g_last)
    want = ref.linear_scan_bwd(a, y, h0, g_y, g_last)
    assert all(torch.equal(x, w) for x, w in zip(got, want))
    assert ops.BWD_LAUNCHES == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.linear_scan_bwd(*(t.to("meta") for t in (a, y, h0, g_y)))


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


# ---------------------------------------------------- the kernel's order
L, CT = ops.TILE_STEPS, ops.TILE_CHANNELS
# chunk lengths: one step, the kernel's, the whole sequence, and one that
# leaves a short last chunk at every S below
CHUNKS = {"one": lambda S: 1, "kernel": lambda S: L, "whole": lambda S: S,
          "ragged": lambda S: L + 7}


@functools.lru_cache(maxsize=None)
def _jax_outputs(B, S, C, b_dtype, with_h0):
    """The JAX Pallas kernel's (interpret mode) and oracle's (y, h_last)
    on make_inputs(B, S, C), as numpy."""
    a, b, h0 = make_inputs(B, S, C, b_dtype=b_dtype)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if with_h0:
        outs = {"interpret": _jax_interpret(ja, jb, jnp.asarray(h0)),
                "ref": _jax_ref(ja, jb, jnp.asarray(h0))}
    else:
        outs = {"interpret": _jax_interpret_no_h0(ja, jb),
                "ref": _jax_ref_no_h0(ja, jb)}
    return {k: tuple(np.asarray(x) for x in v) for k, v in outs.items()}


@pytest.mark.parametrize("B,S,C", [(2, 64, 128), (1, 256, 512),
                                   (3, 128, 256), (1, 512, 128)])
@pytest.mark.parametrize("b_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("chunk", sorted(CHUNKS))
def test_chunked_order_matches_jax_kernel_and_oracle(B, S, C, b_dtype,
                                                     with_h0, chunk):
    a, b, h0 = make_inputs(B, S, C, b_dtype=b_dtype)
    args = [torch.from_numpy(a), torch.from_numpy(b),
            torch.from_numpy(h0) if with_h0 else None]
    y, h = ref.linear_scan_chunked(*args, chunk=CHUNKS[chunk](S))
    for name, (ye, he) in _jax_outputs(B, S, C, b_dtype, with_h0).items():
        np.testing.assert_allclose(y.numpy(), ye, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
        np.testing.assert_allclose(h.numpy(), he, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("B,S,C", [(1, 1, 64), (2, 257, 96), (4, 100, 33),
                                   (1, 700, 8)])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("chunk", ["kernel", "ragged"])
def test_chunked_order_matches_jax_oracle_any_length(B, S, C, with_h0,
                                                     chunk):
    a, b, h0 = make_inputs(B, S, C, seed=1)
    h0 = h0 if with_h0 else None
    y, h = ref.linear_scan_chunked(
        *(None if x is None else torch.from_numpy(x) for x in (a, b, h0)),
        chunk=CHUNKS[chunk](S))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ye, he = (_jax_ref_no_h0(ja, jb) if h0 is None
              else _jax_ref(ja, jb, jnp.asarray(h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(ye), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(he), atol=ATOL,
                               rtol=RTOL)
    assert torch.equal(h, y[:, -1])


def test_float64_plain_version_matches_numpy():
    a, b, h0 = make_inputs(2, 40, 24, seed=3)
    y, h = ref.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(h0), dtype=torch.float64)
    assert y.dtype == h.dtype == torch.float64
    expect = h0.astype(np.float64)
    for t in range(a.shape[1]):
        expect = a[:, t].astype(np.float64) * expect + b[:, t]
        np.testing.assert_array_equal(y[:, t].numpy(), expect)
    np.testing.assert_array_equal(h.numpy(), expect)


# Long memory: a fixed per channel in (0.9, 0.9999) raised to sigmoid of
# a normal draw per step (as the RG-LRU's a^(c r_t)), b normal and not
# scaled by sqrt(1 - a^2): |y| reaches about 100, and the sequential and
# chunked float32 orders each sit some 5e-7 (relative L2) from float64,
# apart from each other by as much. So the kernel's order is held against
# float64: its relative L2 distance e_k at most LONG_MEMORY_MARGIN times
# the sequential float32 order's e_p. Measured at C = 512, S = 4096,
# chunks of 32: e_k / e_p from 0.45 to 1.26 over seeds 0-11 (1.20 at seed
# 2 below); at C = 4096, 0.78 to 1.04 over seeds 0-2. chip_smoke.py holds
# the CUDA kernel to the same rule.
LONG_MEMORY_MARGIN = 1.5


def long_memory_inputs(B, S, C, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.9, 0.9999, (1, 1, C))
    z = rng.standard_normal((B, S, C))
    a = (base ** (1 / (1 + np.exp(-z)))).astype(np.float32)
    b = rng.standard_normal((B, S, C)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b)


def rel_l2(x, ref64):
    return float((x.double() - ref64).norm() / ref64.norm())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunked_order_long_memory_vs_float64(seed):
    a, b = long_memory_inputs(1, 4096, 512, seed)
    y64, h64 = ref.linear_scan(a, b, dtype=torch.float64)
    y32, _ = ref.linear_scan(a, b)
    yk, hk = ref.linear_scan_chunked(a, b, chunk=L)
    assert float(y64.abs().max()) > 50  # the memory is long
    e_p, e_k = rel_l2(y32, y64), rel_l2(yk, y64)
    assert e_k <= LONG_MEMORY_MARGIN * e_p, (e_k, e_p)
    # an elementwise comparison of the two float32 orders is no gate here
    assert float((yk - y32).abs().max()) > 3e-5


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, L - 1, L, L + 1, 2 * L + 1, 4097])
@pytest.mark.parametrize("C", [1, 33, CT - 1, CT, CT + 1, 4096])
def test_cuda_kernel_tile_edges(S, C):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for B, with_h0 in ((1, True), (1, False), (3, True), (3, False)):
        a, b, h0 = make_inputs(B, S, C, seed=4)
        h0 = h0 if with_h0 else None
        y, h = run_port(a, b, h0, device="cuda")
        ye, he = run_port(a, b, h0)
        np.testing.assert_allclose(y, ye, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(h, he, atol=2e-5, rtol=2e-5)
        np.testing.assert_array_equal(h, y[:, -1])


@pytest.mark.gpu
def test_cuda_kernel_is_bit_identical_from_launch_to_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(5)
    a = torch.rand(4, 4096, 4096, generator=g, device="cuda") * 0.5 + 0.5
    b = torch.randn(4, 4096, 4096, generator=g, device="cuda")
    with torch.no_grad():
        y0, h0 = ops.linear_scan(a, b)
        for _ in range(19):
            y, h = ops.linear_scan(a, b)
            assert torch.equal(y, y0) and torch.equal(h, h0)


@pytest.mark.gpu
def test_cuda_kernel_runs_in_the_chunked_order():
    """The kernel against its order in plain PyTorch, on the card: equal
    but for fmaf ties that the plain version's float64 rounds twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert ops.tile() == (L, CT)
    a, b = (x.cuda() for x in long_memory_inputs(2, 1000, 300, 6))
    h0 = torch.randn(2, 300, device="cuda")
    with torch.no_grad():
        y, h = ops.linear_scan(a, b, h0)
    ye, he = ref.linear_scan_chunked(a, b, h0, chunk=L)
    torch.testing.assert_close(y, ye, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(h, he, atol=1e-6, rtol=1e-6)
