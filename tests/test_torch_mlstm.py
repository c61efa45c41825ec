"""Chunkwise mLSTM: the port's plain version against the JAX package's
Pallas kernel (interpret mode) and its oracle, ragged lengths against the
reference model's plain route, the wrapper's checks, and (on a card) the
CUDA kernel against the plain version."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.mlstm import kernel as jkernel  # noqa: E402
from repro.kernels.mlstm import ref as jref  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch.kernels.mlstm import ops, ref  # noqa: E402

# the reference's own tolerance for this kernel (tests/test_kernels.py:115)
ATOL = 2e-5
# a ragged S against the reference's single chunk of S rows: the same
# function summed in other orders and chunks
RAGGED_ATOL = 1e-4

# the shapes of tests/test_kernels.py:101-102
KERNEL_SHAPES = [(2, 128, 64, 64), (4, 64, 32, 32), (1, 256, 128, 64)]


def make_inputs(BH, S, hd, seed=0):
    """The distributions of tests/test_kernels.py:107-112, from numpy:
    q, v normal, k normal / sqrt(hd), log_i 0.5 normal, log_f
    log_sigmoid(normal + 2)."""
    rng = np.random.default_rng(seed * 7919 + BH * 1000 + S + hd)
    q = rng.standard_normal((BH, S, hd)).astype(np.float32)
    k = (rng.standard_normal((BH, S, hd)) / np.sqrt(hd)).astype(np.float32)
    v = rng.standard_normal((BH, S, hd)).astype(np.float32)
    li = (rng.standard_normal((BH, S)) * 0.5).astype(np.float32)
    lf = (-np.logaddexp(0.0, -(rng.standard_normal((BH, S)) + 2.0))
          ).astype(np.float32)
    return q, k, v, li, lf


def model_layout(x, B, H):
    """(B*H, S, ...) -> (B, S, H, ...)."""
    BH, S = x.shape[:2]
    return np.ascontiguousarray(
        np.moveaxis(x.reshape(B, H, S, *x.shape[2:]), 1, 2))


def run_plain(*arrays, chunk):
    with torch.no_grad():
        h, (C, n, m) = ref.mlstm_chunkwise(
            *(torch.from_numpy(a) for a in arrays), chunk=chunk)
    return h.numpy(), C.numpy(), n.numpy(), m.numpy()


@pytest.mark.parametrize("BH,S,hd,chunk", KERNEL_SHAPES)
def test_plain_version_matches_jax_kernel_and_oracle(BH, S, hd, chunk):
    arrays = make_inputs(BH, S, hd)
    ours = run_plain(*arrays, chunk=chunk)
    j = [jnp.asarray(a) for a in arrays]
    h, (C, n, m) = jkernel.mlstm_chunkwise(*j, chunk=chunk, interpret=True)
    he, (Ce, ne, me) = jref.mlstm_chunkwise(*j, chunk=chunk)
    for name, expect in (("interpret", (h, C, n, m)),
                         ("oracle", (he, Ce, ne, me))):
        for label, a, e in zip("hCnm", ours, expect):
            assert a.shape == e.shape, (name, label)
            np.testing.assert_allclose(a, np.asarray(e), atol=ATOL, rtol=0,
                                       err_msg=f"{name} {label}")


@pytest.mark.parametrize("B,S,H,hd,chunk", [
    (2, 100, 4, 32, 64),   # chunks 64 + 36; the reference: one of 100
    (1, 300, 4, 32, 256),  # 256 + 44; the reference: one of 300
    (2, 257, 2, 64, 256),  # a last chunk of one row
    (3, 1, 4, 32, 256),    # a single step
])
def test_ragged_lengths_match_the_reference_models_plain_route(B, S, H, hd,
                                                              chunk):
    """Any S against the reference model's plain route
    (``repro/models/recurrent.py:229-230``), which takes one chunk of S
    rows where S % chunk != 0. h is the same function; the state is the
    same up to the stabilizer's scale, so C and n are compared as
    C * exp(m - m_ref)."""
    q, k, v, li, lf = make_inputs(B * H, S, hd, seed=1)
    arrays = [model_layout(x, B, H) for x in (q, k, v, li, lf)]
    with torch.no_grad():
        h, (C, n, m) = ops.mlstm_chunkwise(
            *(torch.from_numpy(a) for a in arrays), chunk=chunk)
    he, (Ce, ne, me) = jrec.mlstm_chunkwise(
        *(jnp.asarray(a) for a in arrays), chunk=chunk)
    np.testing.assert_allclose(h.numpy(), np.asarray(he), atol=RAGGED_ATOL,
                               rtol=0)
    scale = np.exp(m.numpy() - np.asarray(me))  # (B, H)
    np.testing.assert_allclose(C.numpy() * scale[..., None, None],
                               np.asarray(Ce), atol=RAGGED_ATOL,
                               rtol=RAGGED_ATOL)
    np.testing.assert_allclose(n.numpy() * scale[..., None], np.asarray(ne),
                               atol=RAGGED_ATOL, rtol=RAGGED_ATOL)
    if S <= chunk:  # one chunk on both sides: the same stabilizer
        np.testing.assert_allclose(m.numpy(), np.asarray(me), atol=ATOL,
                                   rtol=0)


def test_chunk_size_does_not_change_h_or_the_scaled_state():
    """The chunkwise form is exact: h and C * exp(m) do not depend on
    the chunk length, short last chunks included."""
    arrays = make_inputs(2, 150, 32, seed=2)
    base = run_plain(*arrays, chunk=150)
    for chunk in (1, 16, 64, 100, 256):
        h, C, n, m = run_plain(*arrays, chunk=chunk)
        scale = np.exp(m - base[3])
        np.testing.assert_allclose(h, base[0], atol=RAGGED_ATOL, rtol=0)
        np.testing.assert_allclose(C * scale[:, None, None], base[1],
                                   atol=RAGGED_ATOL, rtol=RAGGED_ATOL)
        np.testing.assert_allclose(n * scale[:, None], base[2],
                                   atol=RAGGED_ATOL, rtol=RAGGED_ATOL)


def test_fresh_state_and_extreme_gates_stay_finite():
    """The fresh m is -1e30 and the causal mask -inf: neither may give a
    NaN, with input gates far apart and forget gates near 1."""
    BH, S, hd = 2, 40, 32
    q, k, v, li, lf = make_inputs(BH, S, hd, seed=3)
    li[0, ::3] = 40.0
    li[1, ::5] = -40.0
    lf[1] = 0.0  # forget nothing
    for chunk in (1, 16, 40, 64):
        h, C, n, m = run_plain(q, k, v, li, lf, chunk=chunk)
        for x in (h, C, n, m):
            assert np.isfinite(x).all(), chunk
    he, (Ce, ne, me) = jref.mlstm_chunkwise(
        *(jnp.asarray(a) for a in (q, k, v, li, lf)), chunk=S)
    h, C, n, m = run_plain(q, k, v, li, lf, chunk=S)
    # the cumulative log-forget is summed in other orders (JAX's float32
    # cumsum, an exactly rounded one here) and exp(40) magnifies that
    np.testing.assert_allclose(h, np.asarray(he), atol=RAGGED_ATOL,
                               rtol=1e-3)
    np.testing.assert_allclose(m, np.asarray(me), atol=ATOL, rtol=0)


def test_the_references_state_overflow_is_mirrored():
    """The reference's carried stabilizer m' = max(total_f + m,
    max_j (b_j + log_i_j)) does not bound the key decay exponent
    total_f - b_j + log_i_j - m' (ROADMAP.md section 3): a forget gate of
    exp(-100) on a chunk's first row overflows C and n, while h stays
    finite. The port keeps the reference's m, which decode carries on,
    so it overflows at the same place."""
    q, k, v, li, lf = make_inputs(1, 4, 32, seed=3)
    li[:] = 0.0
    lf[:] = -0.5
    lf[0, 0] = -100.0
    he, (Ce, ne, me) = jref.mlstm_chunkwise(
        *(jnp.asarray(a) for a in (q, k, v, li, lf)), chunk=4)
    h, C, n, m = run_plain(q, k, v, li, lf, chunk=4)
    np.testing.assert_allclose(h, np.asarray(he), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(m, np.asarray(me))
    assert not np.isfinite(np.asarray(Ce)).all()
    np.testing.assert_array_equal(np.isfinite(C), np.isfinite(np.asarray(Ce)))


def test_init_state_is_the_references():
    C, n, m = ref.init_state(3, 8)
    Ce, ne, me = jref.init_state(3, 8)
    for a, e in ((C, Ce), (n, ne), (m, me)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))


def test_bfloat16_inputs_give_h_in_bfloat16_and_state_in_float32():
    q, k, v, li, lf = make_inputs(2, 70, 32, seed=4)
    bf = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    h, (C, n, m) = ref.mlstm_chunkwise(*bf, torch.from_numpy(li),
                                       torch.from_numpy(lf), chunk=32)
    assert h.dtype == torch.bfloat16
    assert C.dtype == n.dtype == m.dtype == torch.float32
    he, _ = ref.mlstm_chunkwise(*(t.float() for t in bf),
                                torch.from_numpy(li), torch.from_numpy(lf),
                                chunk=32)
    assert torch.equal(h, he.bfloat16())


def _model_inputs(B=2, S=30, H=4, hd=32, seed=5):
    return [torch.from_numpy(model_layout(x, B, H))
            for x in make_inputs(B * H, S, hd, seed=seed)]


def test_wrapper_takes_plain_version_for_cpu_tensors_only():
    q, k, v, li, lf = _model_inputs()
    before = ops.LAUNCHES
    h, (C, n, m) = ops.mlstm_chunkwise(q, k, v, li, lf, chunk=16)
    assert ops.LAUNCHES == before
    B, S, H, hd = q.shape
    he, (Ce, ne, me) = ref.mlstm_chunkwise(
        *(x.movedim(2, 1).reshape(B * H, S, -1) for x in (q, k, v)),
        *(x.movedim(2, 1).reshape(B * H, S) for x in (li, lf)), chunk=16)
    assert torch.equal(h, he.reshape(B, H, S, hd).movedim(1, 2))
    assert torch.equal(C, Ce.reshape(B, H, hd, hd))
    assert torch.equal(n, ne.reshape(B, H, hd))
    assert torch.equal(m, me.reshape(B, H))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.mlstm_chunkwise(*(x.to("meta") for x in (q, k, v, li, lf)))
    with pytest.raises(NotImplementedError, match="fresh state"):
        ops.mlstm_chunkwise(q, k, v, li, lf, state=(C, n, m))


def test_route_sends_bf16_to_tensor_cores_and_f32_to_cuda_cores():
    assert ops.route(torch.bfloat16) == "tensor_core"
    assert ops.route(torch.float32) == "cuda_core"
    assert ops.TENSOR_CORE_KERNELS == ("scores", "states", "outputs")


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_route_refuses_what_no_kernel_takes(dtype):
    with pytest.raises(TypeError, match="the kernel takes"):
        ops.route(dtype)


def test_backward_route_sends_bf16_to_tensor_cores_and_f32_to_cuda_cores():
    assert ops.bwd_route(torch.bfloat16) == "tensor_core"
    assert ops.bwd_route(torch.float32) == "cuda_core"


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_backward_route_refuses_what_no_kernel_takes(dtype):
    with pytest.raises(TypeError, match="the kernel takes"):
        ops.bwd_route(dtype)


def test_backward_kernels_name_both_routes():
    """The tensor-core route's own kernels (after the forward's gates,
    states and scores): y = C u, dW, the dC walk, the three products, and
    the dn walk and the gates on the CUDA cores; the CUDA-core route's as
    before."""
    assert ops.BACKWARD_KERNELS == {
        "cuda_core": ("values", "dstate", "dweights", "dq", "dk", "dv",
                      "dgates"),
        "tensor_core": ("cu", "dweights", "dstate", "dq", "dk", "dv", "dn",
                        "dgates")}


def _good(B=1, S=10, H=4, hd=64):
    return (torch.zeros(B, S, H, hd), torch.zeros(B, S, H, hd),
            torch.zeros(B, S, H, hd), torch.zeros(B, S, H),
            torch.zeros(B, S, H))


@pytest.mark.parametrize("bad,match", [
    (lambda q, k, v, i, f: (q[0], k, v, i, f, 64), "must be \\(B, S, H, hd\\)"),
    (lambda q, k, v, i, f: (q, k[:, :3], v, i, f, 64), "k "),
    (lambda q, k, v, i, f: (q, k, v[..., :32], i, f, 64), "v "),
    (lambda q, k, v, i, f: (q, k, v, i[:, :3], f, 64), "log_i"),
    (lambda q, k, v, i, f: (q, k, v, i, f.bfloat16(), 64), "float32"),
    (lambda q, k, v, i, f: (q.double(), k.double(), v.double(), i, f, 64),
     "float32 or bfloat16"),
    (lambda q, k, v, i, f: (q, k.bfloat16(), v, i, f, 64), "k is"),
    (lambda q, k, v, i, f: (q[..., :48], k[..., :48], v[..., :48], i, f,
                            64), "multiples of 32"),
    (lambda q, k, v, i, f: (q, k, v, i, f, 257), "chunk"),
    (lambda q, k, v, i, f: (q, k, v, i, f, 0), "chunk"),
    (lambda q, k, v, i, f: (q[:, :0], k[:, :0], v[:, :0], i[:, :0],
                            f[:, :0], 64), ">= 1"),
    (lambda q, k, v, i, f: (q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v, i, f, 64), "contiguous"),
    (lambda q, k, v, i, f: (q, k, v.bfloat16(), i, f, 64), "v is"),
    (lambda q, k, v, i, f: (torch.zeros(q.numel() + 1)[1:].view(q.shape),
                            k, v, i, f, 64), "aligned"),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    with pytest.raises((ValueError, TypeError, RuntimeError), match=match):
        ops._check(*bad(*_good()))


@pytest.mark.parametrize("bad,match", [
    (lambda g: g[:, :5], "g_h "), (lambda g: g.bfloat16(), "g_h is"),
    (lambda g: g.transpose(1, 2).contiguous().transpose(1, 2),
     "g_h must be contiguous")])
def test_kernel_wrapper_rejects_a_cotangent_unlike_q(bad, match):
    """The backward's cotangent of h is checked as q is: shape, type,
    layout."""
    q, k, v, li, lf = _good()
    with pytest.raises((ValueError, TypeError), match=match):
        ops._check(q, k, v, li, lf, 64, bad(torch.zeros_like(q)))


def test_cpu_wrapper_differentiates_through_the_plain_version():
    """On the CPU the wrapper under grad is autograd through the plain
    forward: its gradient is ``mlstm_chunkwise_bwd``'s (the plain
    backward, which the CPU entry takes), in the model's layout."""
    B, S, H, hd = 2, 40, 2, 32
    arrays = [torch.from_numpy(model_layout(x, B, H))
              for x in make_inputs(B * H, S, hd, seed=4)]
    leaves = [x.clone().requires_grad_() for x in arrays]
    g = torch.randn(B, S, H, hd, generator=torch.Generator().manual_seed(0))
    h, _ = ops.mlstm_chunkwise(*leaves, chunk=16)
    got = torch.autograd.grad(h, leaves, g)
    want = ops.mlstm_chunkwise_bwd(*arrays, g, chunk=16)
    assert ops.LAUNCHES == 0 and ops.BWD_LAUNCHES == 0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5


def test_state_cotangent_is_refused():
    """The CUDA autograd function takes a cotangent of h only: one of C, n
    or m raises before anything is launched."""
    ctx = type("Ctx", (), {"chunk": 64})()
    zero = torch.zeros(1)
    for i in range(3):
        cot = [None, None, None]
        cot[i] = zero
        with pytest.raises(ValueError, match="no gradient through the "
                                             "returned state"):
            ops._Mlstm.backward(ctx, zero, *cot)
    assert ops._Mlstm.backward(ctx, None, None, None, None) == (None,) * 6


def test_kernel_wrapper_accepts_the_main_path_shapes():
    """xLSTM-1.3B at full width: H = 4, hd = 1024, chunk 256, any S."""
    for S in (1, 257, 4096):
        q, k, v, li, lf = _good(B=1, S=S, H=4, hd=1024)
        ops._check(q.bfloat16(), k.bfloat16(), v.bfloat16(), li, lf, 256)
    ops._check(*_good(B=2, S=21, H=4, hd=32), 256)  # the small model


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,hd,chunk", [
    (1, 4096, 4, 1024, 256), (1, 3000, 4, 1024, 256), (2, 257, 4, 32, 256),
    (1, 1, 4, 1024, 256), (2, 128, 1, 64, 64), (3, 100, 2, 128, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(B, S, H, hd, chunk, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    arrays = [torch.from_numpy(model_layout(x, B, H)).cuda()
              for x in make_inputs(B * H, S, hd, seed=6)]
    q, k, v = (x.to(getattr(torch, dtype)) for x in arrays[:3])
    li, lf = arrays[3:]
    before = ops.LAUNCHES
    with torch.no_grad():
        h, (C, n, m) = ops.mlstm_chunkwise(q, k, v, li, lf, chunk=chunk)
        torch.cuda.synchronize()
        assert ops.LAUNCHES == before + 1
        he, (Ce, ne, me) = ops._plain(q, k, v, li, lf, chunk)
    assert h.dtype == q.dtype
    rel = float(torch.linalg.vector_norm(h.float() - he.float())
                / torch.linalg.vector_norm(he.float()))
    assert rel <= 1e-4
    if dtype == "bfloat16":
        # h rounds to bf16 on both sides: a rounding step is 2^-8 |h|, so
        # the reference's 2e-2 holds at unit scale and relatively above
        err = (h.float() - he.float()).abs() / he.float().abs().clamp_min(1)
        assert float(err.max()) <= 2e-2
    elif hd <= 128:
        torch.testing.assert_close(h, he, atol=ATOL, rtol=0)
    for a, e in ((C, Ce), (n, ne), (m, me)):
        rel = float(torch.linalg.vector_norm(a - e)
                    / torch.linalg.vector_norm(e))
        assert rel <= 1e-4


# the tensor-core route's tile edges (as chip_smoke.py's phase 9): 128 rows
# a score or output tile, 64 keys a W v step, 16 rows a states step, 64
# head-dim columns a TMA box, 128 (d, e) a states tile, 256 value columns
# an output tile
EDGE_LENGTHS = (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 255, 256, 257,
                383, 511, 513)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [32, 96, 160, 288])
def test_cuda_tensor_core_route_matches_plain_version_on_tile_edges(hd):
    """bf16: every S of the edges and chunks of 256, 100 and 64 rows, at
    B = 2, H = 3, against the plain version at the kernel's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for S, chunk in itertools.product(EDGE_LENGTHS, (256, 100, 64)):
        arrays = [torch.from_numpy(model_layout(x, 2, 3)).cuda()
                  for x in make_inputs(6, S, hd, seed=7)]
        q, k, v = (x.bfloat16() for x in arrays[:3])
        li, lf = arrays[3:]
        with torch.no_grad():
            h, state = ops.mlstm_chunkwise(q, k, v, li, lf, chunk=chunk)
            he, state_e = ops._plain(q, k, v, li, lf, chunk)
        err = (h.float() - he.float()).abs() / he.float().abs().clamp_min(1)
        assert float(err.max()) <= 2e-2, (S, chunk)
        for a, e in zip(state, state_e):
            rel = float(torch.linalg.vector_norm(a - e)
                        / torch.linalg.vector_norm(e))
            assert rel <= 1e-4, (S, chunk)


# the tensor-core backward's tiles: 128 rows a dW or product tile, 64 rows
# a chunk step, 128 rows a dC step, 64 head-dim columns a TMA box, 128 (d,
# e) a dC tile and 256 columns a product tile
@pytest.mark.gpu
@pytest.mark.parametrize("hd", [32, 96, 160, 288])
def test_cuda_tensor_core_backward_matches_plain_version_on_tile_edges(hd):
    """bf16: the backward on every S of the forward's edges and chunks of
    256, 100 and 64 rows, at B = 2, H = 3, against the plain version per
    tensor (max |a - b| / max |b|) at chip_smoke.py's 2e-2; one launch a
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert ops.bwd_route(torch.bfloat16) == "tensor_core"
    g = torch.Generator().manual_seed(8)
    for S, chunk in itertools.product(EDGE_LENGTHS, (256, 100, 64)):
        arrays = [torch.from_numpy(model_layout(x, 2, 3)).cuda()
                  for x in make_inputs(6, S, hd, seed=8)]
        q, k, v = (x.bfloat16() for x in arrays[:3])
        li, lf = arrays[3:]
        g_h = torch.randn(2, S, 3, hd, generator=g).cuda().bfloat16()
        before = ops.BWD_LAUNCHES
        got = ops.mlstm_chunkwise_bwd(q, k, v, li, lf, g_h, chunk=chunk)
        torch.cuda.synchronize()
        assert ops.BWD_LAUNCHES == before + 1
        want = ops._plain_bwd(q, k, v, li, lf, g_h, chunk)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            err = float((a.float() - b.float()).abs().max()
                        / b.float().abs().max().clamp_min(1e-30))
            assert err <= 2e-2, (S, chunk)
