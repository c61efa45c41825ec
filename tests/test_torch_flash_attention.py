"""Flash attention: the port's plain version against the JAX package's
Pallas kernel (interpret mode) and its oracle, the wrapper's checks,
and (on a card) the CUDA kernel against the plain version."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

# the reference's kernel tolerances (tests/test_kernels.py:13)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MASKS = [(True, 0), (True, 64), (False, 0)]

# jitted once per shape: eager JAX compiles every op of the call anew
_jax_interpret = jax.jit(
    lambda q, k, v, causal, window: jops.flash_attention(
        q, k, v, causal=causal, window=window, interpret=True),
    static_argnums=(3, 4))
_jax_ref = jax.jit(
    lambda q, k, v, causal, window: jnp.swapaxes(jref.attention(
        *(jnp.swapaxes(x, 1, 2) for x in (q, k, v)), causal=causal,
        window=window), 1, 2),
    static_argnums=(3, 4))


def make_inputs(B, H, KH, S, D, seed=0, T=None):
    """float32 numpy inputs in the model's layout: q (B, S, H, D), k/v
    (B, T, KH, D)."""
    T = S if T is None else T
    rng = np.random.default_rng(seed * 7919 + B * 1000 + H * 100 + S + D)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KH, D)).astype(np.float32)
    return q, k, v


def run_port(q, k, v, dtype, causal, window, device="cpu"):
    tdt = DTYPES[dtype][1]
    args = [torch.from_numpy(a).to(device=device, dtype=tdt)
            for a in (q, k, v)]
    with torch.no_grad():
        out = ops.flash_attention(*args, causal=causal, window=window)
    return out.float().cpu().numpy()


def run_jax(fn, q, k, v, dtype, causal, window):
    jdt = DTYPES[dtype][0]
    out = fn(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal, window)
    return np.asarray(out, np.float32)


# the sweep of tests/test_kernels.py:17-23
@pytest.mark.parametrize("B,H,KH,S,D", [
    (1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 4, 1, 128, 128),
    (1, 8, 4, 512, 64), (2, 2, 1, 256, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_version_matches_jax_kernel_and_oracle(B, H, KH, S, D, dtype,
                                                     causal, window):
    q, k, v = make_inputs(B, H, KH, S, D)
    out = run_port(q, k, v, dtype, causal, window)
    expect = {name: run_jax(fn, q, k, v, dtype, causal, window)
              for name, fn in (("interpret", _jax_interpret),
                               ("ref", _jax_ref))}
    tol = TOL[dtype]
    for name, e in expect.items():
        assert out.shape == e.shape, name
        np.testing.assert_allclose(out, e, atol=tol, rtol=tol, err_msg=name)


# MQA and ragged lengths: the Pallas kernel asks S % 512 == 0 past 512
# and blocks that divide S, so these go against the oracle only
@pytest.mark.parametrize("B,H,KH,S,D,window", [
    (1, 16, 1, 100, 64, 0), (2, 16, 1, 77, 16, 16), (1, 4, 1, 1, 256, 0),
    (2, 4, 2, 37, 32, 5), (1, 8, 8, 130, 128, 64), (1, 16, 1, 600, 16, 256),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_oracle_mqa_ragged(B, H, KH, S, D, window,
                                                    dtype):
    q, k, v = make_inputs(B, H, KH, S, D, seed=1)
    out = run_port(q, k, v, dtype, True, window)
    expect = run_jax(_jax_ref, q, k, v, dtype, True, window)
    np.testing.assert_allclose(out, expect, atol=TOL[dtype], rtol=TOL[dtype])


def test_plain_version_non_square_causal():
    """T != S (no caller in the model, but the kernel takes it): query i
    sees keys j <= i."""
    q, k, v = make_inputs(1, 4, 2, 20, 32, T=50)
    out = run_port(q, k, v, "float32", True, 0)
    expect = run_jax(_jax_ref, q, k, v, "float32", True, 0)
    np.testing.assert_allclose(out, expect, atol=TOL["float32"],
                               rtol=TOL["float32"])


def live_rows(S, T, window):
    """Causal query rows with at least one live key: row i sees keys
    max(0, i - window + 1) .. min(i, T - 1)."""
    rows = np.arange(S)
    return rows < T + window - 1 if window > 0 else np.ones(S, bool)


def test_plain_version_rows_without_a_live_key_match_jax_oracle():
    """With T < S and a window, rows i >= T + window - 1 have no live key.
    The plain version, as the JAX oracle, gives there the mean of v over
    all T keys (every score is -1e30); the CUDA kernels give 0 (see
    test_cuda_kernel_matches_plain_version_on_tile_edges)."""
    q, k, v = make_inputs(1, 4, 2, 40, 32, T=10)
    out = run_port(q, k, v, "float32", True, 5)
    expect = run_jax(_jax_ref, q, k, v, "float32", True, 5)
    np.testing.assert_allclose(out, expect, atol=TOL["float32"],
                               rtol=TOL["float32"])
    dead = ~live_rows(40, 10, 5)
    assert dead.sum() == 26
    mean_v = np.repeat(v.mean(axis=1), 2, axis=1)  # (1, H, D): kv head h // 2
    np.testing.assert_allclose(out[:, dead], np.broadcast_to(
        mean_v[:, None], out[:, dead].shape), atol=TOL["float32"])


@pytest.mark.parametrize("D", ops.HEAD_DIMS)
def test_route_sends_bf16_to_tensor_cores_and_f32_to_cuda_cores(D):
    assert ops.route(torch.bfloat16, D) == "tensor_core"
    assert ops.route(torch.float32, D) == "cuda_core"


def test_route_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="D in"):
        ops.route(torch.bfloat16, 96)
    with pytest.raises(TypeError):
        ops.route(torch.float16, 64)


def test_wrapper_takes_plain_version_for_cpu_tensors_only():
    q, k, v = (torch.from_numpy(a) for a in make_inputs(1, 4, 2, 33, 16))
    before = ops.LAUNCHES
    out = ops.flash_attention(q, k, v, window=8)
    tr = lambda x: x.transpose(1, 2)  # noqa: E731
    expect = ref.attention(tr(q), tr(k), tr(v), window=8)
    assert torch.equal(out, tr(expect))
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def _good(B=2, H=4, KH=2, S=10, D=16):
    """Inputs the kernel takes, in the model's layout."""
    return (torch.zeros(B, S, H, D), torch.zeros(B, S, KH, D),
            torch.zeros(B, S, KH, D))


@pytest.mark.parametrize("bad,match", [
    (lambda q, k, v: (q.double(), k.double(), v.double(), 0), "share"),
    (lambda q, k, v: (q, k.half(), v, 0), "share"),
    (lambda q, k, v: (q[0], k, v, 0), "must be"),
    (lambda q, k, v: (q, k[:1], v[:1], 0), "does not match"),
    (lambda q, k, v: (q, k, v[:, :, :1], 0), "v"),
    (lambda q, k, v: _good(KH=3) + (0,), "multiple of KH"),
    (lambda q, k, v: _good(D=48) + (0,), "D in"),
    (lambda q, k, v: (q, k[:, :0], v[:, :0], 0), "T >= 1"),
    (lambda q, k, v: (q, k, v, -1), "window"),
    (lambda q, k, v: (torch.zeros(1, 1, 1, 256).expand(1, 2 ** 19, 16, 256),
                      torch.zeros(1, 8, 1, 256), torch.zeros(1, 8, 1, 256),
                      0), "32-bit"),
    (lambda q, k, v: (q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                      0), "contiguous"),
    # a gradient at a pair the backward does not take (the small
    # DeepSeek's (24, 16) in bfloat16; float32 has a backward there)
    (lambda q, k, v: (torch.zeros(2, 10, 4, 24, dtype=torch.bfloat16)
                      .requires_grad_(),
                      torch.zeros(2, 10, 2, 24, dtype=torch.bfloat16),
                      torch.zeros(2, 10, 2, 16, dtype=torch.bfloat16),
                      0), "no backward"),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    with pytest.raises((ValueError, TypeError, RuntimeError), match=match):
        ops._check(*bad(*_good()))


def test_kernel_wrapper_accepts_the_main_path_shapes():
    # the full-width prefill: B=1, H=16, KH=1, D=256 (S kept small here)
    ops._check(*_good(B=1, H=16, KH=1, S=64, D=256), 2048)
    ops._check(*(t.bfloat16() for t in _good(D=64)), 0)
    q, k, v = _good()
    with torch.no_grad():
        ops._check(q.requires_grad_(), k, v, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KH,S,D,window", [
    (1, 16, 1, 4096, 256, 2048), (2, 16, 16, 3000, 64, 0),
    (1, 4, 1, 100, 16, 16), (2, 8, 2, 1, 64, 0), (1, 4, 4, 257, 16, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(B, H, KH, S, D, window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = make_inputs(B, H, KH, S, D, seed=2)
    before = ops.LAUNCHES
    out = run_port(q, k, v, dtype, True, window, device="cuda")
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    tdt = DTYPES[dtype][1]
    qc, kc, vc = (torch.from_numpy(a).to("cuda", tdt).transpose(1, 2)
                  for a in (q, k, v))
    expect = ref.attention(qc, kc, vc, window=window).transpose(1, 2)
    np.testing.assert_allclose(out, expect.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


# the tensor-core kernel's tile edges: 128 query rows a block, 64 keys a
# tile, 64 rows a warpgroup; T != S included
EDGE_LENGTHS = (15, 63, 64, 65, 127, 128, 129, 191)
EDGE_WINDOWS = (0, 1, 64, 65)


@pytest.mark.gpu
@pytest.mark.parametrize("KH", [1, 4, 16])
@pytest.mark.parametrize("D", ops.HEAD_DIMS)
def test_cuda_kernel_matches_plain_version_on_tile_edges(KH, D):
    """bf16, B = 1, H = 16: every (S, T, window) of the edges against the
    plain version at 2e-2 on the rows with a live key; rows with none
    give exactly 0 (the plain version's mean of v there is
    test_plain_version_rows_without_a_live_key_match_jax_oracle)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for S, T, window in itertools.product(EDGE_LENGTHS, EDGE_LENGTHS,
                                          EDGE_WINDOWS):
        q, k, v = make_inputs(1, 16, KH, S, D, seed=3, T=T)
        out = run_port(q, k, v, "bfloat16", True, window, device="cuda")
        qc, kc, vc = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                      .transpose(1, 2) for a in (q, k, v))
        expect = ref.attention(qc, kc, vc, window=window).transpose(1, 2)
        expect = expect.float().cpu().numpy()
        rows = live_rows(S, T, window)
        label = f"S={S} T={T} window={window}"
        np.testing.assert_allclose(out[:, rows], expect[:, rows],
                                   atol=TOL["bfloat16"],
                                   rtol=TOL["bfloat16"], err_msg=label)
        assert not out[:, ~rows].any(), label
