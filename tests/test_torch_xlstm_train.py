"""xLSTM training in the port against the JAX package: the mLSTM's
gradient (``ref.mlstm_chunkwise_bwd``, the function of the backward
kernel of ``csrc/mlstm.cu``) against ``jax.vjp`` of the reference's
custom-VJP op and of its plain chunkwise form, against the port's own
autograd in float64, and on the reference's state overflow; the sLSTM
block's gradient against its former per-step writes; the small xLSTM's
loss and every gradient leaf against ``jax.value_and_grad(model.loss)``;
and its training golden file for the card.

The small model is ``xlstm-1.3b`` ``scaled_down(dtype="float32",
max_seq=512)``: 8 layers (7 mLSTM, 1 sLSTM), 327,680 parameters, trained
on ``TokenPipeline(256, 300, 2)`` batches. The port chunks the mLSTM by
256 rows with a short last chunk (256 + 44); the reference takes one
chunk of 300 rows there. Its parameters are the JAX package's, as
``xlstm_small_golden.npz`` holds them; the JAX run (one compile of
value-and-grad, one of AdamW) is computed once a module.

``src/repro_torch/assets/lm_train_xlstm_small_golden.npz`` holds, under
``xlstm-1.3b/``, the training configuration, three batches, the loss,
``ce`` and ``aux`` on the first, every gradient leaf at each of three
AdamW steps under ``cosine_schedule(1e-3, 1, 3)`` and the parameters after
them (the initial ones are ``xlstm_small_golden.npz``'s). Regenerate it
(about 30 s on a CPU) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_xlstm_train.py --write
"""

import dataclasses
import functools
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_train import (GRAD_RTOL, LOSS_RTOL, PARAMS_ATOL,  # noqa: E402
                                 PEAK, SEED, STEPS, WARMUP, flat_np,
                                 flat_port, golden_payload, port_params,
                                 rel)

ASSETS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "assets"
GOLDEN = ASSETS / "lm_train_xlstm_small_golden.npz"
ARCH = "xlstm-1.3b"
B, S = 2, 300  # the small model's batch: chunks of 256 + 44 in the port
MAX_SEQ = 512
# Three float32 gradients and the parameters after, 327,680 values each,
# take about 5 MB after deflate
GOLDEN_BYTES = 6 << 20

# The mLSTM's gradient against JAX, per tensor: max |a - b| / max |b|.
# Elementwise, |a - b| <= tol (1 + |b|) cannot hold it: |dk| runs into
# the thousands, and both float32 evaluations sit alike far from a
# float64 one.
BWD_RTOL = 1e-4
# The plain backward in float64 against autograd through the plain
# forward in float64: the same function, so the formulas are held, not
# the rounding
F64_RTOL = 1e-10
# (BH, S, hd, chunk): chunks of 16 and 64 rows, a short last chunk
# (300 = 256 + 44, where the reference takes one chunk of 300), one row
BWD_SHAPES = ((4, 96, 32, 16), (2, 256, 64, 64), (1, 300, 32, 256),
              (1, 1, 32, 64))
NAMES = ("dq", "dk", "dv", "dlog_i", "dlog_f")


def config(pkg):
    if pkg == "jax":
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    return get_config(ARCH).scaled_down(dtype="float32", max_seq=MAX_SEQ)


def init_params():
    """The JAX package's initial parameters as a numpy tree, from
    ``xlstm_small_golden.npz``."""
    from repro_torch.models.params import XLSTM_GOLDEN_PATH, load_lm_golden
    from repro_torch.models.transformer import tree_map

    return tree_map(lambda t: t.numpy(), load_lm_golden(XLSTM_GOLDEN_PATH).params)


def jax_run():
    """The JAX package's three AdamW steps of the small xLSTM."""
    import jax

    from repro.data.tokens import TokenPipeline
    from repro.models.model_zoo import build_model
    from repro.optim.adamw import AdamW
    from repro.optim.schedule import cosine_schedule

    cfg = config("jax")
    model = build_model(cfg)
    opt = AdamW(lr=cosine_schedule(PEAK, WARMUP, STEPS))
    grad = jax.jit(jax.value_and_grad(model.loss, has_aux=True))
    update = jax.jit(opt.update)

    pipe = TokenPipeline(cfg.vocab_size, S, B, seed=SEED)
    batches = [pipe.batch_at(i) for i in range(STEPS)]
    params = init_params()
    p, st = params, opt.init(params)
    grads_at = []
    for i, batch in enumerate(batches):
        (loss, met), grads = grad(p, batch)
        p, st, _ = update(grads, st, p)
        grads_at.append(flat_np(grads))
        if i == 0:
            first = (float(loss), float(met["ce"]), float(met["aux"]))
    return {"cfg": cfg, "params": params,
            "tokens": np.stack([np.asarray(b["tokens"]) for b in batches]),
            "labels": np.stack([np.asarray(b["labels"]) for b in batches]),
            "loss": first[0], "ce": first[1], "aux": first[2],
            "grads": grads_at, "params_after": flat_np(p)}


def write(path: Path = GOLDEN) -> None:
    payload = {"adamw/peak": np.float64(PEAK),
               "adamw/warmup": np.int64(WARMUP),
               "adamw/steps": np.int64(STEPS)}
    payload.update(golden_payload(ARCH, jax_run()))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **payload)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


@pytest.fixture(scope="module")
def run():
    return jax_run()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, as ``test_torch_lm_train.py``: the suite runs in
    several workers on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke.py``'s helpers: the script touches no card at
    import."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------ the mLSTM
def bwd_inputs(BH, S_, hd, seed=0, log_i=None):
    """q, v normal, k normal / sqrt(hd), log_i normal (or ``log_i``
    everywhere), log_f log_sigmoid(N(3, 1)) and the cotangent of h
    normal; numpy float32. A single row (S = 1) gets log_i = -3, where
    the normaliser's floor exp(-m) wins: there h_0 = <q_0, k_0> exp(log_i)
    v_0 reaches every input. Where |den_0| wins instead, h_0 is
    sign(<q_0, k_0>) v_0 and only v has a gradient
    (``test_single_row_gradient_is_v_alone_where_den_wins``)."""
    rng = np.random.default_rng(seed * 7919 + BH * 1000 + S_ + hd)
    q, k, v = (rng.standard_normal((BH, S_, hd)).astype(np.float32)
               for _ in range(3))
    k /= np.float32(math.sqrt(hd))
    li = rng.standard_normal((BH, S_)).astype(np.float32)
    if log_i is not None or S_ == 1:
        li[:] = -3.0 if log_i is None else log_i
    lf = (-np.logaddexp(0.0, -rng.normal(3.0, 1.0, (BH, S_)))
          ).astype(np.float32)
    g = rng.standard_normal((BH, S_, hd)).astype(np.float32)
    return q, k, v, li, lf, g


@functools.lru_cache(maxsize=None)
def jax_vjps(chunk, pallas):
    """``jax.vjp`` of the reference's plain chunkwise form and, where S is
    a multiple of the chunk (``pallas``), of its custom-VJP op (the
    Pallas kernel in interpret mode), for the cotangent of h; jitted
    once a chunk."""
    import jax

    from repro.kernels.mlstm import ops as jops
    from repro.kernels.mlstm import ref as jref

    routes = {"oracle": lambda *a: jref.mlstm_chunkwise(*a, chunk=chunk)[0]}
    if pallas:
        routes["custom_vjp"] = lambda *a: jops._mlstm(*a, chunk, True)[0]

    def grads(q, k, v, li, lf, g):
        return {name: jax.vjp(fn, q, k, v, li, lf)[1](g)
                for name, fn in routes.items()}

    return jax.jit(grads)


def _rel(got, want):
    """max |a - b| / max |b| (0 where both are 0)."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _plain_bwd(arrays, chunk, dtype=torch.float32):
    from repro_torch.kernels.mlstm import ref

    return ref.mlstm_chunkwise_bwd(
        *(torch.from_numpy(x).to(dtype) for x in arrays), chunk=chunk)


@pytest.mark.parametrize("BH,S_,hd,chunk", BWD_SHAPES)
def test_mlstm_gradient_matches_jax(BH, S_, hd, chunk):
    """``ref.mlstm_chunkwise_bwd`` against ``jax.vjp`` of the reference's
    custom-VJP op (where its Pallas kernel takes S) and of its plain
    chunkwise form, per tensor at BWD_RTOL; the gates' gradients come in
    float32, the others in q's type."""
    arrays = bwd_inputs(BH, S_, hd)
    pallas = S_ % min(chunk, S_) == 0
    want = jax_vjps(chunk, pallas)(*arrays)
    assert set(want) == ({"oracle", "custom_vjp"} if pallas else {"oracle"})
    got = _plain_bwd(arrays, chunk)
    assert all(t.dtype == torch.float32 for t in got)
    for route, grads in want.items():
        for name, a, b in zip(NAMES, got, grads):
            assert a.shape == b.shape, name
            err = _rel(a.numpy(), np.asarray(b))
            assert err <= BWD_RTOL, (route, name, err)


@pytest.mark.parametrize("BH,S_,hd,chunk", BWD_SHAPES)
def test_mlstm_gradient_formulas_match_float64_autograd(BH, S_, hd, chunk):
    """In float64, the explicit formulas against autograd through the
    plain forward (which differentiates through every stabilizer's max:
    those terms sum to zero) at F64_RTOL."""
    from repro_torch.kernels.mlstm import ref

    arrays = bwd_inputs(BH, S_, hd, seed=1)
    leaves = [torch.from_numpy(x).double().requires_grad_()
              for x in arrays[:5]]
    g = torch.from_numpy(arrays[5]).double()
    h, _ = ref.mlstm_chunkwise(*leaves, chunk=chunk)
    want = torch.autograd.grad(h, leaves, g)
    got = _plain_bwd(arrays, chunk, torch.float64)
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == torch.float64, name
        assert _rel(a.numpy(), b.numpy()) <= F64_RTOL, name


def test_single_row_gradient_is_v_alone_where_den_wins():
    """S = 1 with log_i = 0.5: |den_0| = |<q_0, k_0>| beats exp(-m) =
    exp(-0.5), so h_0 = sign(<q_0, k_0>) v_0. The exact gradients of q, k
    and the gates are 0, and what either package returns there is
    rounding noise under 1e-6 of |dv|; dv = sign(<q_0, k_0>) g_0 within
    BWD_RTOL."""
    arrays = bwd_inputs(1, 1, 32, log_i=0.5)
    q, k, _, li, _, g = arrays
    assert abs(float((q * k).sum())) > math.exp(-0.5)
    want = jax_vjps(64, True)(*arrays)
    got = [t.numpy() for t in _plain_bwd(arrays, 64)]
    dv = np.sign((q * k).sum()) * g
    for grads in (got, *want.values()):
        grads = [np.asarray(x) for x in grads]
        assert _rel(grads[2], dv) <= BWD_RTOL
        for x in grads[:2] + grads[3:]:
            assert np.abs(x).max() <= 1e-6 * np.abs(dv).max()


def test_mlstm_gradient_mirrors_the_references_state_overflow():
    """ROADMAP.md section 3's overflow: one head, S = 4, chunk 4, log_i =
    0, log_f = [-100, -0.5, -0.5, -0.5]. Every key decay exp(total_f - b_j
    + log_i_j - m') overflows to inf, so C and n are inf; h stays
    finite. The gradient takes inf * 0 through the state's update (the
    state gets no cotangent), as the reference's does: dk, dv and both
    gates' gradients are NaN in every entry in both packages, dq finite
    and within BWD_RTOL."""
    q, k, v, li, lf, g = bwd_inputs(1, 4, 32, seed=3)
    li[:] = 0.0
    lf[:] = -0.5
    lf[0, 0] = -100.0
    arrays = (q, k, v, li, lf, g)
    want = jax_vjps(4, True)(*arrays)
    got = [t.numpy() for t in _plain_bwd(arrays, 4)]
    for route, grads in want.items():
        for name, a, b in zip(NAMES, got, grads):
            b = np.asarray(b)
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                          err_msg=f"{route} {name}")
            if name == "dq":
                assert np.isfinite(a).all()
                assert _rel(a, b) <= BWD_RTOL, route
            else:
                assert not np.isfinite(a).any(), name


@functools.lru_cache(maxsize=None)
def jax_h(chunk):
    """h of the reference's plain chunkwise form, jitted once a chunk."""
    import jax

    from repro.kernels.mlstm import ref as jref

    return jax.jit(lambda *a: jref.mlstm_chunkwise(*a, chunk=chunk)[0])


@pytest.mark.parametrize("BH,S_,hd,chunk", BWD_SHAPES)
def test_gh_identity_matches_g_dot_h(BH, S_, hd, chunk):
    """``ref.gh_dots``, <g_i, h_i> from G = u v^T and C u without h (the
    tensor-core backward's way), against <g_i, h_i> from h: the port's
    plain forward in float64 at F64_RTOL, and the reference's plain
    chunkwise form (one chunk of 300 rows where the port takes 256 + 44)
    in float32 at BWD_RTOL."""
    from repro_torch.kernels.mlstm import ref

    arrays = bwd_inputs(BH, S_, hd, seed=2)
    x64 = [torch.from_numpy(a).double() for a in arrays]
    h, _ = ref.mlstm_chunkwise(*x64[:5], chunk=chunk)
    got = ref.gh_dots(*x64, chunk=chunk)
    assert got.shape == (BH, S_) and got.dtype == torch.float64
    assert _rel(got.numpy(), (x64[5] * h).sum(2).numpy()) <= F64_RTOL
    got32 = ref.gh_dots(*(torch.from_numpy(a) for a in arrays), chunk=chunk)
    h_jax = np.asarray(jax_h(chunk)(*arrays[:5]))
    assert _rel(got32.numpy(), (arrays[5] * h_jax).sum(2)) <= BWD_RTOL


@pytest.mark.parametrize("BH,S_,hd,chunk", BWD_SHAPES)
def test_mlstm_gradient_by_the_identity_matches_jax_and_float64(BH, S_, hd,
                                                                chunk):
    """``ref.mlstm_chunkwise_bwd(gh="identity")`` (s_i from ``gh_dots``'
    identity, as the tensor-core route takes it) against the same with s_i
    from h in float64 at F64_RTOL, and against ``jax.vjp`` of the
    reference's plain form and custom-VJP op per tensor at BWD_RTOL."""
    arrays = bwd_inputs(BH, S_, hd, seed=4)
    exact = _plain_bwd(arrays, chunk, torch.float64)
    from repro_torch.kernels.mlstm import ref

    got64 = ref.mlstm_chunkwise_bwd(
        *(torch.from_numpy(x).double() for x in arrays), chunk=chunk,
        gh="identity")
    for name, a, b in zip(NAMES, got64, exact):
        assert _rel(a.numpy(), b.numpy()) <= F64_RTOL, name
    got = ref.mlstm_chunkwise_bwd(
        *(torch.from_numpy(x) for x in arrays), chunk=chunk, gh="identity")
    pallas = S_ % min(chunk, S_) == 0
    for route, grads in jax_vjps(chunk, pallas)(*arrays).items():
        for name, a, b in zip(NAMES, got, grads):
            assert _rel(a.numpy(), np.asarray(b)) <= BWD_RTOL, (route, name)


def test_mlstm_gradient_refuses_an_unknown_gh():
    from repro_torch.kernels.mlstm import ref

    arrays = [torch.from_numpy(x) for x in bwd_inputs(1, 8, 32)]
    with pytest.raises(ValueError, match="gh is"):
        ref.mlstm_chunkwise_bwd(*arrays, chunk=4, gh="norm")


# ------------------------------------------------------------ the sLSTM
def _slstm_per_step_writes(params, cfg, x):
    """``slstm_block`` in "train" mode as it was written before its steps
    were stacked: each step written into a preallocated tensor."""
    import torch.nn.functional as F

    from repro_torch.models import nn
    from repro_torch.models import recurrent as rec

    B_, S_, d = x.shape
    H = cfg.n_heads
    hd = d // H
    cx = F.silu(rec.conv1d_causal(params["conv"], x))
    pre = torch.stack([nn.linear(params["wz"], x), nn.linear(params["wi"], cx),
                       nn.linear(params["wf"], cx), nn.linear(params["wo"], x)],
                      dim=2)
    sd = nn.state_dtype(x.dtype)
    w_rec, b_rec = rec._slstm_recurrent(params, sd)
    pre = (pre.to(sd) + b_rec).reshape(B_, S_, 4, H, hd).permute(
        1, 3, 0, 2, 4).reshape(S_, H, B_, 4 * hd).contiguous()
    zeros = torch.zeros(H, B_, hd, dtype=sd)
    state = (zeros, zeros, zeros, torch.full_like(zeros, -1e30))
    hs = torch.empty(S_, H, B_, hd, dtype=sd)
    for t in range(S_):
        state = rec._slstm_cell(w_rec, pre[t], state)
        hs[t] = state[2]
    hs = hs.permute(2, 0, 1, 3).reshape(B_, S_, d).to(x.dtype)
    hs = nn.apply_norm(params["hnorm"], "rmsnorm", hs)
    return hs + nn.apply_mlp(params["ffn"], "geglu", hs)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-10)])
def test_slstm_gradient_matches_autograd_through_the_per_step_writes(
        smoke, dtype, rtol):
    """At S 300 ``slstm_block`` (under autograd, the scan with its
    backward written out) gives the former per-step writes' output bit
    for bit, and the gradient of x and of every parameter that autograd
    takes through them, leaf by leaf as max |a - b| / max |b| (the same
    function summed in another order); the exactly-zero ``ri/b`` by the
    global norm."""
    from repro_torch.common.tree import flatten, unflatten_as
    from repro_torch.models import recurrent as rec
    from repro_torch.models.params import lm_params

    cfg = config("torch")
    slstm = cfg.body_pattern.index("slstm")
    stacked = lm_params(init_params(), cfg, device="cpu")["body"][slstm]
    # the one body period's leaves
    params = unflatten_as(stacked["mix"], {k: v[0].to(dtype) for k, v in
                                           flatten(stacked["mix"]).items()})
    rng = np.random.default_rng(5)
    x0, cot = (torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)))
               .to(dtype) for _ in range(2))
    outs = []
    for fn in (lambda p, x: rec.slstm_block(p, cfg, x)[0],
               lambda p, x: _slstm_per_step_writes(p, cfg, x)):
        p = {k: v.clone().requires_grad_() for k, v in flatten(params).items()}
        x = x0.clone().requires_grad_()
        y = fn(unflatten_as(params, p), x)
        grads = torch.autograd.grad(y, [x, *p.values()], cot)
        outs.append((y.detach(), dict(zip(["x", *p], grads))))
    (y_new, g_new), (y_old, g_old) = outs
    assert torch.equal(y_new, y_old)
    norm = math.sqrt(sum(float(g.norm()) ** 2 for g in g_old.values()))
    for k, want in g_old.items():
        got = g_new[k]
        if smoke.lm_zero_grad_leaf(k):
            assert max(float(got.abs().max()),
                       float(want.abs().max())) / norm <= 1e-6, k
        else:
            assert _rel(got.numpy(), want.numpy()) <= rtol, k


# ------------------------------------------------------------ the model
def _check_grads(smoke, got, want, label):
    """Every leaf at GRAD_RTOL of its largest, but the leaf whose exact
    gradient is 0 (``chip_smoke.lm_zero_grad_leaf``: the sLSTM's ``ri/b``),
    held under ``LM_ZERO_GRAD_RTOL`` of the global norm in both packages."""
    assert set(got) == set(want), label
    norm = math.sqrt(sum(float((w.astype(np.float64) ** 2).sum())
                         for w in want.values()))
    zero = [k for k in want if smoke.lm_zero_grad_leaf(k)]
    assert len(zero) == 1, zero  # the one sLSTM layer's
    for k in want:
        if k in zero:
            for x in (got[k], want[k]):
                assert np.abs(x).max() / norm <= smoke.LM_ZERO_GRAD_RTOL, k
        else:
            assert rel(got[k], want[k]) <= GRAD_RTOL, f"{label}: grad {k}"


def test_loss_and_gradients_match_jax(run, smoke, tmp_path):
    """Loss, ``ce`` and ``aux`` at 1e-5 and every gradient leaf at 1e-4 of
    its largest (the zero-gradient leaf by the global norm), the
    parameters carried through a ``step_<n>.npz`` the reference's
    ``CheckpointManager`` wrote."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.model_zoo import build_model

    cfg = config("torch")
    params = port_params(run, cfg, tmp_path)
    batch = {k: torch.as_tensor(run[k][0]) for k in ("tokens", "labels")}
    (loss, met), grads = value_and_grad(build_model(cfg).loss, params,
                                        batch)
    for name, value in (("loss", loss), ("ce", met["ce"]),
                        ("aux", met["aux"])):
        assert float(value) == pytest.approx(run[name], rel=LOSS_RTOL,
                                             abs=LOSS_RTOL), name
    _check_grads(smoke, flat_port(grads), run["grads"][0], ARCH)


def test_port_on_cpu_matches_golden(smoke):
    """What ``chip_smoke.py`` holds the card to, on the CPU
    (``chip_smoke.lm_train_golden_errors`` with its float64 anchor): the
    batches, the loss terms, every gradient leaf at each step, AdamW on
    the JAX gradients; no kernel launches on the CPU."""
    from repro_torch.models.params import load_lm_train_golden

    out = smoke.lm_train_golden_errors(load_lm_train_golden(ARCH),
                                       device="cpu", float64_anchor=True)
    assert out["params"] <= PARAMS_ATOL
    assert out["zero_grads"] <= smoke.LM_ZERO_GRAD_RTOL
    assert out["mlstm_launches"] == {"forward": 0, "backward": 0}


# ------------------------------------------------------------ golden file
def test_golden_is_fresh(run, smoke):
    from repro_torch.models.params import (XLSTM_GOLDEN_PATH, load_lm_golden,
                                           load_lm_train_golden)

    g = load_lm_train_golden(ARCH)
    assert dataclasses.asdict(g.config) == dataclasses.asdict(
        config("torch"))
    # the initial parameters' file holds the same model: its configuration
    # differs in max_seq only, which makes no parameter
    assert dataclasses.replace(load_lm_golden(XLSTM_GOLDEN_PATH).config,
                               max_seq=MAX_SEQ) == g.config
    assert g.adamw == {"peak": PEAK, "warmup": WARMUP, "steps": STEPS}
    np.testing.assert_array_equal(g.tokens, run["tokens"])
    np.testing.assert_array_equal(g.labels, run["labels"])
    for name in ("loss", "ce", "aux"):
        assert getattr(g, name) == pytest.approx(run[name], rel=LOSS_RTOL,
                                                 abs=LOSS_RTOL)
    for i, grads in enumerate(g.grads):
        _check_grads(smoke, flat_port(grads), run["grads"][i],
                     f"{ARCH} golden")
    for k, want in run["params_after"].items():
        np.testing.assert_allclose(flat_port(g.params_after)[k], want,
                                   rtol=0, atol=1e-7, err_msg=k)
    for k, want in flat_np(run["params"]).items():
        np.testing.assert_array_equal(flat_port(g.params)[k], want)


def test_golden_file_is_small():
    assert GOLDEN.stat().st_size < GOLDEN_BYTES


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_xlstm_train.py --write")
    write()
