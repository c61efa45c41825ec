"""RecurrentGemma training in the port against the JAX package: the
RG-LRU scan's gradient (``ref.linear_scan_bwd``, the function of the
backward kernel of ``csrc/rg_lru.cu``, and ``ref.linear_scan_bwd_chunked``,
the kernel's order) against ``jax.vjp`` of the reference's scan, the small
RecurrentGemma's loss and every gradient leaf against
``jax.value_and_grad(model.loss)``, and its training golden file for the
card.

The small model is ``recurrentgemma-9b`` ``scaled_down(dtype="float32",
chunked_ce=16, max_seq=128)``: 5 layers, (rg_lru, rg_lru, local_attn) +
(rg_lru, rg_lru), window 16, trained on ``TokenPipeline(256, 80, 2)``
batches, so the window, the kernel's 32-step chunks and the CE's 5
chunks are all crossed. Its parameters are the JAX package's
``Model.init(PRNGKey(0))`` (jitted), as ``recurrentgemma_small_golden.npz``
holds them; the JAX run (one compile of value-and-grad plus AdamW) is
computed once a module and shared by the file's tests.

``src/repro_torch/assets/lm_train_recurrentgemma_small_golden.npz`` holds,
under ``recurrentgemma-9b/``, the training configuration, three batches,
the loss, ``ce`` and ``aux`` on the first, every gradient leaf at each of
three AdamW steps under ``cosine_schedule(1e-3, 1, 3)`` and the parameters
after them (the initial ones are ``recurrentgemma_small_golden.npz``'s).
Regenerate it (about 20 s on a CPU) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_rg_lru_train.py --write
"""

import dataclasses
import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_train import (LOSS_RTOL, PARAMS_ATOL, PEAK, SEED,  # noqa: E402
                                 STEPS, WARMUP, check_grads, flat_np,
                                 flat_port, golden_payload, port_params)

ASSETS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "assets"
GOLDEN = ASSETS / "lm_train_recurrentgemma_small_golden.npz"
ARCH = "recurrentgemma-9b"
B, S = 2, 80  # the small model's batch
CHUNKED_CE, MAX_SEQ = 16, 128
# Three float32 gradients and the parameters after, 209,600 values each,
# take 3.19 MB after deflate (their low mantissa bits do not compress)
GOLDEN_BYTES = 4 << 20

# the scan's gradient against JAX: |a - b| <= tol (1 + |b|)
SCAN_TOL = 1e-5
AUTOGRAD_TOL = 1e-6  # the port's autograd through its loop: same formula
# (S, C): each of S 1/31/33/100 and C 3/64/130, a chunk of 32 crossed
SCAN_SHAPES = ((1, 3), (31, 130), (33, 64), (100, 130))
# Long memory (a in (0.99, 0.9999)): da reaches some 250 and every float32
# order, JAX's included, sits up to 2e-5 of 1 + |b| from the float64
# evaluation, so two of them differ past SCAN_TOL. There each of the
# port's versions is held against float64: its relative L2 distance at
# most LONG_MEMORY_MARGIN times the reference's custom VJP's (measured:
# 1.56 for the plain loop's db, which rounds a product and a sum apart;
# 0.92 for the kernel's order).
LONG_MEMORY_MARGIN = 2.0


def config(pkg):
    if pkg == "jax":
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    return get_config(ARCH).scaled_down(dtype="float32",
                                        chunked_ce=CHUNKED_CE,
                                        max_seq=MAX_SEQ)


def init_params():
    """The JAX package's initial parameters as a numpy tree (the
    reference's structure), from ``recurrentgemma_small_golden.npz``."""
    from repro_torch.models.params import load_lm_golden
    from repro_torch.models.transformer import tree_map

    return tree_map(lambda t: t.numpy(), load_lm_golden().params)


def jax_run():
    """The JAX package's three AdamW steps of the small RecurrentGemma."""
    import jax

    from repro.data.tokens import TokenPipeline
    from repro.models.model_zoo import build_model
    from repro.optim.adamw import AdamW
    from repro.optim.schedule import cosine_schedule

    cfg = config("jax")
    model = build_model(cfg)
    opt = AdamW(lr=cosine_schedule(PEAK, WARMUP, STEPS))
    # two compiles, not one of both: about 8 s on one core against 11
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


# ------------------------------------------------------------ the scan
@functools.lru_cache(maxsize=None)
def jax_vjps():
    """[y, da, db, dh0] of ``jax.vjp`` of the reference's custom-VJP scan
    (its Pallas kernel in interpret mode) and of its plain scan, by route,
    both in one function jitted once a shape. h0 and g_last are always
    given: zeros stand for their absence, which is what the reference's
    wrapper substitutes for a missing h0."""
    import jax

    from repro.kernels.rg_lru import ops as jops
    from repro.kernels.rg_lru import ref as jref

    routes = {"custom_vjp": lambda a, b, h0: jops.linear_scan(
        a, b, h0, interpret=True), "oracle": jref.linear_scan}

    def both(a, b, h0, g_y, g_last):
        out = {}
        for name, fn in routes.items():
            y, pull = jax.vjp(fn, a, b, h0)
            out[name] = (y[0], *pull((g_y, g_last)))
        return out

    return jax.jit(both)


def scan_inputs(S, C, long_memory=False, seed=0):
    """a in (0.5, 0.999) (in (0.99, 0.9999) for long memory), b, h0 and
    the cotangents normal; numpy float32."""
    rng = np.random.default_rng(seed * 7919 + S * 1000 + C)
    lo, hi = (0.99, 0.9999) if long_memory else (0.5, 0.999)
    a = rng.uniform(lo, hi, (B, S, C)).astype(np.float32)
    b, g_y = (rng.standard_normal((B, S, C)).astype(np.float32)
              for _ in range(2))
    h0, g_last = (rng.standard_normal((B, C)).astype(np.float32)
                  for _ in range(2))
    return a, b, h0, g_y, g_last


def _scaled(got, want):
    return float(np.max(np.abs(got - want) / (1 + np.abs(want))))


def _jax_grads(a, b, h0, g_y, g_last):
    """{route: [y, da, db, dh0]} of the reference's two VJPs."""
    return {k: [np.array(x) for x in v]
            for k, v in jax_vjps()(a, b, h0, g_y, g_last).items()}


@pytest.mark.parametrize("S,C", SCAN_SHAPES)
def test_scan_gradient_matches_jax(S, C):
    """``ref.linear_scan_bwd`` (and the kernel's order) against the
    reference's VJPs, with and without h0 and g_last; the port's autograd
    through its loop against ``ref.linear_scan_bwd``."""
    from repro_torch.kernels.rg_lru import ref

    a, b, h0, g_y, g_last = scan_inputs(S, C)
    zeros = np.zeros_like(h0)
    for with_h0 in (True, False):
        for with_g_last in (True, False):
            label = f"S={S} C={C} h0={with_h0} g_last={with_g_last}"
            want = _jax_grads(a, b, h0 if with_h0 else zeros, g_y,
                              g_last if with_g_last else zeros)
            y = torch.from_numpy(want["oracle"][0])
            args = [torch.from_numpy(a), y,
                    torch.from_numpy(h0) if with_h0 else None,
                    torch.from_numpy(g_y),
                    torch.from_numpy(g_last) if with_g_last else None]
            for name, fn in (("plain", ref.linear_scan_bwd),
                             ("chunked", ref.linear_scan_bwd_chunked)):
                da, db, dh0 = fn(*args)
                assert (dh0 is None) == (not with_h0), label
                for route, (_, jda, jdb, jdh0) in want.items():
                    got = [da.numpy(), db.numpy()] + (
                        [dh0.numpy()] if with_h0 else [])
                    for x, w in zip(got, (jda, jdb, jdh0)):
                        err = _scaled(x, w)
                        assert err <= SCAN_TOL, (label, name, route, err)
            # autograd through the port's loop, the CPU training route
            ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
            th0 = (torch.from_numpy(h0).requires_grad_() if with_h0
                   else None)
            ys, hl = ref.linear_scan(ta, tb, th0)
            outs, cots = [ys], [args[3]]
            if with_g_last:
                outs, cots = outs + [hl], cots + [args[4]]
            leaves = [ta, tb] + ([th0] if with_h0 else [])
            grads = torch.autograd.grad(outs, leaves, cots)
            plain = ref.linear_scan_bwd(ta.detach(), ys.detach(),
                                        None if th0 is None else th0.detach(),
                                        *args[3:])
            for x, w in zip(grads, plain):
                err = _scaled(x.numpy(), w.numpy())
                assert err <= AUTOGRAD_TOL, (label, "autograd", err)


def test_scan_gradient_long_memory_vs_float64():
    """a near 1 (S 100, C 130, h0 and g_last given): the plain version and
    the kernel's order no further from the float64 evaluation than
    LONG_MEMORY_MARGIN times the reference's custom VJP, in relative L2,
    for da, db and dh0."""
    from repro_torch.kernels.rg_lru import ref

    inputs = scan_inputs(100, 130, long_memory=True)
    want = _jax_grads(*inputs)
    a, _, h0, g_y, g_last = (torch.from_numpy(x) for x in inputs)
    args = (a, torch.from_numpy(want["oracle"][0]), h0, g_y, g_last)
    exact = ref.linear_scan_bwd(*args, dtype=torch.float64)

    def dist(x, w):
        return float((x.double() - w).norm() / w.norm())

    jax_dist = [dist(torch.from_numpy(x), w)
                for x, w in zip(want["custom_vjp"][1:], exact)]
    for name, fn in (("plain", ref.linear_scan_bwd),
                     ("chunked", ref.linear_scan_bwd_chunked)):
        for x, w, e_j, grad in zip(fn(*args), exact, jax_dist,
                                   ("da", "db", "dh0")):
            assert dist(x, w) <= LONG_MEMORY_MARGIN * e_j, (name, grad,
                                                             dist(x, w), e_j)


# ------------------------------------------------------------ the model
def test_loss_and_gradients_match_jax(run, tmp_path):
    """Loss, ``ce`` and ``aux`` at 1e-5 and every gradient leaf at 1e-4 of
    its largest, the parameters carried through a ``step_<n>.npz`` the
    reference's ``CheckpointManager`` wrote."""
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
    check_grads(flat_port(grads), run["grads"][0], ARCH)


def test_port_on_cpu_matches_golden(smoke):
    """What ``chip_smoke.py`` holds the card to, on the CPU
    (``chip_smoke.lm_train_golden_errors``): the batches, the loss terms,
    every gradient leaf at each step, AdamW on the JAX gradients; no
    kernel launches on the CPU."""
    from repro_torch.models.params import load_lm_train_golden

    out = smoke.lm_train_golden_errors(load_lm_train_golden(ARCH),
                                       device="cpu")
    assert out["params"] <= PARAMS_ATOL
    assert out["launches"] == {"forward": 0, "backward": 0}
    assert out["lru_launches"] == {"forward": 0, "backward": 0}


@pytest.mark.parametrize("param_dtype,state_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16)])
def test_adamw_in_place_equals_the_functional_update(param_dtype,
                                                     state_dtype):
    """``AdamW(inplace=True)`` (the full-width training cell's, which
    cannot hold two copies of its moments) writes the functional update's
    values into the given tensors, bit for bit, step after step."""
    from repro_torch.common.tree import flatten
    from repro_torch.optim import AdamW, cosine_schedule

    g = torch.Generator().manual_seed(0)

    def tree():
        return {"w": torch.randn(6, 5, generator=g).to(param_dtype),
                "blocks": [{"scale": torch.randn(5, generator=g)}]}

    params, grads = tree(), [tree() for _ in range(3)]
    kw = dict(lr=cosine_schedule(1e-2, 1, 3), state_dtype=state_dtype)
    func, inpl = AdamW(**kw), AdamW(inplace=True, **kw)
    pf, sf = params, func.init(params)
    pi = {"w": params["w"].clone(),
          "blocks": [{"scale": params["blocks"][0]["scale"].clone()}]}
    si = inpl.init(pi)
    for gr in grads:
        pf, sf, _ = func.update(gr, sf, pf)
        before = [t.data_ptr() for t in flatten(pi).values()]
        pi, si, _ = inpl.update(gr, si, pi)
        assert [t.data_ptr() for t in flatten(pi).values()] == before
        for a, b in ((pf, pi), (sf.m, si.m), (sf.v, si.v)):
            fa, fb = flatten(a), flatten(b)
            assert all(torch.equal(fa[k], fb[k]) and fa[k].dtype == fb[k].dtype
                       for k in fa)


# ------------------------------------------------------------ golden file
def test_golden_is_fresh(run):
    from repro_torch.models.params import load_lm_golden, load_lm_train_golden

    g = load_lm_train_golden(ARCH)
    assert dataclasses.asdict(g.config) == dataclasses.asdict(
        config("torch"))
    # the initial parameters' file holds the same model: its configuration
    # differs in chunked_ce and max_seq only, which make no parameter
    assert dataclasses.replace(load_lm_golden().config,
                               chunked_ce=CHUNKED_CE,
                               max_seq=MAX_SEQ) == g.config
    assert g.adamw == {"peak": PEAK, "warmup": WARMUP, "steps": STEPS}
    np.testing.assert_array_equal(g.tokens, run["tokens"])
    np.testing.assert_array_equal(g.labels, run["labels"])
    for name in ("loss", "ce", "aux"):
        assert getattr(g, name) == pytest.approx(run[name], rel=LOSS_RTOL,
                                                 abs=LOSS_RTOL)
    for i, grads in enumerate(g.grads):
        check_grads(flat_port(grads), run["grads"][i], f"{ARCH} golden")
    for k, want in run["params_after"].items():
        np.testing.assert_allclose(flat_port(g.params_after)[k], want,
                                   rtol=0, atol=1e-7, err_msg=k)
    for k, want in flat_np(run["params"]).items():
        np.testing.assert_array_equal(flat_port(g.params)[k], want)


def test_golden_file_is_small():
    assert GOLDEN.stat().st_size < GOLDEN_BYTES


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_rg_lru_train.py --write")
    write()
