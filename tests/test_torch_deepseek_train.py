"""DeepSeek-V2-Lite training in the port against the JAX package: the
flash backward's formulas at the latent attention's head-dim pairs
(``ref.attention_bwd`` at (D, DV) = (24, 16) and (192, 128), the function
of the backward kernels of ``csrc/flash_attention_bwd.cu``) against
``jax.vjp`` of the reference's ``attend_full`` and against the port's own
autograd in float64; the backward's routes at those pairs; the small
DeepSeek's loss and every gradient leaf against
``jax.value_and_grad(model.loss)``; its training golden file for the
card; and ``launch.train.main`` across a failure.

The small model is ``deepseek-v2-lite-16b`` ``scaled_down(dtype="float32")``:
a dense MLA layer and one MLA-MoE layer (4 routed experts top-2 and 2
shared, capacity drops included), flash at (24, 16), trained on
``TokenPipeline(256, 32, 2)`` batches. Its parameters are the JAX
package's, as ``lm_zoo_mla_mrope_small_golden.npz`` holds them; the JAX
run (one compile of value-and-grad, one of AdamW) is computed once a
module.

``src/repro_torch/assets/lm_train_deepseek_small_golden.npz`` holds, under
``deepseek-v2-lite-16b/``, the training configuration, three batches, the
loss, ``ce`` and ``aux`` on the first, every gradient leaf at each of three
AdamW steps under ``cosine_schedule(1e-3, 1, 3)`` and the parameters after
them (the initial ones are ``lm_zoo_mla_mrope_small_golden.npz``'s).
Regenerate it (about 10 s on a CPU) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_deepseek_train.py --write
"""

import contextlib
import dataclasses
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_train import (B, LOSS_RTOL, PARAMS_ATOL, PEAK, S,  # noqa: E402
                                 SEED, STEPS, WARMUP, check_grads, config,
                                 flat_np, flat_port, golden_payload,
                                 one_thread, port_params, smoke)  # noqa: F401

ASSETS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "assets"
GOLDEN = ASSETS / "lm_train_deepseek_small_golden.npz"
ARCH = "deepseek-v2-lite-16b"
# Three float32 gradients and the parameters after, 122,496 values each,
# take about 1.7 MB after deflate
GOLDEN_BYTES = 4 << 20

# (D, DV) of the latent attention: the small DeepSeek's and the full
# width's (nope + rope = 16 + 8 and 128 + 64; v_head_dim 16 and 128)
MLA_PAIRS = ((24, 16), (192, 128))
MLA_HEADS = (2, 4)  # H = KH: MLA has a kv head a query head
BWD_B, BWD_S = 2, 40


# ------------------------------------------------------------ the flash backward
def bwd_inputs(D, DV, H, seed=0):
    """float32 numpy q (B, S, H, D), k (B, S, H, D), v (B, S, H, DV) and
    the output's cotangent (B, S, H, DV): the model's layout."""
    rng = np.random.default_rng([seed, D, DV, H])
    shapes = ((BWD_S, D), (BWD_S, D), (BWD_S, DV), (BWD_S, DV))
    return [rng.standard_normal((BWD_B, n, H, d)).astype(np.float32)
            for n, d in shapes]


def plain_bwd(q, k, v, do, dtype=torch.float32):
    """``ref.attention_bwd`` from the plain forward's log-sum-exp,
    causal, in the model's layout."""
    from repro_torch.kernels.flash_attention import ref

    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype).transpose(1, 2)
                       for x in (q, k, v, do))
    lse = ref.attention_lse(tq, tk)
    return [g.transpose(1, 2) for g in ref.attention_bwd(tq, tk, tv, lse,
                                                         tdo)]


@pytest.mark.parametrize("H", MLA_HEADS)
@pytest.mark.parametrize("D,DV", MLA_PAIRS)
def test_attention_bwd_matches_attend_full_vjp(D, DV, H):
    """The backward kernels' formulas at v narrower than q and k against
    ``jax.vjp`` of the reference's ``attend_full``
    (``repro/models/attention.py:118``), whose gradient is the reference's
    at MLA (its Pallas route and its oracle cannot run DV != D), at
    |a - b| <= 1e-5 (1 + |b|)."""
    import jax
    import jax.numpy as jnp

    from repro.models import attention as jattn

    q, k, v, do = bwd_inputs(D, DV, H)
    pos = jnp.broadcast_to(jnp.arange(BWD_S), (BWD_B, BWD_S))
    _, vjp = jax.vjp(lambda a, b, c: jattn.attend_full(
        a, b, c, pos, pos, causal=True, window=0, scale=D ** -0.5),
        *map(jnp.asarray, (q, k, v)))
    for name, a, b in zip(("dq", "dk", "dv"), plain_bwd(q, k, v, do),
                          vjp(jnp.asarray(do))):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("H", MLA_HEADS)
@pytest.mark.parametrize("D,DV", MLA_PAIRS)
def test_attention_bwd_matches_float64_autograd(D, DV, H):
    """The same formulas in float64 against the port's autograd through
    ``ops.flash_attention`` on the CPU (the plain forward), also in
    float64: the same function, so the formulas are held, not the
    rounding."""
    from repro_torch.kernels.flash_attention import ops

    q, k, v, do = bwd_inputs(D, DV, H, seed=1)
    leaves = [torch.from_numpy(x).double().requires_grad_() for x in
              (q, k, v)]
    want = torch.autograd.grad(ops.flash_attention(*leaves), leaves,
                               torch.from_numpy(do).double())
    for a, b in zip(plain_bwd(q, k, v, do, torch.float64), want):
        assert a.dtype == b.dtype == torch.float64 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10)


def test_backward_takes_the_mla_pairs_and_refuses_a_bf16_24_16():
    """The wrapper's check under grad: (192, 128) on both routes and
    (24, 16) in float32 pass, a bfloat16 gradient at (24, 16) and a pair
    no route takes raise ``ValueError`` naming the pair; on the CPU the
    plain version runs under autograd and launches nothing."""
    from repro_torch.kernels.flash_attention import ops

    def leaves(D, DV, dtype=torch.float32):
        return (torch.zeros(1, 8, 4, D, dtype=dtype).requires_grad_(),
                torch.zeros(1, 8, 4, D, dtype=dtype),
                torch.zeros(1, 8, 4, DV, dtype=dtype))

    for dtype in ops.DTYPES:
        ops._check(*leaves(192, 128, dtype), 0)
    ops._check(*leaves(24, 16), 0)
    with pytest.raises(ValueError, match=r"no backward.*\(24, 16\).*"
                                         r"bfloat16"):
        ops._check(*leaves(24, 16, torch.bfloat16), 0)
    with pytest.raises(ValueError, match=r"no backward.*\(192, 64\)"):
        ops._check(*leaves(192, 64), 0)
    with torch.no_grad():  # the forward alone still refuses it by name
        with pytest.raises(ValueError, match=r"\(24, 16\)"):
            ops._check(*leaves(24, 16, torch.bfloat16), 0)
    before = (ops.LAUNCHES, ops.BWD_LAUNCHES)
    q, k, v = (torch.randn(1, 8, 4, d, requires_grad=True)
               for d in (24, 24, 16))
    ops.flash_attention(q, k, v).sum().backward()
    assert q.grad.shape == q.shape and v.grad.shape == v.shape
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES) == before


# ------------------------------------------------------------ the model
def init_params():
    """The JAX package's initial parameters as a numpy tree, from
    ``lm_zoo_mla_mrope_small_golden.npz``."""
    from repro_torch.models.params import (LM_MLA_MROPE_GOLDEN_PATH,
                                           load_lm_golden)
    from repro_torch.models.transformer import tree_map

    return tree_map(lambda t: t.numpy(), load_lm_golden(
        LM_MLA_MROPE_GOLDEN_PATH, f"{ARCH}/").params)


def jax_run():
    """The JAX package's three AdamW steps of the small DeepSeek."""
    import jax

    from repro.data.tokens import TokenPipeline
    from repro.models.model_zoo import build_model
    from repro.optim.adamw import AdamW
    from repro.optim.schedule import cosine_schedule

    cfg = config(ARCH, "jax")
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


def test_loss_and_gradients_match_jax(run, tmp_path):
    """Loss, ``ce`` and ``aux`` at 1e-5 and every gradient leaf at 1e-4 of
    its largest (the router, the shared and routed experts, MLA's
    ``w_dkv``, ``kv_norm``, ``w_uk`` and ``w_uv`` among them), the
    parameters carried through a ``step_<n>.npz`` the reference's
    ``CheckpointManager`` wrote."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.model_zoo import build_model

    cfg = config(ARCH, "torch")
    params = port_params(run, cfg, tmp_path)
    batch = {k: torch.as_tensor(run[k][0]) for k in ("tokens", "labels")}
    (loss, met), grads = value_and_grad(build_model(cfg).loss, params,
                                        batch)
    for name, value in (("loss", loss), ("ce", met["ce"]),
                        ("aux", met["aux"])):
        assert float(value) == pytest.approx(run[name], rel=LOSS_RTOL,
                                             abs=LOSS_RTOL), name
    assert run["aux"] > 0  # the MoE's balance loss is in the sum
    got = flat_port(grads)
    assert any("shared" in k for k in got) and any("router" in k
                                                   for k in got)
    check_grads(got, run["grads"][0], ARCH)


def test_port_on_cpu_matches_golden(smoke):
    """What ``chip_smoke.py`` holds the card to, on the CPU
    (``chip_smoke.lm_train_golden_errors``): the batches, the loss terms,
    every gradient leaf at each of three AdamW steps, and the port's AdamW
    on the JAX gradients at PARAMS_ATOL; no kernel launches on the
    CPU."""
    from repro_torch.models.params import load_lm_train_golden

    out = smoke.lm_train_golden_errors(load_lm_train_golden(ARCH),
                                       device="cpu")
    assert out["params"] <= PARAMS_ATOL
    assert out["launches"] == {"forward": 0, "backward": 0}


def test_train_main_runs_across_a_failure(tmp_path):
    """``launch.train.main`` on the small DeepSeek: the reference's lines,
    a failure of host-1 at step 4 and a restart from the checkpoint of
    step 4, every loss finite."""
    from repro_torch.launch import train

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = train.main(["--arch", ARCH, "--scale", "small", "--steps",
                             "6", "--hosts", "2", "--fail-at", "4",
                             "--device", "cpu", "--checkpoint-every", "2",
                             "--ckpt-dir", str(tmp_path)])
    lines = out.getvalue().splitlines()
    assert re.fullmatch(r"\[train\] steps=7 loss -?\d+\.\d{3} -> "
                        r"-?\d+\.\d{3}; restarts=1; hosts=\['host-0'\]",
                        lines[1])
    assert lines[2:] == ["[event] step=4 failure: host-1"]
    assert len(result["losses"]) == 7 and np.all(np.isfinite(
        result["losses"]))
    assert (tmp_path / ARCH / "step_4.npz").exists()


# ------------------------------------------------------------ golden file
def test_golden_is_fresh(run):
    from repro_torch.models.params import (LM_MLA_MROPE_GOLDEN_PATH,
                                           load_lm_golden,
                                           load_lm_train_golden)

    g = load_lm_train_golden(ARCH)
    assert dataclasses.asdict(g.config) == dataclasses.asdict(
        config(ARCH, "torch"))
    # the initial parameters' file holds the same model
    assert load_lm_golden(LM_MLA_MROPE_GOLDEN_PATH,
                          f"{ARCH}/").config == g.config
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
        sys.exit("usage: python tests/test_torch_deepseek_train.py --write")
    write()
