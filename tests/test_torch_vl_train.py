"""Qwen2-VL training in the port against the JAX package: the small
Qwen2-VL's loss, every gradient leaf and three AdamW steps against
``jax.value_and_grad(model.loss)``, from embeddings with an image's
M-RoPE positions and from tokens; the port's value-and-grad on a leaf the
loss does not read; its training golden file for the card; and the
family's training batch against the reference's ``input_specs``.

The small model is ``qwen2-vl-7b`` ``scaled_down(dtype="float32")``: one
attention layer (H 4, KH 2, D 16, ``qkv_bias``), M-RoPE, an untied
``lm_head``. Its parameters are the JAX package's, as
``lm_zoo_mla_mrope_small_golden.npz`` holds them. Two runs, each computed
once a module (one compile of value-and-grad, one of AdamW):

- from embeddings: ``chip_smoke.lm_train_batch`` batches of the "vlm"
  family, (B, S, d_model) embeddings of the stub frontend and (3, B, S)
  positions of an image of 4 x 4 merged patches, whose t/h/w rows part,
  at another offset in each batch row. It is held to the reference's
  Pallas route (interpret mode; its custom VJP is
  ``repro/kernels/flash_attention/ops.py:42``), which masks by index as
  the port's kernel does; the default route masks by the positions'
  values, which repeat in an image (ROADMAP.md section 3). The loss never
  reads ``embed/table``, whose gradient is 0 in both packages;
- from tokens, ``TokenPipeline`` batches with three equal position rows,
  held to the default route.

``src/repro_torch/assets/lm_train_qwen2_vl_small_golden.npz`` holds,
under ``qwen2-vl-7b/``, the training configuration, the three batches
from embeddings (labels, embeddings, positions), the loss, ``ce`` and
``aux`` on the first, every gradient leaf at each of three AdamW steps
under ``cosine_schedule(1e-3, 1, 3)`` and the parameters after them (the
initial ones are ``lm_zoo_mla_mrope_small_golden.npz``'s). Regenerate it
(about 15 s on a CPU) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_vl_train.py --write
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_train import (B, LOSS_RTOL, PARAMS_ATOL, PEAK, S,  # noqa: E402
                                 SEED, STEPS, WARMUP, check_grads,
                                 check_input_specs, config, flat_np,
                                 flat_port, golden_payload, jax_train,
                                 load_chip_smoke, one_thread, port_params,
                                 smoke, train_golden)  # noqa: F401

ASSETS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "assets"
GOLDEN = ASSETS / "lm_train_qwen2_vl_small_golden.npz"
ARCH = "qwen2-vl-7b"
# Three float32 gradients and the parameters after, 66,816 values each,
# and three batches of embeddings take about 1 MB after deflate
GOLDEN_BYTES = 3 << 20
# (n_before, grid, merge) of the small batches' image: 2 (row 0) or 5
# (row 1) text tokens, 4 x 4 merged patches, text to S = 32
SMALL_IMAGE = (2, 8, 2)
UNUSED = "embed/table"  # the untied embedding, unread from embeddings


def init_params():
    """The JAX package's initial parameters as a numpy tree, from
    ``lm_zoo_mla_mrope_small_golden.npz``."""
    from repro_torch.models.params import (LM_MLA_MROPE_GOLDEN_PATH,
                                           load_lm_golden)
    from repro_torch.models.transformer import tree_map

    return tree_map(lambda t: t.numpy(), load_lm_golden(
        LM_MLA_MROPE_GOLDEN_PATH, f"{ARCH}/").params)


def embedding_arrays(smoke):
    """The three batches from embeddings, as (STEPS, ...) numpy arrays."""
    cfg = config(ARCH, "torch")
    batches = [smoke.lm_train_batch(cfg, B, S, seed=i, device="cpu",
                                    image=SMALL_IMAGE)
               for i in range(STEPS)]
    return {k: np.stack([b[k].numpy() for b in batches]) for k in batches[0]}


def token_arrays():
    """Three ``TokenPipeline`` batches with three equal position rows."""
    from repro_torch.data.tokens import TokenPipeline

    pipe = TokenPipeline(config(ARCH, "torch").vocab_size, S, B, seed=SEED,
                         device="cpu")
    batches = [pipe.batch_at(i) for i in range(STEPS)]
    out = {k: np.stack([b[k].numpy() for b in batches])
           for k in ("tokens", "labels")}
    out["positions"] = np.broadcast_to(
        np.arange(S, dtype=np.int32), (STEPS, 3, B, S)).copy()
    return out


def jax_runs(smoke):
    """The JAX package's runs: from embeddings on the Pallas route
    (interpret mode), from tokens on the default route."""
    cfg = config(ARCH, "jax")
    params = init_params()
    emb = jax_train(dataclasses.replace(cfg, attn_impl="pallas"), params,
                    embedding_arrays(smoke))
    emb["cfg"] = cfg  # the golden's configuration; the route is JAX's
    return {"embeddings": emb,
            "tokens": jax_train(cfg, params, token_arrays())}


def write(path: Path = GOLDEN) -> None:
    payload = {"adamw/peak": np.float64(PEAK),
               "adamw/warmup": np.int64(WARMUP),
               "adamw/steps": np.int64(STEPS)}
    payload.update(golden_payload(ARCH, jax_runs(load_chip_smoke())
                                  ["embeddings"]))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **payload)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


@pytest.fixture(scope="module")
def runs(smoke):
    return jax_runs(smoke)


# ------------------------------------------------------------ value and grad
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_value_and_grad_gives_zeros_for_an_unused_leaf(dtype):
    """A leaf the loss does not read gets zeros in its own type and on
    its device, as ``jax.value_and_grad`` gives them, not ``None`` and
    not an error; the leaves it reads get their gradients."""
    from repro_torch.launch.steps import value_and_grad

    params = {"used": torch.full((3,), 2.0, dtype=dtype),
              "unused": [torch.ones(2, 5, dtype=dtype)]}

    def loss_fn(p, x):
        loss = (p["used"].float() * x).sum()
        return loss, {"x": x.sum()}

    (loss, aux), grads = value_and_grad(loss_fn, params, torch.arange(3.0))
    assert float(loss) == 6.0 and float(aux["x"]) == 3.0
    assert torch.equal(grads["used"], torch.arange(3.0).to(dtype))
    unused = grads["unused"][0]
    assert unused.dtype == dtype and unused.device == params["unused"][
        0].device and unused.shape == (2, 5)
    assert not unused.any()


def test_loss_and_gradients_from_embeddings_match_pallas_route(runs,
                                                               tmp_path):
    """Loss, ``ce`` and ``aux`` at 1e-5 and every gradient leaf at 1e-4
    of its largest, from embeddings with an image's positions, against
    the reference's Pallas route; the parameters carried through a
    ``step_<n>.npz`` the reference's ``CheckpointManager`` wrote. The
    untied embedding's gradient is 0 in both packages."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.model_zoo import build_model

    run = runs["embeddings"]
    pos = run["positions"][0]
    assert (pos[0] != pos[1]).any() and (pos[:, 0] != pos[:, 1]).any()
    cfg = config(ARCH, "torch")
    params = port_params(run, cfg, tmp_path)
    batch = {k: torch.as_tensor(run[k][0])
             for k in ("embeddings", "positions", "labels")}
    (loss, met), grads = value_and_grad(build_model(cfg).loss, params,
                                        batch)
    for name, value in (("loss", loss), ("ce", met["ce"]),
                        ("aux", met["aux"])):
        assert float(value) == pytest.approx(run[name], rel=LOSS_RTOL,
                                             abs=LOSS_RTOL), name
    got = flat_port(grads)
    assert not got[UNUSED].any() and got[UNUSED].dtype == np.float32
    assert not run["grads"][0][UNUSED].any()
    check_grads(got, run["grads"][0], f"{ARCH} from embeddings")


def test_training_from_tokens_matches_default_route(runs, smoke):
    """From tokens with three equal position rows (M-RoPE equals RoPE
    there): the loss terms, every gradient leaf at each of three AdamW
    steps, and the port's AdamW on the JAX gradients, against the
    default route, through ``chip_smoke.lm_train_golden_errors``."""
    run = runs["tokens"]
    assert np.abs(run["grads"][0][UNUSED]).max() > 0
    out = smoke.lm_train_golden_errors(
        train_golden(run, config(ARCH, "torch")), device="cpu")
    assert out["params"] <= PARAMS_ATOL
    assert out["launches"] == {"forward": 0, "backward": 0}


def test_adamw_moves_the_unused_leaf_as_jax(runs):
    """Three steps of ``launch.train.make_step`` (the port's own
    gradients and AdamW) from embeddings: weight decay alone moves the
    untied embedding, and it lands where the reference's does."""
    from repro_torch.launch.train import make_step
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import AdamW, cosine_schedule

    run = runs["embeddings"]
    cfg = config(ARCH, "torch")
    params = port_params(run, cfg)
    opt = AdamW(lr=cosine_schedule(PEAK, WARMUP, STEPS))
    step, st = make_step(build_model(cfg), opt), opt.init(params)
    before = flat_port(params)[UNUSED]
    for i in range(STEPS):
        batch = {k: torch.as_tensor(run[k][i])
                 for k in ("embeddings", "positions", "labels")}
        params, st, _ = step(params, st, batch)
    after = flat_port(params)[UNUSED]
    assert np.abs(after - before).max() > 0
    np.testing.assert_allclose(after, run["params_after"][UNUSED], rtol=0,
                               atol=PARAMS_ATOL)


def test_batch_matches_input_specs(smoke):
    """The "vlm" batch's keys, shapes and types are the reference's
    ``input_specs`` of a train cell, small and at full width, and its
    positions are an image's: rows that part, row 0 as
    ``vl_positions``."""
    check_input_specs(smoke, ARCH, B, S + 16, image=SMALL_IMAGE)
    pos = smoke.lm_train_batch(config(ARCH, "torch"), B, S, device="cpu",
                               image=SMALL_IMAGE)["positions"]
    assert torch.equal(pos[:, 0], smoke.vl_positions(*SMALL_IMAGE, S).int())
    assert not torch.equal(pos[:, 0], pos[:, 1])


def test_port_on_cpu_matches_golden(smoke):
    """What ``chip_smoke.py`` holds the card to, on the CPU
    (``chip_smoke.lm_train_golden_errors``): the golden's batches from
    embeddings, the loss terms, every gradient leaf at each of three
    AdamW steps, and the port's AdamW on the JAX gradients at
    PARAMS_ATOL; no kernel launches on the CPU."""
    from repro_torch.models.params import load_lm_train_golden

    out = smoke.lm_train_golden_errors(load_lm_train_golden(ARCH),
                                       device="cpu")
    assert out["params"] <= PARAMS_ATOL
    assert out["launches"] == {"forward": 0, "backward": 0}


# ------------------------------------------------------------ golden file
def test_golden_is_fresh(runs):
    from repro_torch.models.params import (LM_MLA_MROPE_GOLDEN_PATH,
                                           load_lm_golden,
                                           load_lm_train_golden)

    run = runs["embeddings"]
    g = load_lm_train_golden(ARCH)
    assert dataclasses.asdict(g.config) == dataclasses.asdict(
        config(ARCH, "torch"))
    assert load_lm_golden(LM_MLA_MROPE_GOLDEN_PATH,
                          f"{ARCH}/").config == g.config
    assert g.adamw == {"peak": PEAK, "warmup": WARMUP, "steps": STEPS}
    assert g.tokens is None and g.frames is None
    for k in ("labels", "embeddings", "positions"):
        np.testing.assert_array_equal(getattr(g, k), run[k])
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
        sys.exit("usage: python tests/test_torch_vl_train.py --write")
    write()
