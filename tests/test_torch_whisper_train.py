"""Whisper training in the port against the JAX package: the small
whisper's loss, every gradient leaf (the encoder's and the
cross-attention's among them) and three AdamW steps against
``jax.value_and_grad(model.loss)`` with frames; the encoder under remat;
``launch.train.main``'s refusal of an encoder-decoder, and the
reference's failure it stands for; the training golden file for the
card; and the family's training batch against the reference's
``input_specs``.

The small model is ``whisper-small`` ``scaled_down(dtype="float32")``:
one encoder layer over 8 frames, one decoder layer (self-attention,
cross-attention, gelu MLP), learned positions (a 64-row table), the
embedding tied to the unembedding. Its parameters are the JAX package's,
as ``lm_zoo_whisper_small_golden.npz`` holds them. The batches are
``chip_smoke.lm_train_batch``'s of the "audio" family: tokens, labels
and the stub frontend's frames (B, 8, 64). The JAX run (one compile of
value-and-grad, one of AdamW) is computed once a module.

``src/repro_torch/assets/lm_train_whisper_small_golden.npz`` holds,
under ``whisper-small/``, the training configuration, the three batches
(tokens, labels, frames), the loss, ``ce`` and ``aux`` on the first,
every gradient leaf at each of three AdamW steps under
``cosine_schedule(1e-3, 1, 3)`` and the parameters after them (the
initial ones are ``lm_zoo_whisper_small_golden.npz``'s). Regenerate it
(about 10 s on a CPU) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_whisper_train.py --write
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_train import (B, LOSS_RTOL, PARAMS_ATOL, PEAK, S,  # noqa: E402
                                 STEPS, WARMUP, check_grads,
                                 check_input_specs, config, flat_np,
                                 flat_port, golden_payload, jax_train,
                                 load_chip_smoke, one_thread, port_params,
                                 smoke)  # noqa: F401

ASSETS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "assets"
GOLDEN = ASSETS / "lm_train_whisper_small_golden.npz"
ARCH = "whisper-small"
# Three float32 gradients and the parameters after, 90,880 values each,
# and three batches of frames take about 1.3 MB after deflate
GOLDEN_BYTES = 3 << 20


def init_params():
    """The JAX package's initial parameters as a numpy tree, from
    ``lm_zoo_whisper_small_golden.npz``."""
    from repro_torch.models.params import load_whisper_golden
    from repro_torch.models.transformer import tree_map

    return tree_map(lambda t: t.numpy(), load_whisper_golden().params)


def batch_arrays(smoke):
    """The three batches, as (STEPS, ...) numpy arrays."""
    cfg = config(ARCH, "torch")
    batches = [smoke.lm_train_batch(cfg, B, S, seed=i, device="cpu")
               for i in range(STEPS)]
    return {k: np.stack([b[k].numpy() for b in batches]) for k in batches[0]}


def jax_run(smoke):
    return jax_train(config(ARCH, "jax"), init_params(), batch_arrays(smoke))


def write(path: Path = GOLDEN) -> None:
    payload = {"adamw/peak": np.float64(PEAK),
               "adamw/warmup": np.int64(WARMUP),
               "adamw/steps": np.int64(STEPS)}
    payload.update(golden_payload(ARCH, jax_run(load_chip_smoke())))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **payload)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


@pytest.fixture(scope="module")
def run(smoke):
    return jax_run(smoke)


def first_batch(run):
    return {k: torch.as_tensor(run[k][0])
            for k in ("tokens", "labels", "frames")}


# ------------------------------------------------------------ loss
def test_loss_and_gradients_match_jax(run, tmp_path):
    """Loss, ``ce`` and ``aux`` at 1e-5 and every gradient leaf at 1e-4
    of its largest with frames: the encoder's stacked leaves, ``enc_norm``,
    the cross-attention's, the learned positions (a scatter-add over the
    rows in use, 0 past them in both packages) and the tied embedding
    (its embedding's and its unembedding's terms); the parameters carried
    through a ``step_<n>.npz`` the reference's ``CheckpointManager``
    wrote."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.model_zoo import build_model

    cfg = config(ARCH, "torch")
    params = port_params(run, cfg, tmp_path)
    (loss, met), grads = value_and_grad(build_model(cfg).loss, params,
                                        first_batch(run))
    for name, value in (("loss", loss), ("ce", met["ce"]),
                        ("aux", met["aux"])):
        assert float(value) == pytest.approx(run[name], rel=LOSS_RTOL,
                                             abs=LOSS_RTOL), name
    got = flat_port(grads)
    for part in ("encoder/attn/wq", "enc_norm", "xattn/wk", "norm_x",
                 "pos_embed/table", "embed/table"):
        assert any(k.startswith(part) or f"/{part}" in k for k in got), part
    assert "lm_head/w" not in got  # tied
    table, want = got["pos_embed/table"], run["grads"][0]["pos_embed/table"]
    assert not table[S:].any() and not want[S:].any()
    assert (np.abs(table[:S]).max(1) > 0).all()
    check_grads(got, run["grads"][0], ARCH)


def test_encoder_remat_keeps_values_and_gradients(run, monkeypatch):
    """``run_encoder`` under grad with ``remat="full"`` (each layer under
    ``torch.utils.checkpoint``, the reference's ``_remat(body, cfg)``)
    and with ``"none"``: the same output and the same gradients of the
    frames and every encoder leaf, bit for bit; with remat the backward
    runs each layer's attention again."""
    from repro_torch.common.tree import flatten
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import transformer as tfm

    calls = []
    flash = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: (calls.append(1), flash(*a, **k))[1])
    base = config(ARCH, "torch")
    assert base.remat == "full"
    frames = torch.as_tensor(run["frames"][0])
    cotangent = torch.randn(frames.shape, generator=torch.Generator()
                            .manual_seed(3))
    results = {}
    for remat in ("full", "none"):
        cfg = dataclasses.replace(base, remat=remat)
        params = port_params(run, cfg)
        leaves = [t.requires_grad_() for t in flatten(
            {k: params[k] for k in ("encoder", "enc_norm")}).values()]
        x = frames.clone().requires_grad_()
        calls.clear()
        out = tfm.run_encoder(params, cfg, x)
        grads = torch.autograd.grad(out, [x] + leaves, cotangent)
        results[remat] = (out.detach(), grads, len(calls))
    (out_r, g_r, n_r), (out_n, g_n, n_n) = results["full"], results["none"]
    assert torch.equal(out_r, out_n)
    assert len(g_r) == len(g_n) > 10
    for a, b in zip(g_r, g_n):
        assert torch.equal(a, b)
    assert (n_r, n_n) == (2 * base.n_encoder_layers, base.n_encoder_layers)


# ------------------------------------------------------------ the backward
def test_plain_backward_keeps_its_digits_where_keys_nearly_agree():
    """``ref.attention_bwd`` (the float32 backward kernels' formula): delta
    from P and dP, and the rounding of each row's sum of dS (exactly 0) on
    one live key of the row, as autograd's softmax backward keeps it; the
    same functions as FlashAttention-2's delta = rowsum(dout * out) with dS
    summed as it stands (equal in float64). Where a cross-attention's keys
    and values nearly agree, as in whisper's first decoder layer at the
    full-width cell's trained weights, those put the rounding of delta and
    of the row sums into dq times the keys' common part and into dk's sum
    over keys, which the common part of the keys' input projects (wk's
    gradient, here E^T dk for inputs E that agree as closely). In float32
    against float64, at spreads of 3 % (keys) and 2 % (values) over 1500
    keys: dq and E^T dk within 1e-3, FlashAttention-2's past 1e-2."""
    from repro_torch.kernels.flash_attention import ref

    rng = np.random.default_rng(5)
    B, H, S, T, D = 1, 2, 32, 1500, 64

    def near(scale, spread, width=D):
        return (scale * rng.standard_normal((B, H, 1, width))
                + spread * rng.standard_normal((B, H, T, width)))

    q, k, v = rng.standard_normal((B, H, S, D)), near(1.0, 0.03), near(1.4,
                                                                      0.02)
    dout, inputs = rng.standard_normal((B, H, S, D)), near(1.0, 0.02, 32)

    def grads(dtype):
        """(dq, E^T dk) of the formula and of the uncorrected dS."""
        qt, kt, vt, dt = (torch.as_tensor(x, dtype=dtype)
                          for x in (q, k, v, dout))
        out = ref.attention(qt, kt, vt, causal=False)
        lse = ref.attention_lse(qt, kt, causal=False)
        dq, dk, _ = ref.attention_bwd(qt, kt, vt, lse, dt, causal=False)
        p = torch.exp(torch.einsum("bhsd,bhtd->bhst", qt, kt) * D ** -0.5
                      - lse[..., None])
        dp = torch.einsum("bhsd,bhtd->bhst", dt, vt)
        ds = p * (dp - (dt * out).sum(-1, keepdim=True))
        plain = (torch.einsum("bhst,bhtd->bhsd", ds, kt) * D ** -0.5,
                 torch.einsum("bhst,bhsd->bhtd", ds, qt) * D ** -0.5)
        e = torch.as_tensor(inputs)
        return [(x.double(), torch.einsum("bhte,bhtd->bhed", e, y.double()))
                for x, y in ((dq, dk), plain)]

    (want, want_plain) = grads(torch.float64)
    for a, b in zip(want, want_plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-12)
    got, got_plain = grads(torch.float32)
    rel = [[float((x - w).norm() / w.norm()) for x, w in zip(pair, want)]
           for pair in (got, got_plain)]
    assert max(rel[0]) <= 1e-3 < 1e-2 <= min(rel[1]), rel


# ------------------------------------------------------------ entry point
def test_train_main_refuses_an_encoder_decoder(monkeypatch):
    """``launch.train.main`` on whisper raises ``ValueError`` naming the
    frames before the Perona ranking and before any step."""
    from repro_torch.launch import train

    def never(*a, **k):
        raise AssertionError("reached past the refusal")

    monkeypatch.setattr(train, "fingerprint_cluster", never)
    monkeypatch.setattr(train, "make_step", never)
    for scale in ("small", "full"):
        with pytest.raises(ValueError, match=r"encoder-decoder.*frames"):
            train.main(["--arch", ARCH, "--scale", scale, "--steps", "2",
                        "--device", "cpu"])


def test_reference_loss_fails_on_a_token_pipeline_batch(run):
    """The failure the refusal stands for: the reference's ``loss_fn``, as
    its ``launch/train.py::main`` calls it, on a ``TokenPipeline`` batch of
    the small whisper raises ``KeyError`` for the frames."""
    from repro.data.tokens import TokenPipeline
    from repro.models import transformer as jtfm

    cfg = config(ARCH, "jax")
    batch = TokenPipeline(cfg.vocab_size, S, B, seed=0).batch_at(0)
    assert set(batch) == {"tokens", "labels"}
    with pytest.raises(KeyError, match="frames"):
        jtfm.loss_fn(run["params"], cfg, batch)


def test_batch_matches_input_specs(smoke):
    """The "audio" batch's keys, shapes and types are the reference's
    ``input_specs`` of a train cell, small and at full width (1500
    frames of 768)."""
    check_input_specs(smoke, ARCH, B, S)


def test_port_on_cpu_matches_golden(smoke):
    """What ``chip_smoke.py`` holds the card to, on the CPU
    (``chip_smoke.lm_train_golden_errors``): the golden's batches with
    frames, the loss terms, every gradient leaf at each of three AdamW
    steps, and the port's AdamW on the JAX gradients at PARAMS_ATOL; no
    kernel launches on the CPU."""
    from repro_torch.models.params import load_lm_train_golden

    out = smoke.lm_train_golden_errors(load_lm_train_golden(ARCH),
                                       device="cpu")
    assert out["params"] <= PARAMS_ATOL
    assert out["launches"] == {"forward": 0, "backward": 0}


# ------------------------------------------------------------ golden file
def test_golden_is_fresh(run):
    from repro_torch.models.params import (load_lm_train_golden,
                                           load_whisper_golden)

    g = load_lm_train_golden(ARCH)
    assert dataclasses.asdict(g.config) == dataclasses.asdict(
        config(ARCH, "torch"))
    assert load_whisper_golden().config == g.config
    assert g.adamw == {"peak": PEAK, "warmup": WARMUP, "steps": STEPS}
    assert g.embeddings is None and g.positions is None
    for k in ("tokens", "labels", "frames"):
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
        sys.exit("usage: python tests/test_torch_whisper_train.py --write")
    write()
