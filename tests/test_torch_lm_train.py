"""LM training in the port against the JAX package: the threefry draws of
the token pipeline, the pipeline, the schedules, gradient compression,
the plain flash attention's gradient, ``loss_fn`` and its gradients,
AdamW under a schedule, the bf16 train step, the fault-tolerant runtime,
training checkpoints across packages and ``launch.train.main``; and the
golden file of the five small dense and MoE decoders for the card.

Each small decoder is ``scaled_down(dtype="float32")`` (gemma3 with
``chunked_ce=8``, which divides S = 32 into four chunks) at the JAX
package's ``Model.init(PRNGKey(0))`` parameters, the parameters of
``lm_zoo_small_golden.npz``. Its JAX run is computed once a module (one
compile of value-and-grad plus AdamW) and shared by the file's tests.

``src/repro_torch/assets/lm_train_small_golden.npz`` holds, for each
arch under ``<arch>/``, the training configuration, three batches of
the JAX ``TokenPipeline`` (vocab 256, B 2, S 32), the loss, ``ce`` and
``aux`` on the first, every gradient leaf at each of three AdamW steps
under ``cosine_schedule(PEAK, WARMUP, STEPS)`` and the parameters after
them; under
``pipeline/``, the JAX pipeline's batches at vocab 49,152, B 8, S 2048,
steps 0 and 17. Regenerate it (about half a minute on a CPU) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_train.py --write
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_zoo import ZOO  # noqa: E402

ASSETS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "assets"
GOLDEN = ASSETS / "lm_train_small_golden.npz"

SEED = 0
B, S = 2, 32  # the small decoders' batch
STEPS = 3  # AdamW steps held
PEAK, WARMUP = 1e-3, 1  # cosine_schedule(PEAK, WARMUP, STEPS)
CHUNKED_CE = {"gemma3-4b": 8}
PARITY = ("smollm-135m", "gemma3-4b", "granite-moe-1b-a400m")
# the full-vocabulary batches of the golden file
FULL_VOCAB, FULL_SEQ, FULL_BATCH, FULL_STEPS = 49152, 2048, 8, (0, 17)

LOSS_RTOL = 1e-5  # float32 on both sides, summed in different orders
GRAD_RTOL = 1e-4  # max |a - b| over max |b|, leaf by leaf
PARAMS_ATOL = 1e-5  # after three AdamW steps
# the bf16 step (master weights): the first moments, 0.1 x the clipped
# bf16 gradient, as relative L2, and the loss; bf16 rounds at other
# places in the two frameworks
BF16_MOMENT_RTOL = 5e-2
BF16_LOSS_RTOL = 1e-2


def config(arch, pkg):
    if pkg == "jax":
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    return get_config(arch).scaled_down(
        dtype="float32", chunked_ce=CHUNKED_CE.get(arch, 0))


def flat_np(tree):
    """{slash path: numpy leaf} of a JAX or numpy tree."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        out["/".join(keys)] = np.asarray(leaf)
    return out


def flat_port(tree):
    from repro_torch.common.tree import flatten

    return {k.replace(".", "/"): v.detach().numpy()
            for k, v in flatten(tree).items()}


def jax_case(arch):
    """The JAX package's run of one small decoder."""
    import jax
    import jax.numpy as jnp

    from repro.data.tokens import TokenPipeline
    from repro.models.model_zoo import build_model
    from repro.optim.adamw import AdamW
    from repro.optim.schedule import cosine_schedule

    cfg = config(arch, "jax")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(SEED))
    opt = AdamW(lr=cosine_schedule(PEAK, WARMUP, STEPS))

    @jax.jit
    def step(p, st, batch):
        (loss, met), grads = jax.value_and_grad(model.loss,
                                                has_aux=True)(p, batch)
        p2, st2, _ = opt.update(grads, st, p)
        return loss, met, grads, p2, st2

    pipe = TokenPipeline(cfg.vocab_size, S, B, seed=SEED)
    batches = [pipe.batch_at(i) for i in range(STEPS)]
    p, st = params, opt.init(params)
    grads_at = []
    for i, batch in enumerate(batches):
        loss, met, grads, p, st = step(p, st, batch)
        grads_at.append(flat_np(grads))
        if i == 0:
            first = (float(loss), float(met["ce"]), float(met["aux"]))
    return {"cfg": cfg, "model": model, "opt": opt, "step": step,
            "params": jax.tree_util.tree_map(np.asarray, params),
            "tokens": np.stack([np.asarray(b["tokens"]) for b in batches]),
            "labels": np.stack([np.asarray(b["labels"]) for b in batches]),
            "loss": first[0], "ce": first[1], "aux": first[2],
            "grads": grads_at, "params_after": flat_np(p)}


def jax_pipeline():
    from repro.data.tokens import TokenPipeline

    pipe = TokenPipeline(FULL_VOCAB, FULL_SEQ, FULL_BATCH, seed=SEED)
    batches = [pipe.batch_at(s) for s in FULL_STEPS]
    return {k: np.stack([np.asarray(b[k]) for b in batches])
            for k in ("tokens", "labels")}


class Runs(dict):
    """Arch -> its JAX run, computed on first use."""

    def __missing__(self, arch):
        self[arch] = jax_case(arch)
        return self[arch]


@pytest.fixture(scope="module")
def runs():
    return Runs()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The small models' ops run on one torch thread: with the suite in
    six xdist workers on eight cores, eight threads a worker made this
    file's CPU ops some 30x slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_chip_smoke():
    """``chip_smoke.py`` as a module: the script touches no card at
    import."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke.py``'s helpers."""
    return load_chip_smoke()


# the inputs of a training batch a golden may hold, by family
BATCH_KEYS = ("tokens", "labels", "embeddings", "positions", "frames")


def golden_payload(arch, run):
    out = {f"{arch}/config": json.dumps(dataclasses.asdict(run["cfg"]))}
    out.update({f"{arch}/{k}": run[k] for k in BATCH_KEYS if k in run})
    out.update({f"{arch}/{k}": np.float32(run[k])
                for k in ("loss", "ce", "aux")})
    for i, grads in enumerate(run["grads"]):
        out.update({f"{arch}/grads/{i}/{k}": v for k, v in grads.items()})
    out.update({f"{arch}/params_after/{k}": v
                for k, v in run["params_after"].items()})
    return out


def write(path: Path = GOLDEN) -> None:
    payload = {"adamw/peak": np.float64(PEAK),
               "adamw/warmup": np.int64(WARMUP),
               "adamw/steps": np.int64(STEPS),
               "pipeline/vocab": np.int64(FULL_VOCAB),
               "pipeline/seq": np.int64(FULL_SEQ),
               "pipeline/batch": np.int64(FULL_BATCH),
               "pipeline/steps": np.asarray(FULL_STEPS, np.int64)}
    payload.update({f"pipeline/{k}": v for k, v in jax_pipeline().items()})
    for arch in ZOO:
        payload.update(golden_payload(arch, jax_case(arch)))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **payload)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


# ------------------------------------------------------------ helpers
def port_params(run, cfg, tmp_path=None):
    """The JAX parameters in the port: through a ``step_<n>.npz`` the
    reference's ``CheckpointManager`` wrote, when ``tmp_path`` is
    given."""
    from repro_torch.models.params import lm_params

    if tmp_path is None:
        return lm_params(run["params"], cfg, device="cpu")
    from repro.checkpointing.manager import CheckpointManager

    CheckpointManager(tmp_path, async_save=False).save(0, run["params"])
    with np.load(tmp_path / "step_0.npz") as z:
        return lm_params({k: z[k] for k in z.files}, cfg, device="cpu")


def batch(run, i):
    return {k: torch.as_tensor(run[k][i]) for k in ("tokens", "labels")}


def rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def check_grads(got, want, label):
    assert set(got) == set(want), label
    for k in want:
        assert rel(got[k], want[k]) <= GRAD_RTOL, f"{label}: grad {k}"


def jax_train(cfg, params, arrays):
    """The JAX package's STEPS AdamW steps of ``cfg``'s model from
    ``params`` (a numpy tree) on the batches ``arrays`` ({input: (STEPS,
    ...) numpy}), under ``cosine_schedule(PEAK, WARMUP, STEPS)``: a run
    as :func:`golden_payload` writes it."""
    import jax

    from repro.models.model_zoo import build_model
    from repro.optim.adamw import AdamW
    from repro.optim.schedule import cosine_schedule

    model = build_model(cfg)
    opt = AdamW(lr=cosine_schedule(PEAK, WARMUP, STEPS))
    grad = jax.jit(jax.value_and_grad(model.loss, has_aux=True))
    update = jax.jit(opt.update)
    p, st = params, opt.init(params)
    grads_at = []
    for i in range(STEPS):
        (loss, met), grads = grad(p, {k: v[i] for k, v in arrays.items()})
        p, st, _ = update(grads, st, p)
        grads_at.append(flat_np(grads))
        if i == 0:
            first = (float(loss), float(met["ce"]), float(met["aux"]))
    return {"cfg": cfg, "params": params, **arrays, "loss": first[0],
            "ce": first[1], "aux": first[2], "grads": grads_at,
            "params_after": flat_np(p)}


def train_golden(run, cfg):
    """A live JAX run as the port's ``LMTrainGolden`` of ``cfg``, for
    ``chip_smoke.lm_train_golden_errors``."""
    from repro_torch.models.params import LMTrainGolden, restore

    return LMTrainGolden(
        config=cfg, params=restore(flat_np(run["params"]), cfg),
        tokens=run.get("tokens"), labels=run["labels"], loss=run["loss"],
        ce=run["ce"], aux=run["aux"],
        grads=[restore(g, cfg) for g in run["grads"]],
        params_after=restore(run["params_after"], cfg),
        adamw={"peak": PEAK, "warmup": WARMUP, "steps": STEPS},
        embeddings=run.get("embeddings"), positions=run.get("positions"),
        frames=run.get("frames"))


def check_input_specs(smoke, arch, B, S, **kwargs):
    """``chip_smoke.lm_train_batch`` of the small and the full ``arch``
    against the reference's ``Model.input_specs(ShapeConfig(..., "train"))``:
    the same keys, shapes and types."""
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models.config import ShapeConfig
    from repro.models.model_zoo import build_model
    from repro_torch.configs import get_config

    for small in (True, False):
        cfgs = [get(arch) for get in (jax_config, get_config)]
        if small:
            cfgs = [c.scaled_down(dtype="float32") for c in cfgs]
        want = build_model(cfgs[0]).input_specs(
            ShapeConfig("train", S, B, "train"))["batch"]
        got = smoke.lm_train_batch(cfgs[1], B, S, seed=0, device="cpu",
                                   **kwargs)
        assert set(got) == set(want), (arch, small)
        for k, spec in want.items():
            assert tuple(got[k].shape) == spec.shape, (arch, small, k)
            assert (str(got[k].dtype).split(".")[-1]
                    == jnp.dtype(spec.dtype).name), (arch, small, k)


# ------------------------------------------------------------ threefry
def _key(seed, step):
    import jax

    from repro_torch.common import rng

    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    return key, rng.as_key(np.asarray(key))


@pytest.mark.parametrize("lo,hi", [(0, 256), (0, 49152), (0, 64), (5, 1000),
                                   (-7, 3), (0, 100000), (0, 2 ** 31 - 1),
                                   (-2 ** 31, 2 ** 31 - 1), (3, 3)])
def test_randint_matches_jax(lo, hi):
    import jax

    from repro_torch.common import rng

    key, tk = _key(3, 17)
    want = np.asarray(jax.random.randint(key, (4, 33), lo, hi))
    got = rng.randint(tk, (4, 33), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [0.7, 0.5, 0.01])
def test_split_bernoulli_and_uniform32_match_jax(p):
    import jax

    from repro_torch.common import rng

    key, tk = _key(1, 5)
    np.testing.assert_array_equal(
        rng.split(tk, 3).numpy(),
        np.asarray(jax.random.split(key, 3)).astype(np.int64))
    np.testing.assert_array_equal(
        rng.bernoulli(tk, p, (8, 50)).numpy(),
        np.asarray(jax.random.bernoulli(key, p, (8, 50))))
    np.testing.assert_array_equal(
        rng.uniform32(tk, (100,)).numpy(),
        np.asarray(jax.random.uniform(key, (100,))))


# ------------------------------------------------------------ pipeline
# each shape compiles the reference's scan anew; the full vocabulary at
# B 8 x S 2048 is held through the golden file
@pytest.mark.parametrize("vocab,seq,batch_size,seed", [
    (64, 8, 2, 0), (7, 300, 3, 5), (49152, 1, 2, 1)])
def test_batch_at_matches_jax(vocab, seq, batch_size, seed):
    from repro.data.tokens import TokenPipeline as JaxPipeline
    from repro_torch.data.tokens import TokenPipeline

    ref = JaxPipeline(vocab, seq, batch_size, seed=seed)
    port = TokenPipeline(vocab, seq, batch_size, seed=seed, device="cpu")
    for step in (0, 17, 1000):
        want, got = ref.batch_at(step), port.batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    assert port.state_dict(4) == ref.state_dict(4)
    assert TokenPipeline.restore_step({"seed": 0, "step": 9}) == 9
    it = port.iterate(16)
    next(it)
    assert torch.equal(next(it)["tokens"], port.batch_at(17)["tokens"])


def test_batch_at_full_vocabulary_matches_golden():
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.params import load_pipeline_golden

    g = load_pipeline_golden()
    port = TokenPipeline(g["vocab"], g["seq"], g["batch"], seed=SEED,
                         device="cpu")
    for i, step in enumerate(g["steps"]):
        got = port.batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), g[k][i])


def test_pipeline_needs_a_card_unless_asked_for_the_cpu():
    from repro_torch.data.tokens import TokenPipeline

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenPipeline(64, 8, 2)


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("name,args", [
    ("cosine_schedule", (3e-4, 10, 30)), ("cosine_schedule", (1.0, 0, 1)),
    ("cosine_schedule", (1e-3, 1, 3)), ("linear_warmup", (1e-3, 7))])
def test_schedules_match_jax(name, args):
    import jax.numpy as jnp

    from repro.optim import schedule as ref
    from repro_torch.optim import schedule

    steps = np.arange(0, 45, dtype=np.int32)
    want = np.asarray(getattr(ref, name)(*args)(jnp.asarray(steps)))
    got = getattr(schedule, name)(*args)(torch.as_tensor(steps))
    assert got.dtype == torch.float32
    # XLA's float32 cos and torch's may differ in the last bit
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=0)


def test_compress_gradients_matches_jax():
    import jax.numpy as jnp

    from repro.optim import compress as ref
    from repro_torch.optim import compress_gradients, decompress_gradients

    rng = np.random.default_rng(0)
    g = {"a": rng.normal(size=(5, 7)).astype(np.float32),
         "b": [rng.normal(size=(3,)).astype(np.float32) * 1e-3]}
    to_jax = lambda t: {"a": jnp.asarray(t["a"]), "b": [jnp.asarray(t["b"][0])]}
    to_port = lambda t: {"a": torch.as_tensor(t["a"]),
                         "b": [torch.as_tensor(t["b"][0])]}
    jerr, perr = None, None
    for _ in range(3):  # the error feedback carries over
        (jq, js), jerr = ref.compress_gradients(to_jax(g), jerr)
        (pq, ps), perr = compress_gradients(to_port(g), perr)
        for k in ("a", "b"):
            a = jq[k] if k == "a" else jq[k][0]
            b = pq[k] if k == "a" else pq[k][0]
            assert b.dtype == torch.int8
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_allclose(perr["a"].numpy(), np.asarray(jerr["a"]),
                                   rtol=0, atol=1e-7)
    deq = decompress_gradients(pq, ps)
    np.testing.assert_allclose(
        deq["a"].numpy(), np.asarray(ref.decompress_gradients(jq, js)["a"]),
        rtol=1e-7)


def test_adamw_takes_a_nested_tree_and_state_dtype():
    from repro_torch.optim import AdamW, cosine_schedule

    params = {"w": [torch.ones(3, 2)], "n": {}, "b": torch.zeros(2)}
    opt = AdamW(lr=cosine_schedule(1e-2, 1, 4), state_dtype=torch.bfloat16)
    st = opt.init(params)
    assert st.m["w"][0].dtype == torch.bfloat16 and st.m["n"] == {}
    grads = {"w": [torch.full((3, 2), 0.5)], "n": {}, "b": torch.ones(2)}
    new, st2, met = opt.update(grads, st, params)
    assert new["n"] == {} and new["w"][0].dtype == torch.float32
    assert int(st2.step) == 1 and st2.v["b"].dtype == torch.bfloat16
    assert float(met["lr"]) == pytest.approx(1e-2)


# ------------------------------------------------------------ flash
@pytest.mark.parametrize("causal,window,T", [(True, 0, None), (True, 8, None),
                                             (False, 0, None),
                                             (False, 0, 24)])
def test_plain_flash_gradients_match_jax(causal, window, T):
    """The port's plain flash under autograd against ``jax.vjp`` of the
    reference's ``ref.attention`` and against the Pallas route's custom
    VJP in interpret mode (``tests/test_kernels.py:41-59``)."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.flash_attention import ops as jops
    from repro.kernels.flash_attention import ref as jref
    from repro_torch.kernels.flash_attention import ops

    Bq, H, KH, Sq, D = 2, 4, 2, 64, 16
    T = Sq if T is None else T
    rng = np.random.default_rng(7)
    q = rng.normal(size=(Bq, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(Bq, T, KH, D)).astype(np.float32)
    v = rng.normal(size=(Bq, T, KH, D)).astype(np.float32)
    g = rng.normal(size=(Bq, Sq, H, D)).astype(np.float32)
    mode = dict(causal=causal, window=window)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    ops.flash_attention(tq, tk, tv, **mode).backward(torch.as_tensor(g))
    got = [t.grad.numpy() for t in (tq, tk, tv)]

    tr = lambda x: jnp.swapaxes(x, 1, 2)
    _, vjp = jax.vjp(lambda a, b, c: tr(jref.attention(
        tr(a), tr(b), tr(c), **mode)), *map(jnp.asarray, (q, k, v)))
    for a, b in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    if T == Sq:  # the Pallas kernel takes S = T
        _, vjp = jax.vjp(lambda a, b, c: jops.flash_attention(
            a, b, c, **mode, interpret=True), *map(jnp.asarray, (q, k, v)))
        for a, b in zip(got, vjp(jnp.asarray(g))):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-5)


# ------------------------------------------------------------ loss
@pytest.mark.parametrize("arch", PARITY)
def test_loss_and_gradients_match_jax(runs, arch, tmp_path):
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.model_zoo import build_model

    run = runs[arch]
    cfg = config(arch, "torch")
    params = port_params(run, cfg, tmp_path)
    model = build_model(cfg)
    (loss, met), grads = value_and_grad(model.loss, params, batch(run, 0))
    for name, value in (("loss", loss), ("ce", met["ce"]),
                        ("aux", met["aux"])):
        assert float(value) == pytest.approx(run[name], rel=LOSS_RTOL,
                                             abs=LOSS_RTOL), name
    check_grads(flat_port(grads), run["grads"][0], arch)


@pytest.mark.parametrize("arch", ZOO)
def test_port_on_cpu_matches_golden(smoke, arch):
    """What ``chip_smoke.py`` holds the card to, on the CPU: the batches,
    the loss terms, every gradient leaf at each of three AdamW steps
    under ``cosine_schedule``, and the port's AdamW on the JAX gradients
    (``chip_smoke.lm_train_golden_errors``)."""
    from repro_torch.models.params import load_lm_train_golden

    out = smoke.lm_train_golden_errors(load_lm_train_golden(arch),
                                       device="cpu")
    assert out["params"] <= PARAMS_ATOL
    # the forward once and again under remat, no backward kernel on the CPU
    assert out["launches"] == {"forward": 0, "backward": 0}


def test_bf16_train_step_matches_jax(runs):
    """``make_train_step``'s master-weight step: bf16 compute, float32
    masters updated, against the reference's on the same batch."""
    import jax
    import jax.numpy as jnp

    from repro.launch.steps import make_train_step as jax_step
    from repro_torch.common.tree import flatten
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import AdamW, cosine_schedule

    arch = "smollm-135m"
    run = runs[arch]
    jparams = jax.tree_util.tree_map(jnp.asarray, run["params"])
    jst = run["opt"].init(jparams)
    jbatch = {k: jnp.asarray(run[k][0]) for k in ("tokens", "labels")}
    jp, js, jm = jax.jit(jax_step(run["model"], run["opt"]))(jparams, jst,
                                                             jbatch)
    cfg = config(arch, "torch")
    params = port_params(run, cfg)
    opt = AdamW(lr=cosine_schedule(PEAK, WARMUP, STEPS))
    p, st, m = make_train_step(build_model(cfg), opt)(params, opt.init(params),
                                                      batch(run, 0))
    assert all(t.dtype == torch.float32 for t in flatten(p).values())
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                             rel=BF16_LOSS_RTOL)
    assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    got, want = flat_port(st.m), flat_np(js.m)
    for k in want:
        dist = (np.linalg.norm(got[k] - want[k])
                / max(np.linalg.norm(want[k]), 1e-30))
        assert dist <= BF16_MOMENT_RTOL, k


# ------------------------------------------------------------ runtime
def _runtime(tmp_path, fail_at=None, steps_between_ckpt=5):
    """``tests/test_runtime.py::_runtime`` inside the port."""
    from repro_torch.checkpointing.manager import CheckpointManager
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.runtime.fault import FailureInjector, TrainingRuntime

    pipeline = TokenPipeline(vocab_size=64, seq_len=8, global_batch=2,
                             seed=0, device="cpu")
    seen_batches = []

    def init_state(hosts):
        return {"w": torch.zeros(()), "n": torch.zeros(())}

    def train_step(state, batch, hosts):
        seen_batches.append(int(batch["tokens"].sum()))
        new = {"w": state["w"] + 1.0, "n": state["n"] + 1.0}
        return new, {"loss": float(new["w"])}

    rt = TrainingRuntime(
        hosts=["h0", "h1", "h2", "h3"], train_step=train_step,
        init_state=init_state, pipeline=pipeline,
        ckpt=CheckpointManager(tmp_path, async_save=False),
        checkpoint_every=steps_between_ckpt,
        failure_injector=FailureInjector(
            {fail_at: ["h2"]} if fail_at else None))
    return rt, seen_batches


def test_runtime_runs_to_completion(tmp_path):
    rt, _ = _runtime(tmp_path)
    out = rt.run(12)
    assert len(out["losses"]) == 12
    assert out["restarts"] == 0


def test_runtime_recovers_from_failure(tmp_path):
    rt, seen = _runtime(tmp_path, fail_at=8)
    out = rt.run(12)
    assert out["restarts"] == 1
    assert "h2" not in out["final_hosts"]
    assert any(ev.kind == "failure" for ev in out["events"])
    assert float(out["state"]["w"]) >= 12 - 1
    # steps 6 and 7 replayed from the step-5 checkpoint see the same
    # batches (deterministic pipeline)
    assert seen[6:8] == seen[8:10]


def test_runtime_restart_resumes_from_checkpoint(tmp_path):
    rt, _ = _runtime(tmp_path)
    rt.run(11)  # checkpoints at 0, 5, 10
    rt2, _ = _runtime(tmp_path)
    out = rt2.run(12)  # resumes at 11, runs one step
    assert any(ev.kind == "restart" for ev in out["events"])
    assert len(out["losses"]) == 1


def _lm_runtime(pkg, run, ckpt_dir):
    """The small smollm trained 6 steps with a failure at step 4 and a
    checkpoint every 2 steps, in one package."""
    if pkg == "jax":
        import jax
        import jax.numpy as jnp

        from repro.checkpointing.manager import CheckpointManager
        from repro.data.tokens import TokenPipeline
        from repro.runtime.fault import FailureInjector, TrainingRuntime

        def init_state(hosts):
            p = jax.tree_util.tree_map(jnp.asarray, run["params"])
            return {"params": p, "opt": run["opt"].init(p)}

        def train_step(state, batch, hosts):
            loss, _, _, p, st = run["step"](state["params"], state["opt"],
                                            batch)
            return {"params": p, "opt": st}, {"loss": float(loss)}
    else:
        from repro_torch.checkpointing.manager import CheckpointManager
        from repro_torch.data.tokens import TokenPipeline
        from repro_torch.launch.steps import value_and_grad
        from repro_torch.models.model_zoo import build_model
        from repro_torch.optim import AdamW, cosine_schedule
        from repro_torch.runtime.fault import FailureInjector, TrainingRuntime

        cfg = config("smollm-135m", "torch")
        model = build_model(cfg)
        opt = AdamW(lr=cosine_schedule(PEAK, WARMUP, STEPS))

        def init_state(hosts):
            p = port_params(run, cfg)
            return {"params": p, "opt": opt.init(p)}

        def train_step(state, batch, hosts):
            (loss, _), grads = value_and_grad(model.loss, state["params"],
                                              batch)
            p, st, _ = opt.update(grads, state["opt"], state["params"])
            return {"params": p, "opt": st}, {"loss": float(loss)}

    kw = {} if pkg == "jax" else {"device": "cpu"}
    rt = TrainingRuntime(
        hosts=["h0", "h1", "h2"], train_step=train_step,
        init_state=init_state,
        pipeline=TokenPipeline(run["cfg"].vocab_size, S, B, seed=SEED, **kw),
        ckpt=CheckpointManager(ckpt_dir, async_save=False),
        checkpoint_every=2, failure_injector=FailureInjector({4: ["h1"]}))
    return rt.run(6)


def test_runtime_runs_alike_in_both_packages(runs, tmp_path):
    run = runs["smollm-135m"]
    want = _lm_runtime("jax", run, tmp_path / "jax")
    got = _lm_runtime("torch", run, tmp_path / "torch")
    assert [(e.step, e.kind, e.detail) for e in got["events"]] == \
        [(e.step, e.kind, e.detail) for e in want["events"]]
    assert (got["restarts"], got["final_hosts"]) == \
        (want["restarts"], want["final_hosts"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert len(got["losses"]) == 7  # step 3 runs twice


def test_training_checkpoint_restores_in_either_package(runs, tmp_path):
    """{"params", "opt": OptState} as ``step_<n>.npz``: written by the
    reference's manager and read by the port's, and back, bit for bit."""
    import jax
    import jax.numpy as jnp

    from repro.checkpointing.manager import CheckpointManager as JaxManager
    from repro_torch.checkpointing.manager import CheckpointManager
    from repro_torch.optim import AdamW, OptState

    run = runs["smollm-135m"]
    jparams = jax.tree_util.tree_map(jnp.asarray, run["params"])
    rng = np.random.default_rng(3)
    jm = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), jparams)
    jstate = {"params": jparams,
              "opt": run["opt"].init(jparams).__class__(
                  m=jm, v=jm, step=jnp.asarray(7, jnp.int32))}
    JaxManager(tmp_path / "a", async_save=False).save(7, jstate)
    cfg = config("smollm-135m", "torch")
    params = port_params(run, cfg)
    template = {"params": params, "opt": AdamW().init(params)}
    got, meta = CheckpointManager(tmp_path / "a").restore(template)
    assert meta["step"] == 7 and isinstance(got["opt"], OptState)
    assert int(got["opt"].step) == 7 and got["opt"].step.dtype == torch.int32
    for k, v in flat_np(jstate["opt"].m).items():
        np.testing.assert_array_equal(flat_port(got["opt"].m)[k], v)
    # and back: the port writes, the reference restores
    CheckpointManager(tmp_path / "b", async_save=False).save(9, got)
    back, meta = JaxManager(tmp_path / "b").restore(jstate)
    assert meta["step"] == 9 and int(back["opt"].step) == 7
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------ entry point
def test_train_main_prints_the_reference_lines(tmp_path):
    from repro_torch.launch import train

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = train.main(["--steps", "6", "--hosts", "2", "--fail-at",
                             "4", "--device", "cpu", "--checkpoint-every",
                             "2", "--ckpt-dir", str(tmp_path)])
    lines = out.getvalue().splitlines()
    assert re.fullmatch(r"\[perona\] cluster ranked in \d+\.\ds: "
                        r"\['host-\d', 'host-\d'\]", lines[0])
    assert re.fullmatch(r"\[train\] steps=7 loss -?\d+\.\d{3} -> "
                        r"-?\d+\.\d{3}; restarts=1; hosts=\['host-0'\]",
                        lines[1])
    assert lines[2:] == ["[event] step=4 failure: host-1"]
    assert len(result["losses"]) == 7 and len(result["step_ms"]) == 7
    assert np.all(np.isfinite(result["losses"]))
    assert (tmp_path / "smollm-135m" / "step_4.npz").exists()


# ------------------------------------------------------------ the card
@pytest.mark.gpu
def test_recurrent_kernels_refuse_a_gradient_on_the_card():
    """Under grad on a CUDA tensor the RG-LRU and the mLSTM launch their
    backward kernels once each, and the mLSTM refuses a cotangent of its
    returned state; flash launches its backward at a square pair and
    refuses a bfloat16 gradient at (24, 16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mlstm import ops as mlstm_ops
    from repro_torch.kernels.rg_lru import ops as lru_ops

    cuda = dict(device="cuda")
    a = torch.rand(1, 8, 32, **cuda).requires_grad_()
    before = lru_ops.BWD_LAUNCHES
    y, _ = lru_ops.linear_scan(a, torch.rand(1, 8, 32, **cuda))
    y.sum().backward()
    assert lru_ops.BWD_LAUNCHES == before + 1 and a.grad is not None
    q = torch.randn(1, 64, 2, 32, **cuda).requires_grad_()
    gates = [torch.randn(1, 64, 2, **cuda) for _ in range(2)]
    before = mlstm_ops.BWD_LAUNCHES
    h, _ = mlstm_ops.mlstm_chunkwise(q, q.detach(), q.detach(), *gates)
    h.sum().backward()
    assert mlstm_ops.BWD_LAUNCHES == before + 1 and q.grad is not None
    h, (C, _, _) = mlstm_ops.mlstm_chunkwise(q, q.detach(), q.detach(),
                                             *gates)
    with pytest.raises(ValueError, match="returned state"):
        (h.sum() + C.sum()).backward()
    q, k, v = (torch.randn(1, 70, 2, 64, **cuda).requires_grad_()
               for _ in range(3))
    before = fa_ops.BWD_LAUNCHES
    fa_ops.flash_attention(q, k, v).sum().backward()
    assert fa_ops.BWD_LAUNCHES == before + 1
    bf16 = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn(1, 8, 2, 24, **bf16).requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        fa_ops.flash_attention(q, torch.randn(1, 8, 2, 24, **bf16),
                               torch.randn(1, 8, 2, 16, **bf16))


# ------------------------------------------------------------ golden file
@pytest.mark.parametrize("arch", ZOO)
def test_golden_is_fresh(runs, arch):
    from repro_torch.models.params import load_lm_train_golden

    g = load_lm_train_golden(arch)
    run = runs[arch]
    assert dataclasses.asdict(g.config) == dataclasses.asdict(
        config(arch, "torch"))
    assert g.adamw == {"peak": PEAK, "warmup": WARMUP, "steps": STEPS}
    np.testing.assert_array_equal(g.tokens, run["tokens"])
    np.testing.assert_array_equal(g.labels, run["labels"])
    for name in ("loss", "ce", "aux"):
        assert getattr(g, name) == pytest.approx(run[name], rel=LOSS_RTOL,
                                                 abs=LOSS_RTOL)
    for i, grads in enumerate(g.grads):
        check_grads(flat_port(grads), run["grads"][i], f"{arch} golden")
    for k, want in run["params_after"].items():
        np.testing.assert_allclose(flat_port(g.params_after)[k], want,
                                   rtol=0, atol=1e-7, err_msg=k)
    # the initial parameters are lm_zoo_small_golden.npz's
    for k, want in flat_np(run["params"]).items():
        np.testing.assert_array_equal(flat_port(g.params)[k], want)


def test_golden_pipeline_is_fresh():
    from repro_torch.models.params import load_pipeline_golden

    g = load_pipeline_golden()
    assert (g["vocab"], g["seq"], g["batch"], tuple(g["steps"])) == (
        FULL_VOCAB, FULL_SEQ, FULL_BATCH, FULL_STEPS)
    want = jax_pipeline()
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(g[k], want[k])


def test_golden_file_is_small():
    assert GOLDEN.stat().st_size < 10 << 20


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_lm_train.py --write")
    write()
