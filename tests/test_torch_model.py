"""PeronaModel forward, parameter transfer and the scoring engine of the
PyTorch port against the JAX package."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing.manager import CheckpointManager  # noqa: E402
from repro.core import model as jmodel  # noqa: E402
from repro.fingerprint.runner import (  # noqa: E402
    paper_acquisition_frame as jpaper_frame)
from repro.serving.engine import FingerprintEngine as JEngine  # noqa: E402
from repro_torch.core.model import PeronaConfig, PeronaModel  # noqa: E402
from repro_torch.core.params import (flat_params, load_golden,  # noqa: E402
                                     load_npz, params_from_numpy)
from repro_torch.fingerprint.runner import paper_acquisition_frame  # noqa
from repro_torch.serving.engine import FingerprintEngine  # noqa: E402

from test_torch_golden import jax_params  # noqa: E402

OUT_KEYS = ("codes", "recon", "agg", "anom_logit", "type_logits")
SCORE_KEYS = ("anomaly_prob", "type_logits", "codes")


def jax_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def small_batch(N=40, F=20, A=7, seed=1):
    """The template of tests/test_kernels.py:267-303, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return {
        "x": rng.random((N, F), np.float32),
        "nbr": np.tile(np.arange(N, dtype=np.int32)[:, None] - 1, (1, 3)),
        "nbr_mask": rng.random((N, 3)) < 0.8,
        "edge": rng.random((N, 3, A), np.float32),
    }


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("use_root_weight", [True, False])
def test_forward_matches_jax(heads, use_root_weight):
    N, F, A = 40, 20, 7
    jcfg = jmodel.PeronaConfig(feature_dim=F, edge_dim=A, heads=heads,
                               use_root_weight=use_root_weight)
    jm = jmodel.PeronaModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    batch = small_batch(N, F, A)
    ref = jm.forward(params, {k: jax.numpy.asarray(v)
                              for k, v in batch.items()}, train=False)

    cfg = PeronaConfig(**dataclasses.asdict(jcfg))
    model = PeronaModel(cfg).eval()
    model.load_state_dict(flat_params(params_from_numpy(jax_tree(params))))
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in batch.items()})
    for key in OUT_KEYS:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=2e-5, err_msg=key)


def test_state_dict_names_are_the_reference_paths():
    from repro.common.tree import tree_flatten_with_paths

    cfg = jmodel.PeronaConfig(feature_dim=20, edge_dim=7)
    params = jax_tree(jmodel.perona_init(cfg, jax.random.PRNGKey(0)))
    jpaths = {p.replace("/", "."): leaf.shape
              for p, leaf in tree_flatten_with_paths(params)}
    model = PeronaModel(PeronaConfig(**dataclasses.asdict(cfg)))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        jpaths
    assert {k: tuple(v.shape) for k, v in flat_params(
        params_from_numpy(params)).items()} == jpaths


@pytest.mark.parametrize("heads", [1, 4])
def test_training_forward_matches_jax_at_dropout_0(heads):
    """The training-mode forward (which took the place of the eval-only
    model's refusal) against the reference's ``forward(train=True)`` at
    dropout 0, with a generator and a key given."""
    N, F, A = 40, 20, 7
    jcfg = jmodel.PeronaConfig(feature_dim=F, edge_dim=A, heads=heads,
                               feature_dropout=0.0, edge_dropout=0.0,
                               alpha_dropout=0.0)
    jm = jmodel.PeronaModel(jcfg)
    params = jm.init(jax.random.PRNGKey(1))
    batch = small_batch(N, F, A)
    ref = jm.forward(params, {k: jax.numpy.asarray(v)
                              for k, v in batch.items()},
                     rng=jax.random.PRNGKey(2), train=True)
    model = PeronaModel(PeronaConfig(**dataclasses.asdict(jcfg)))
    model.load_state_dict(flat_params(params_from_numpy(jax_tree(params))))
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in batch.items()},
                    train=True, generator=torch.Generator().manual_seed(2))
    for key in OUT_KEYS:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=2e-5, err_msg=key)


def test_load_npz_reads_reference_checkpoints(tmp_path):
    cfg = jmodel.PeronaConfig(feature_dim=20, edge_dim=7)
    params = jmodel.perona_init(cfg, jax.random.PRNGKey(3))
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(5, params)
    tree = load_npz(tmp_path / "step_5.npz")
    ref = flat_params(params_from_numpy(jax_tree(params)))
    got = flat_params(tree)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], ref[k]), k
    with pytest.raises(KeyError):
        load_npz(tmp_path / "step_5.npz", prefix="missing/")


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def golden():
    return load_golden()


@pytest.fixture(scope="module")
def port_scores(golden):
    engine = FingerprintEngine(PeronaModel(golden.config), golden.params,
                               golden.preproc, device="cpu")
    return engine.score(paper_acquisition_frame(seed=0))


def test_engine_matches_golden_jax_outputs(golden, port_scores):
    assert port_scores.n_padded == int(golden.score["n_padded"]) == 2048
    for key in SCORE_KEYS:
        np.testing.assert_allclose(getattr(port_scores, key),
                                   golden.score[key], atol=1e-5,
                                   err_msg=key)


def test_engine_matches_live_jax_engine(golden, fitted, port_scores):
    from test_torch_golden import GOLDEN, jax_config

    with np.load(GOLDEN) as z:
        stored = {k: z[k] for k in z.files}
    jengine = JEngine(jmodel.PeronaModel(jax_config(stored)),
                      jax_params(stored), fitted["pre"])
    ref = jengine.score(jpaper_frame(seed=0))
    for key in SCORE_KEYS:
        np.testing.assert_allclose(getattr(port_scores, key),
                                   getattr(ref, key), atol=1e-5,
                                   err_msg=key)


def test_outputs_do_not_depend_on_the_bucket(golden, port_scores):
    engine = FingerprintEngine(PeronaModel(golden.config), golden.params,
                               golden.preproc, min_bucket=4096,
                               device="cpu")
    wide = engine.score(paper_acquisition_frame(seed=0))
    assert wide.n_padded == 4096 and port_scores.n_padded == 2048
    for key in SCORE_KEYS:
        np.testing.assert_array_equal(getattr(wide, key),
                                      getattr(port_scores, key), key)


def test_engine_accepts_records_and_empty_frames(golden, port_scores):
    engine = FingerprintEngine(PeronaModel(golden.config), golden.params,
                               golden.preproc, device="cpu")
    frame = paper_acquisition_frame(seed=0)
    res = engine.score(frame.select(np.arange(100)).to_records())
    assert res.n_padded == 128 and res.anomaly_prob.shape == (100,)
    empty = engine.score(frame.select(np.arange(0)))
    assert empty.anomaly_prob.shape == (0,)
    assert empty.codes.shape == (0, golden.config.code_dim)


def test_engine_rejects_params_that_do_not_fit(golden):
    params = dict(golden.params)
    del params["root"]
    with pytest.raises(ValueError, match="do not match"):
        FingerprintEngine(PeronaModel(golden.config), params,
                          golden.preproc, device="cpu")


def test_engine_runs_on_the_card_by_default(golden):
    """With no device given the engine takes the card; with no card it
    fails instead of running on the CPU."""
    model = PeronaModel(golden.config)
    if torch.cuda.is_available():
        engine = FingerprintEngine(model, golden.params, golden.preproc)
        assert engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FingerprintEngine(model, golden.params, golden.preproc)


@pytest.mark.gpu
def test_engine_on_the_card_matches_golden(golden):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.edge_softmax import ops

    before = ops.LAUNCHES
    engine = FingerprintEngine(PeronaModel(golden.config), golden.params,
                               golden.preproc, device="cuda")
    res = engine.score(paper_acquisition_frame(seed=0))
    assert ops.LAUNCHES > before
    for key in SCORE_KEYS:
        np.testing.assert_allclose(getattr(res, key), golden.score[key],
                                   atol=1e-4, err_msg=key)
