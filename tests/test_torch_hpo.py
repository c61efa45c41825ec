"""The port's HPO (``repro_torch.tuning.hpo``) against the JAX package's
``repro.tuning.hpo.search`` in the dropout-0 space, from the same trials
and the same JAX-initialised parameters, at ``tests/test_hpo_vmap.py``'s
size (6 trials of 8 epochs); and its capture count.

JAX's search runs with ``vmapped=False`` (its scanned trainer, one
compile a bucket; the vmapped programs take twice as long to compile):
``tests/test_hpo_vmap.py`` holds the vmapped search to it within the
limits used here."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import model as jmodel  # noqa: E402
from repro.tuning import hpo as jhpo  # noqa: E402
from repro_torch.core import model as M  # noqa: E402
from repro_torch.core import trainer as T  # noqa: E402
from repro_torch.tuning import hpo  # noqa: E402
from test_torch_train import jax_tree  # noqa: E402

N_TRIALS = 6
EPOCHS = 8
SEED = 0
# tests/test_hpo_vmap.py's limits between the JAX package's two searches
F1_ATOL = 1e-6
VAL_LOSS_ATOL = 1e-4


def dropout_free_space(space):
    return {**space, "feature_dropout": (0.0, 0.0),
            "edge_dropout": (0.0, 0.0)}


def jax_init(t, cfg):
    """Trial ``t``'s initial parameters as the JAX search draws them."""
    jcfg = jmodel.PeronaConfig(**dataclasses.asdict(cfg))
    return jax_tree(jmodel.PeronaModel(jcfg).init(
        jax.random.PRNGKey(SEED + t)))


@pytest.fixture(scope="module")
def setup():
    """``tests/test_hpo_vmap.py``'s setup with alpha dropout 0."""
    from repro.core.graph_data import build_graphs, chronological_split
    from repro.core.preprocess import Preprocessor
    from repro.fingerprint.runner import SuiteRunner

    runner = SuiteRunner(seed=7)
    frame = runner.run_frame({"m0": "e2-medium", "m1": "n2-standard-4"},
                             runs_per_type=10, stress_fraction=0.2)
    tr, va, _ = chronological_split(frame, (0.7, 0.3, 0.0))
    pre = Preprocessor().fit(tr)
    tb, vb = build_graphs(tr, pre), build_graphs(va, pre)
    jcfg = jmodel.PeronaConfig(feature_dim=pre.feature_dim,
                               edge_dim=tb.edge.shape[-1],
                               alpha_dropout=0.0)
    return jcfg, M.PeronaConfig(**dataclasses.asdict(jcfg)), tb, vb


@pytest.fixture(scope="module")
def searches(setup):
    """JAX's search and the port's searches, the port's with their
    statistics, in the dropout-0 space."""
    jcfg, cfg, tb, vb = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhpo, "SPACE", dropout_free_space(jhpo.SPACE))
        mp.setattr(hpo, "SPACE", dropout_free_space(hpo.SPACE))
        want = jhpo.search(jcfg, tb, vb, n_trials=N_TRIALS, epochs=EPOCHS,
                           seed=SEED, vmapped=False)
        T._program.cache_clear()
        got = hpo.search(cfg, tb, vb, n_trials=N_TRIALS, epochs=EPOCHS,
                         seed=SEED, return_stats=True, device="cpu",
                         init_params=jax_init)
        again = hpo.search(cfg, tb, vb, n_trials=N_TRIALS, epochs=EPOCHS,
                           seed=SEED, return_stats=True, device="cpu",
                           init_params=jax_init)
        seq = hpo.search_sequential(cfg, tb, vb, n_trials=N_TRIALS,
                                    epochs=EPOCHS, seed=SEED, device="cpu",
                                    init_params=jax_init)
    return {"jax": want, "port": got, "again": again, "sequential": seq}


def test_search_matches_jax_search(searches):
    """The same trials, buckets and best trial; each trial's F1 within
    1e-6 and its validation loss within 1e-4."""
    best_j, trials_j = searches["jax"]
    best, trials, stats = searches["port"]
    assert [t.params for t in trials] == [t.params for t in trials_j]
    assert all(t.params["feature_dropout"] == 0.0 for t in trials)
    buckets = {}
    for t in trials_j:  # JAX's bucketing (repro/tuning/hpo.py:171-176)
        key = (t.params["heads"], t.params["use_root_weight"])
        buckets[key] = buckets.get(key, 0) + 1
    assert stats.bucket_sizes == buckets and stats.n_buckets == len(buckets)
    for a, b in zip(trials, trials_j):
        np.testing.assert_allclose(a.val_f1, b.val_f1, atol=F1_ATOL)
        np.testing.assert_allclose(a.val_loss, b.val_loss,
                                   atol=VAL_LOSS_ATOL)
    assert best.params == best_j.params
    assert best.result.best_epoch == best_j.result.best_epoch
    np.testing.assert_allclose(
        [e["val_loss"] for e in best.result.history],
        [e["val_loss"] for e in best_j.result.history], atol=VAL_LOSS_ATOL)


def test_search_equals_search_sequential(searches):
    _, trials, _ = searches["port"]
    best_s, trials_s = searches["sequential"]
    assert [t.params for t in trials] == [t.params for t in trials_s]
    for a, b in zip(trials, trials_s):
        np.testing.assert_allclose(a.val_f1, b.val_f1, atol=F1_ATOL)
        np.testing.assert_allclose(a.val_loss, b.val_loss,
                                   atol=VAL_LOSS_ATOL)
    assert searches["port"][0].params == best_s.params


def test_one_capture_per_bucket_and_none_on_a_repeat(searches):
    _, _, stats = searches["port"]
    assert stats.trace_count == stats.n_buckets
    assert stats.device_calls == N_TRIALS
    _, _, again = searches["again"]
    assert again.trace_count == 0 and again.device_calls == N_TRIALS


def test_only_the_best_trial_keeps_its_result(searches):
    best, trials, _ = searches["port"]
    assert best.score == max(t.score for t in trials)
    assert sum(t.result is not None for t in trials) == 1
    assert {"epoch", "train_loss", "val_loss",
            "val_f1_outlier"} <= set(best.result.history[0])


def test_seeded_initialisation_without_a_hook(setup):
    """With no hook the trials start from the port's seeded
    initialisation: the same seed gives the same search."""
    _, cfg, tb, vb = setup
    runs = [hpo.search(cfg, tb, vb, n_trials=2, epochs=2, seed=5,
                       device="cpu")[1] for _ in range(2)]
    assert [t.params for t in runs[0]] == [t.params for t in runs[1]]
    for a, b in zip(*runs):
        assert np.isfinite(a.val_loss)
        np.testing.assert_allclose(a.val_loss, b.val_loss, rtol=1e-5)
