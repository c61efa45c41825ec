"""The port's train-then-rank entry points against the JAX package's:
``launch.train.fingerprint_cluster`` and ``tuning.perona_weights.
fingerprint_machine_scores``, from the JAX package's ``PRNGKey(seed)``
parameters. At 0 epochs (the initial parameters) the rankings, the
aspect scores (1e-5) and the watchdog's history equal JAX's; at a few
epochs at the default dropouts (masks differ between the packages)
they run to the end with finite scores."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.model import PeronaConfig as JConfig  # noqa: E402
from repro.core.model import PeronaModel as JModel  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.tuning import perona_weights as jweights  # noqa: E402
from repro_torch.fingerprint.runner import SuiteRunner  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.tuning import perona_weights as weights  # noqa: E402
from test_torch_train import jax_tree  # noqa: E402

SCORE_ATOL = 1e-5
MACHINES = {"host-0": "n2-standard-4", "host-1": "e2-medium",
            "host-2": "n2-standard-4"}
VM_TYPES = ("e2-medium", "n2-standard-4", "c2-standard-4")
SEED = 3


def jax_params(records_of, machines, runs_per_type):
    """The parameters JAX's entry point draws (``PRNGKey(seed)`` at the
    configuration its acquisition gives), as a numpy tree."""
    from repro.core.graph_data import build_graphs, chronological_split
    from repro.core.preprocess import Preprocessor
    from repro.fingerprint.runner import SuiteRunner

    records = SuiteRunner(seed=SEED).run(records_of(machines),
                                         runs_per_type=runs_per_type)
    tr, _, _ = chronological_split(records, (0.7, 0.3, 0.0))
    pre = Preprocessor().fit(tr)
    tb = build_graphs(tr, pre)
    cfg = JConfig(feature_dim=pre.feature_dim, edge_dim=tb.edge.shape[-1])
    return jax_tree(JModel(cfg).init(jax.random.PRNGKey(SEED)))


def assert_scores_equal(got, want, rtol=0.0):
    assert set(got) == set(want)
    for m in want:
        assert set(got[m]) == set(want[m]), m
        for a in want[m]:
            assert abs(got[m][a] - want[m][a]) <= SCORE_ATOL + rtol * abs(
                want[m][a]), (m, a)


def test_fingerprint_cluster_matches_jax_at_zero_epochs():
    want_wd, want_rank, _ = jtrain.fingerprint_cluster(
        MACHINES, seed=SEED, epochs=0, runs_per_type=2)
    params0 = jax_params(lambda m: m, MACHINES, 2)
    wd, ranked, runner = train.fingerprint_cluster(
        MACHINES, seed=SEED, epochs=0, runs_per_type=2, device="cpu",
        params0=params0)
    assert ranked == want_rank
    assert len(wd.history) == len(want_wd.history) == 2 * 6 * len(MACHINES)
    for r, w in zip(wd.history, want_wd.history):
        assert (r.machine, r.machine_type, r.benchmark_type, r.t) == \
            (w.machine, w.machine_type, w.benchmark_type, w.t)
        assert r.metrics.keys() == w.metrics.keys()
    # the watchdog scores with the trained (here: initial) parameters
    got = wd.engine.score(wd.history)
    want = want_wd.engine.score(want_wd.history)
    np.testing.assert_allclose(got.anomaly_prob, want.anomaly_prob,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(got.codes, want.codes, atol=SCORE_ATOL)
    assert isinstance(runner, SuiteRunner)


def test_fingerprint_machine_scores_match_jax_at_zero_epochs():
    want, want_proxy = jweights.fingerprint_machine_scores(
        VM_TYPES, seed=SEED, runs_per_type=3, epochs=0,
        return_calibration=True)
    params0 = jax_params(lambda ts: {f"{m}-0": m for m in ts}, VM_TYPES, 3)
    got, proxy = weights.fingerprint_machine_scores(
        VM_TYPES, seed=SEED, runs_per_type=3, epochs=0,
        return_calibration=True, device="cpu", params0=params0)
    assert_scores_equal(got, want)
    assert proxy == want_proxy
    # the calibration maps scores of about 1 onto proxies of about 1e3
    # to 1e5, so it is held relatively
    assert_scores_equal(weights.calibrate_scores(got, proxy),
                        jweights.calibrate_scores(want, want_proxy),
                        rtol=1e-5)
    norm, want_norm = (weights.normalized_machine_scores(got),
                       jweights.normalized_machine_scores(want))
    for m in want_norm:
        np.testing.assert_allclose(norm[m], want_norm[m], atol=1e-4)


def test_both_train_to_the_end_with_finite_scores():
    wd, ranked, _ = train.fingerprint_cluster(
        MACHINES, seed=SEED, epochs=3, runs_per_type=2, device="cpu")
    assert sorted(ranked) == sorted(MACHINES)
    assert np.isfinite(wd.engine.score(wd.history).anomaly_prob).all()
    scores = weights.fingerprint_machine_scores(
        VM_TYPES, seed=SEED, runs_per_type=2, epochs=3, device="cpu")
    assert sorted(scores) == sorted(VM_TYPES)
    assert all(np.isfinite(v) for per in scores.values()
               for v in per.values())
