"""The port's PeronaWatchdog decides as the JAX package's does, with the
JAX-trained golden parameters: a quickstart-style step 5 and a small
fleet with degraded nodes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.model import PeronaModel as JModel  # noqa: E402
from repro.fingerprint.runner import SuiteRunner as JRunner  # noqa: E402
from repro.runtime.watchdog import PeronaWatchdog as JWatchdog  # noqa: E402
from repro_torch.core.model import PeronaModel  # noqa: E402
from repro_torch.core.params import load_golden  # noqa: E402
from repro_torch.fingerprint.runner import SuiteRunner  # noqa: E402
from repro_torch.runtime.watchdog import PeronaWatchdog  # noqa: E402

from test_torch_golden import GOLDEN, jax_config, jax_params  # noqa: E402

ATOL = 1e-5

QUICKSTART = {  # examples/quickstart.py on the golden model's machine type
    "machines": {n: "e2-medium"
                 for n in ("alpha", "bravo", "charlie", "delta")},
    "history": {"runs_per_type": 40, "stress_fraction": 0.15},
    "rounds": [({"charlie": "e2-medium"}, 1, ["charlie"], 0.0)] * 2,
    "history_per_chain": 64,
}
FLEET = {  # 16 nodes, 8 runs of history per chain, 2 degraded
    "machines": {f"node-{i:03d}": "e2-medium" for i in range(16)},
    "history": {"runs_per_type": 8, "stress_fraction": 0.2},
    "rounds": [(None, 2, ["node-001", "node-005"], 86400.0 * (r + 1))
               for r in range(3)],
    "history_per_chain": 8,
}


@pytest.fixture(scope="module")
def models():
    golden = load_golden()
    with np.load(GOLDEN) as z:
        stored = {k: z[k] for k in z.files}
    return {
        "jax": (JModel(jax_config(stored)), jax_params(stored)),
        "torch": (PeronaModel(golden.config), golden.params),
        "pre": golden.preproc,
    }


def _drive(scenario, watchdog, runner):
    watchdog.history = runner.run_frame(scenario["machines"],
                                        **scenario["history"])
    rounds = []
    for machines, runs, degraded, t_offset in scenario["rounds"]:
        new = runner.run_frame(machines or scenario["machines"], runs,
                               degraded_machines=degraded,
                               t_offset=t_offset)
        rounds.append(watchdog.observe(new))
    return rounds


@pytest.fixture(scope="module", params=["quickstart", "fleet"])
def runs(request, models, fitted):
    scenario = {"quickstart": QUICKSTART, "fleet": FLEET}[request.param]
    hpc = scenario["history_per_chain"]
    jwd = JWatchdog(*models["jax"], fitted["pre"], history_per_chain=hpc)
    twd = PeronaWatchdog(*models["torch"], models["pre"],
                         history_per_chain=hpc, device="cpu")
    return (request.param,
            _drive(scenario, jwd, JRunner(seed=1)), jwd,
            _drive(scenario, twd, SuiteRunner(seed=1)), twd)


def test_decisions_match_jax(runs):
    _, jrounds, _, trounds, _ = runs
    assert len(jrounds) == len(trounds)
    for jd, td in zip(jrounds, trounds):
        assert [(d.node, d.flagged, d.confirmed) for d in jd] == \
            [(d.node, d.flagged, d.confirmed) for d in td]
        for a, b in zip(jd, td):
            assert a.flag_fraction == b.flag_fraction
            np.testing.assert_allclose(b.anomaly_prob, a.anomaly_prob,
                                       atol=ATOL)
            np.testing.assert_allclose(b.anomaly_ewma, a.anomaly_ewma,
                                       atol=ATOL)


def test_degraded_nodes_are_confirmed(runs):
    name, _, jwd, trounds, twd = runs
    degraded = {"quickstart": ["charlie"],
                "fleet": ["node-001", "node-005"]}[name]
    assert sorted(d.node for d in trounds[-1] if d.confirmed) == degraded
    assert sorted(twd.excluded_nodes()) == sorted(jwd.excluded_nodes())


def test_history_and_drift_match_jax(runs):
    _, _, jwd, _, twd = runs
    jf, tf = jwd.history_frame, twd.history_frame
    np.testing.assert_array_equal(jf.t, tf.t)
    np.testing.assert_array_equal(jwd.store.row_id, twd.store.row_id)
    np.testing.assert_allclose(twd.store.anomaly, jwd.store.anomaly,
                               atol=ATOL)
    np.testing.assert_allclose(twd.store.codes, jwd.store.codes, atol=ATOL)
    jr, tr = jwd.drift_report(), twd.drift_report()
    assert sorted(jr) == sorted(tr)
    for node in jr:
        a, b = jr[node], tr[node]
        assert a.n_scored == b.n_scored and a.last_t == b.last_t
        np.testing.assert_allclose(b.anomaly_ewma, a.anomaly_ewma,
                                   atol=ATOL)
        assert sorted(a.aspect_ewma) == sorted(b.aspect_ewma)
        for aspect in a.aspect_ewma:
            np.testing.assert_allclose(b.aspect_ewma[aspect],
                                       a.aspect_ewma[aspect], rtol=1e-5)


def test_empty_round_dispatches_nothing(models):
    from repro_torch.kernels.edge_softmax import ops

    wd = PeronaWatchdog(*models["torch"], models["pre"], device="cpu")
    runner = SuiteRunner(seed=2)
    empty = runner.run_frame({"a": "e2-medium"}, 1).select(np.arange(0))
    assert wd.observe(empty) == []
    assert len(wd.store) == 0
    wd.history = runner.run_frame({"a": "e2-medium"}, 4)
    before = ops.LAUNCHES
    assert wd.observe(empty) == []
    assert ops.LAUNCHES == before


def test_service_path_is_not_ported_yet(models):
    """The name predates the fleet tier: the ``service=`` path raised
    until the port had a fleet scoring service. Now the watchdog takes
    the service's store and context cap instead of raising
    (``tests/test_torch_fleet.py`` holds it to the JAX package)."""
    from repro_torch.fleet import FleetScoringService

    svc = FleetScoringService(*models["torch"], models["pre"],
                              context_per_chain=8, device="cpu")
    wd = PeronaWatchdog(*models["torch"], models["pre"], service=svc,
                        device="cpu")
    assert wd.store is svc.store and wd.history_per_chain == 8
    assert wd.engine is None
