"""The port's regression detector (``repro_torch/obs/regress.py``) against
the JAX package's on the same series and the same snapshot deltas, the
counter names of the attribution rules mapped onto the port's dispatch
accounting (``jax.traces`` -> ``dispatch.signatures``, ``jax.dispatches``
-> ``dispatch.calls``, ``jax.compile_s`` -> ``dispatch.first_s``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.fleet  # noqa: E402,F401  (the reference's regress needs it
#                     imported first: repro.obs.regress -> repro.fleet
#                     -> repro.fleet.modelplane -> repro.obs.regress)
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import regress as jregress  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.obs import regress  # noqa: E402
from repro_torch.obs.dispatch import DispatchSite  # noqa: E402

RPS = "fleet.batched.requests_per_s"
P99 = "fleet.daemon.p99_queue_latency_s"
NOISY = [3200, 2950, 3420, 3050, 3380, 2980, 3350, 3020]
QUIET = [3200, 3210, 3195, 3205, 3200, 3198, 3207, 3201]

# (metric, baseline series, candidate, A/A noise %): the series of the
# reference's gate tests (tests/test_regress.py:168-255)
SERIES = {
    "injected_20pct_regression": (
        RPS, [3200, 3230, 3190, 3210, 3200, 3220], 3200 * 0.8, 0.0),
    "aa_replay": (RPS, [3200.0] * 6, 3200.0, 0.0),
    "p99_increase": (P99, [0.02] * 6, 0.03, 0.0),
    "p99_decrease": (P99, [0.02] * 6, 0.01, 0.0),
    "noisy_within_floor": (RPS, NOISY, float(np.mean(NOISY)) * 0.95, 0.0),
    "quiet_flagged": (RPS, QUIET, float(np.mean(QUIET)) * 0.85, 0.0),
    "aa_null_row_widens": (RPS, [3200.0] * 6, 3200 * 0.89, 12.0),
    "insufficient_history": (RPS, [3200.0] * 2, 1.0, 0.0),
    "informational": ("fleet.daemon.events", [10.0] * 5, 99.0, 0.0),
    "nonfinite_candidate": (RPS, [3200.0] * 6, float("nan"), 0.0),
    "zero_baseline": ("optimizer.speedup", [0.0] * 4, 0.5, 0.0),
}


@pytest.mark.parametrize("case", list(SERIES))
def test_findings_equal_the_references(case):
    metric, series, value, aa = SERIES[case]
    got = regress.evaluate_series("fleet", metric, series, value,
                                  aa_noise_pct=aa)
    want = jregress.evaluate_series("fleet", metric, series, value,
                                    aa_noise_pct=aa)
    a, b = dataclasses.asdict(got), dataclasses.asdict(want)
    assert a.keys() == b.keys()
    for k in b:
        if isinstance(b[k], float) and np.isnan(b[k]):
            assert np.isnan(a[k]), k
        else:
            assert a[k] == b[k], k
    assert got.verdict == want.verdict
    assert got.label == want.label
    if not np.isnan(value):
        assert got.describe() == want.describe()


def test_verdicts_of_the_reference_gate_tests():
    """The verdicts the reference's gate tests assert, in the port."""
    def verdict(case):
        metric, series, value, aa = SERIES[case]
        return regress.evaluate_series("fleet", metric, series, value,
                                       aa_noise_pct=aa)

    f = verdict("injected_20pct_regression")
    assert f.regressed and f.delta_pct < -15.0
    f = verdict("aa_replay")
    assert f.verdict == regress.VERDICT_OK and f.n_baseline == 6
    f = verdict("p99_increase")
    assert f.regressed and f.direction == regress.DIR_LOWER
    assert verdict("p99_decrease").verdict == regress.VERDICT_IMPROVEMENT
    f = verdict("noisy_within_floor")
    assert f.threshold_pct > 10.0 and not f.regressed
    assert verdict("quiet_flagged").regressed
    f = verdict("aa_null_row_widens")
    assert f.threshold_pct == pytest.approx(12.0) and not f.regressed
    assert verdict("insufficient_history").verdict == \
        regress.VERDICT_NO_BASELINE


@pytest.mark.parametrize("name", [
    RPS, "optimizer.speedup", P99, "fleet.daemon.events",
    "fleet.store_rows", "fleet.swap.p99_ms", "train.val_f1",
    "bench.compile_s", "x.unknown"])
def test_default_policy_equals_the_references(name):
    assert dataclasses.asdict(regress.default_policy(name)) == \
        dataclasses.asdict(jregress.default_policy(name))


def test_policy_table_overrides_like_the_reference():
    raw = {"fleet.daemon.events": ("lower", 1.0), RPS: "higher",
           "x.y": regress.MetricPolicy(regress.DIR_INFO)}
    over = regress.policy_table(raw)
    jover = jregress.policy_table(
        {**raw, "x.y": jregress.MetricPolicy(jregress.DIR_INFO)})
    for name in raw:
        assert dataclasses.asdict(
            regress.default_policy(name, over)) == dataclasses.asdict(
            jregress.default_policy(name, jover))
    p = regress.default_policy("fleet.daemon.events", over)
    assert (p.direction, p.rel_threshold_pct) == (regress.DIR_LOWER, 1.0)


def test_noise_floors_and_baseline_equal_the_references():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 5, 37):
        xs = rng.normal(10.0, 1.0, size=n)
        assert regress.series_noise_pct(xs) == \
            jregress.series_noise_pct(xs)
        assert regress.noise_floor_pct(xs, 4.0) == \
            jregress.noise_floor_pct(xs, 4.0)
        if n:
            assert regress.ewma_baseline(xs, 0.3) == \
                jregress.ewma_baseline(xs, 0.3)
    assert regress.series_noise_pct([3200.0] * 6) == 0.0  # A/A


# ------------------------------------------------------- attribution

# the reference's counter -> the port's
MAPPED = {"jax.traces": "dispatch.signatures",
          "jax.dispatches": "dispatch.calls",
          "jax.compile_s": "dispatch.first_s"}

# counter moves between the two snapshots: (name, labels, before, after)
MOVES = {
    "recompile": [("jax.traces", {"site": "engine/0"}, 4, 9),
                  ("jax.compile_s", {"site": "engine/0"}, 2.0, 4.5)],
    "recompile_cheap": [("jax.traces", {"site": "engine/0"}, 4, 5),
                        ("jax.compile_s", {"site": "engine/0"}, 2.0,
                         2.005)],
    "quarantine": [("fleet.quarantined",
                    {"kind": "nonfinite", "site": "fleet.scorer/1"}, 0, 3)],
    "ladder": [("ingest.ladder", {"step": "shed", "daemon": "d/0"}, 1, 4),
               ("ingest.ladder", {"step": "block", "daemon": "d/0"}, 0, 2)],
    "duplicates": [("ingest.duplicates_dropped", {"daemon": "d/0"}, 5, 9)],
    "dispatches": [("jax.dispatches", {"site": "engine/0"}, 10, 16)],
    "site_renumbered": [("jax.traces", {"site": "engine/0"}, 4, 0),
                        ("jax.traces", {"site": "engine/7"}, 0, 4)],
    "everything": [("jax.traces", {"site": "fleet.scorer/2"}, 1, 2),
                   ("jax.compile_s", {"site": "fleet.scorer/2"}, 0.1, 0.6),
                   ("fleet.quarantined", {"kind": "unknown_type"}, 0, 1),
                   ("ingest.ladder", {"step": "degrade"}, 0, 1),
                   ("ingest.duplicates_dropped", {}, 0, 2),
                   ("jax.dispatches", {"site": "fleet.scorer/2"}, 3, 5)],
    "nothing_moved": [("jax.traces", {"site": "engine/0"}, 4, 4),
                      ("jax.dispatches", {"site": "engine/0"}, 9, 7)],
}


def _delta(m, moves, names):
    """``snapshot_delta`` between two snapshots of a fresh registry of
    module ``m`` that saw ``moves``, counter names mapped by ``names``."""
    reg = m.MetricsRegistry()
    counters = [(reg.counter(names.get(n, n), **labels), b, a)
                for n, labels, b, a in moves]
    for c, b, _ in counters:
        c.add(b)
    before = reg.snapshot()
    for c, b, a in counters:
        c.add(a - b)
    return reg.snapshot_delta(before, reg.snapshot())


@pytest.mark.parametrize("case", list(MOVES))
def test_attribution_equals_the_references(case):
    got = regress.attribute_delta(_delta(metrics, MOVES[case], MAPPED))
    want = jregress.attribute_delta(_delta(jmetrics, MOVES[case], {}))
    unmapped = tuple(label.replace("dispatch.signatures", "jax.traces")
                     for label in got)
    assert unmapped == want
    assert [x.split(":")[0] for x in got] == \
        [x.split(":")[0] for x in want]  # the same classes, in order
    if case == "recompile":
        assert got == ("recompile regression: dispatch.signatures +5 "
                       "(+2.50s compile wall)",)


def test_attribution_reads_a_dispatch_site():
    """A new input signature through a real ``DispatchSite`` is what the
    rules call a recompile; more calls at known signatures are a
    dispatch-count change."""
    reg = metrics.MetricsRegistry()
    site = DispatchSite("t.site", registry=reg)
    with site.dispatch((1, 512)):
        pass
    before = reg.snapshot()
    with site.dispatch((1, 512)):
        pass
    calls_only = regress.attribute_delta(
        reg.snapshot_delta(before, reg.snapshot()))
    assert calls_only == ("behavior change: dispatches +1",)
    mid = reg.snapshot()
    with site.dispatch((2, 512)):
        pass
    labels = regress.attribute_delta(reg.snapshot_delta(mid, reg.snapshot()))
    assert labels[0].startswith(
        "recompile regression: dispatch.signatures +1")
    assert labels[1] == "behavior change: dispatches +1"


def test_regress_imports_first_in_a_fresh_process():
    """``from repro_torch.obs import regress`` before anything else: the
    reference's raises ImportError there (a circular import through
    ``repro.fleet.modelplane``); the port's model plane imports the
    module, not its function, so the port's does not."""
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    res = subprocess.run(
        [sys.executable, "-c", "from repro_torch.obs import regress; "
         "print(regress.series_noise_pct([1.0, 2.0, 4.0]))"],
        env={"PYTHONPATH": str(src), "PATH": ""}, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_attribute_snapshots_uses_the_process_registry():
    reg = metrics.registry()
    c = reg.counter("dispatch.signatures", site="regress-test/0")
    before = reg.snapshot()
    c.inc(2)
    labels = regress.attribute_snapshots(before, reg.snapshot())
    assert labels == ("recompile regression: dispatch.signatures +2",)
