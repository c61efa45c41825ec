"""The port's fault injector and ingestion daemon (``fleet/faults.py``,
``fleet/ingest.py``) against the JAX package's, and the reference's
daemon properties proved again inside the port, on the CPU."""

import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fleet import FaultPlan as JPlan  # noqa: E402
from repro.fleet import FleetScoringService as JService  # noqa: E402
from repro.fleet import IngestionDaemon as JDaemon  # noqa: E402
from repro.fleet import fleet_telemetry as jtelemetry  # noqa: E402
from repro.fleet import inject_faults as jinject  # noqa: E402
from repro_torch.fleet import (FaultPlan, FleetScoringService,  # noqa: E402
                               IngestionDaemon, drift_report,
                               fleet_telemetry, inject_faults,
                               load_staging)
from repro_torch.obs import CAT_LADDER  # noqa: E402

from _torch_fleet_pair import DAY, MACHINES, fleet_pair  # noqa: E402

PROB_ATOL, CODE_ATOL = 2e-5, 2e-4  # tests/test_fleet.py:194-197
# daemon stats that are wall-clock readings, not counts
WALL_KEYS = ("flush_wall_s", "run_wall_s")


@pytest.fixture(scope="module")
def pair():
    return fleet_pair()


def _service(side):
    if hasattr(side.model, "init"):  # the JAX model
        svc = JService(side.model, side.params, side.pre, sharded=False)
    else:
        svc = FleetScoringService(side.model, side.params, side.pre,
                                  device="cpu")
    svc.seed_history(side.frame)
    return svc


def _tservice(pair):
    return _service(pair.torch)


def _store_is_finite(store):
    f = store.frame
    return bool(
        np.isfinite(np.where(f.metrics_present, f.metrics, 0.0)).all()
        and np.isfinite(np.where(f.node_metrics_present,
                                 f.node_metrics, 0.0)).all()
        and np.isfinite(f.t).all())


def _assert_same_events(a, b):
    assert [e.uid for e in a] == [e.uid for e in b]
    assert [e.node for e in a] == [e.node for e in b]
    assert [e.arrival for e in a] == [e.arrival for e in b]
    for x, y in zip(a, b):
        for col in ("t", "metrics", "metrics_present", "node_metrics",
                    "machine_code", "type_code", "stressed"):
            np.testing.assert_array_equal(getattr(x.frame, col),
                                          getattr(y.frame, col))
        assert x.frame.machines == y.frame.machines
        assert x.frame.benchmark_types == y.frame.benchmark_types


# ----------------------------------------------------- faults vs JAX
PLANS = {
    "storm": dict(seed=3, dropout=0.1, delay=0.3, duplicate=0.3,
                  reorder=0.2, corrupt=0.3, burst=0.25, burst_window=2.0,
                  stalls=(("in-1", 1.0, 4.0),)),
    "every_kind": dict(seed=8, dropout=0.2, delay=0.4, duplicate=0.3,
                       reorder=0.3, corrupt=0.4, burst=0.3),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_telemetry_and_injected_faults_equal_jax_bit_for_bit(plan):
    kw = dict(rounds=4, runs_per_type=2, seed=11, interval=1.0,
              jitter=0.2, degraded={"in-2": 2})
    events, jevents = (fleet_telemetry(MACHINES, **kw),
                       jtelemetry(MACHINES, **kw))
    _assert_same_events(events, jevents)
    out, log = inject_faults(events, FaultPlan(**PLANS[plan]))
    jout, jlog = jinject(jevents, JPlan(**PLANS[plan]))
    _assert_same_events(out, jout)
    assert log.counts() == jlog.counts()
    assert log.corrupted == jlog.corrupted
    # deterministic: the same plan over the same stream again
    again, log2 = inject_faults(list(events), FaultPlan(**PLANS[plan]))
    _assert_same_events(again, out)
    assert log2.counts() == log.counts()


# ---------------------------------------------------- daemon vs JAX
SCENARIOS = {
    # stream faults, deadline and row-bucket flushes
    "faults": (dict(rounds=6, runs_per_type=2, seed=11, interval=1.0,
                    jitter=0.2),
               PLANS["storm"],
               dict(capacity_rows=256, flush_interval=0.5, flush_rows=64)),
    # a gated consumer under a storm: shed, then degraded scoring
    "shed_degrade": (dict(rounds=8, runs_per_type=2, seed=13,
                          interval=0.05, jitter=0.01),
                     None,
                     dict(capacity_rows=48, flush_interval=10.0,
                          flush_rows=1 << 30, min_flush_gap=5.0,
                          degrade_after=2, recover_after=1,
                          degrade_sample_per_chain=1)),
    # an always-free consumer: an overflowing arrival forces a flush
    "block": (dict(rounds=4, runs_per_type=2, seed=13, interval=0.05,
                   jitter=0.01),
              None,
              dict(capacity_rows=48, flush_interval=10.0,
                   flush_rows=1 << 30, min_flush_gap=0.0)),
}


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def daemons(request, pair):
    events_kw, plan, daemon_kw = SCENARIOS[request.param]
    out = {}
    for name, telemetry, inject, plan_cls, daemon_cls in (
            ("jax", jtelemetry, jinject, JPlan, JDaemon),
            ("torch", fleet_telemetry, inject_faults, FaultPlan,
             IngestionDaemon)):
        events = telemetry(MACHINES, **events_kw)
        log = None
        if plan is not None:
            events, log = inject(events, plan_cls(**plan))
        svc = _service(getattr(pair, name))
        daemon = daemon_cls(svc, service_time_scale=0.0, **daemon_kw)
        results = daemon.run(events)
        out[name] = (daemon, svc, results, events, log)
    return request.param, out


def test_daemon_ladder_and_counters_equal_jax(daemons):
    name, out = daemons
    jd, td = out["jax"][0], out["torch"][0]
    jst, tst = jd.stats(), td.stats()
    assert sorted(tst) == sorted(jst)
    for key in jst:
        if key in WALL_KEYS or key == "service":
            continue
        assert tst[key] == jst[key], key
    assert {k: v for k, v in tst["service"].items()
            if isinstance(v, int)} == \
        {k: v for k, v in jst["service"].items() if isinstance(v, int)}
    assert td.flagged_nodes() == jd.flagged_nodes()
    assert td.flagged_nodes(ewma_threshold=0.0) == \
        jd.flagged_nodes(ewma_threshold=0.0)
    # the ladder's instants and the flush spans, on the virtual clock
    keep = lambda e: (e.name, e.cat, e.ts, e.dur, e.ph, e.args)  # noqa
    assert [keep(e) for e in td.tracer.events()] == \
        [keep(e) for e in jd.tracer.events()]
    if name == "shed_degrade":
        assert tst["shed_rows"] > 0 and tst["degraded_flushes"] > 0
    if name == "block":
        assert tst["forced_flushes"] > 0 and tst["shed_rows"] == 0


def test_daemon_scores_and_drift_match_jax(daemons):
    _, out = daemons
    (jd, _, jres, *_), (td, _, tres, *_) = out["jax"], out["torch"]
    assert sorted(tres) == sorted(jres)
    for node in jres:
        assert len(tres[node]) == len(jres[node])
        for got, want in zip(tres[node], jres[node]):
            np.testing.assert_array_equal(got.row_ids, want.row_ids)
            np.testing.assert_allclose(got.anomaly_prob, want.anomaly_prob,
                                       atol=PROB_ATOL)
            np.testing.assert_allclose(got.codes, want.codes,
                                       atol=CODE_ATOL)
    jr, tr = jd.drift.report(), td.drift.report()
    assert sorted(tr) == sorted(jr)
    for node in jr:
        assert tr[node].n_scored == jr[node].n_scored
        assert tr[node].anomaly_ewma == pytest.approx(jr[node].anomaly_ewma,
                                                      abs=PROB_ATOL)


def test_daemon_accounting_is_exact(pair, daemons):
    """Every duplicated uid dropped once, every corrupted row quarantined
    (none reaches the store), every row conserved: store rows = history
    + deduped stream - corrupted - shed."""
    _, out = daemons
    daemon, svc, _, events, log = out["torch"]
    st = daemon.stats()
    assert st["peak_staged_rows"] <= daemon.capacity_rows
    assert _store_is_finite(svc.store)
    corrupted = 0 if log is None else log.corrupted_rows
    if log is not None:
        assert log.duplicated and log.corrupted and log.dropped
        assert st["duplicates_dropped"] == len(log.duplicated)
    assert svc.stats["quarantined_nonfinite"] == corrupted
    assert sum(len(f) for f in svc.quarantine) == corrupted
    deduped_rows = sum(len(e.frame) for e in {e.uid: e for e in events}
                       .values())
    assert len(svc.store) == (len(pair.torch.frame) + deduped_rows
                              - corrupted - st["shed_rows"])


# ------------------------------------- the reference's claims, in port
def test_no_fault_daemon_equals_the_closed_loop_bit_for_bit(pair):
    """One deadline flush per telemetry round reproduces the closed-loop
    ``score_round`` scores bit for bit, and the daemon's incremental
    drift equals the batch ``drift_report`` exactly."""
    from repro_torch.fingerprint.runner import SuiteRunner

    rounds = 3
    ref = _tservice(pair)
    src = SuiteRunner(seed=7)
    ref_results = {}
    for k in range(rounds):
        rnd = src.run_frame(MACHINES, runs_per_type=1,
                            t_offset=(k + 1) * DAY)
        for n, r in ref.score_round(rnd).items():
            ref_results.setdefault(n, []).append(r)
    svc = _tservice(pair)
    daemon = IngestionDaemon(svc, capacity_rows=512, flush_interval=0.5,
                             flush_rows=1 << 30, service_time_scale=0.0)
    res = daemon.run(fleet_telemetry(MACHINES, rounds=rounds,
                                     runs_per_type=1, seed=7, interval=1.0,
                                     jitter=0.01))
    st = daemon.stats()
    assert (st["deadline_flushes"], st["drain_flushes"]) == (rounds - 1, 1)
    assert sorted(res) == sorted(MACHINES)
    for n in MACHINES:
        assert len(res[n]) == rounds
        for got, want in zip(res[n], ref_results[n]):
            for key in ("anomaly_prob", "codes", "type_logits"):
                np.testing.assert_array_equal(getattr(got, key),
                                              getattr(want, key))
    rolling = daemon.drift.report()
    batch = drift_report(svc.store, alpha=daemon.drift.alpha)
    assert sorted(rolling) == sorted(batch)
    for n in batch:
        for key in ("n_scored", "anomaly_ewma", "anomaly_mean",
                    "aspect_ewma", "aspect_mean", "last_t"):
            assert getattr(rolling[n], key) == getattr(batch[n], key), key


def test_shed_keeps_newest_rows_per_chain(pair):
    events = fleet_telemetry(MACHINES, rounds=6, runs_per_type=2, seed=17,
                             interval=0.05)
    daemon = IngestionDaemon(_tservice(pair), capacity_rows=40,
                             flush_interval=1e9, flush_rows=1 << 30,
                             min_flush_gap=1e9, service_time_scale=0.0)
    daemon.run(events, drain=False)
    st = daemon.stats()
    assert st["shed_rows"] > 0 and st["staged_rows"] <= 40
    staged_t = np.concatenate([s.frame.t for s in daemon._staged])
    newest_round_t0 = 6 * DAY
    n_newest = sum(len(e.frame) for e in events
                   if e.frame.t.min() >= newest_round_t0)
    assert (staged_t >= newest_round_t0).sum() == n_newest


def test_degraded_mode_scores_newest_sample_per_chain(pair):
    svc = _tservice(pair)
    daemon = IngestionDaemon(svc, capacity_rows=512, flush_interval=1e9,
                             flush_rows=1 << 30, degrade_sample_per_chain=1,
                             service_time_scale=0.0)
    daemon.degraded = True  # force ladder step 3
    for ev in fleet_telemetry(MACHINES, rounds=1, runs_per_type=3,
                              seed=23):
        daemon.offer(ev, now=ev.arrival)
    res = daemon.flush()
    n_types = len(pair.torch.frame.benchmark_types)
    n_chains = len(MACHINES) * n_types
    assert daemon.stats()["degraded_flushes"] == 1
    assert svc.stats["rows_scored"] == n_chains
    assert daemon.stats()["degrade_unscored_rows"] == n_chains * 2
    assert all(len(r.anomaly_prob) == n_types for r in res.values())


def test_row_trigger_and_deadline_flushes(pair):
    events = fleet_telemetry(MACHINES, rounds=4, runs_per_type=2, seed=29,
                             interval=1.0)
    per_round = sum(len(e.frame) for e in events) // 4
    daemon = IngestionDaemon(_tservice(pair), capacity_rows=1024,
                             flush_interval=1e9, flush_rows=per_round,
                             service_time_scale=0.0)
    daemon.run(events)
    st = daemon.stats()
    assert (st["row_trigger_flushes"], st["deadline_flushes"]) == (4, 0)
    assert IngestionDaemon(_tservice(pair), capacity_rows=100).flush_rows \
        == 64  # a pow2 <= capacity by default

    events = fleet_telemetry(MACHINES, rounds=3, runs_per_type=1, seed=31,
                             interval=10.0)
    daemon = IngestionDaemon(_tservice(pair), capacity_rows=1024,
                             flush_interval=2.0, flush_rows=1 << 30,
                             service_time_scale=0.0)
    daemon.run(events, drain=False)
    daemon.advance(events[-1].arrival + 2.0 + 1e-6)
    st = daemon.stats()
    assert (st["deadline_flushes"], st["staged_rows"]) == (3, 0)
    lat = daemon._latency.summary()
    assert lat["count"] > 0 and lat["max"] <= 2.0 + 1e-9


def test_checkpoint_restore_resumes_identically(pair, tmp_path):
    events = fleet_telemetry(MACHINES, rounds=2, runs_per_type=1, seed=37,
                             interval=1.0, jitter=0.05)
    kw = dict(capacity_rows=512, flush_interval=1e9, flush_rows=1 << 30,
              service_time_scale=0.0)
    res_a = IngestionDaemon(_tservice(pair), **kw).run(events)
    d_b = IngestionDaemon(_tservice(pair), **kw)
    d_b.run(events, drain=False)  # a crash with rows staged
    path = os.path.join(tmp_path, "staging.npz")
    d_b.close(drain=False, checkpoint=path)
    assert d_b.stats()["staged_rows"] == 0
    restored = load_staging(path)
    assert sorted(e.uid for e in restored) == sorted(e.uid for e in events)
    res_c = IngestionDaemon(_tservice(pair), **kw).run(restored)
    assert sorted(res_a) == sorted(res_c)
    for n in res_a:
        for ra, rc in zip(res_a[n], res_c[n]):
            np.testing.assert_array_equal(ra.anomaly_prob, rc.anomaly_prob)
            np.testing.assert_array_equal(ra.codes, rc.codes)


def test_close_drains_staged_rows(pair):
    events = fleet_telemetry(MACHINES, rounds=1, runs_per_type=1, seed=41)
    svc = _tservice(pair)
    daemon = IngestionDaemon(svc, capacity_rows=512, flush_interval=1e9,
                             flush_rows=1 << 30)
    for ev in events:
        daemon.offer(ev, now=ev.arrival)
    res = daemon.close(drain=True)
    assert sorted(res) == sorted(MACHINES)
    assert svc.stats["store_rows"] == len(pair.torch.frame) + sum(
        len(e.frame) for e in events)
    assert daemon.close() == {}  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        daemon.offer(events[0], now=0.0)


def test_transient_scorer_failure_retried_bit_identical(pair):
    events = fleet_telemetry(MACHINES, rounds=3, runs_per_type=1, seed=61,
                             interval=1.0, jitter=0.01)
    kw = dict(capacity_rows=512, flush_interval=0.5, flush_rows=1 << 30,
              service_time_scale=0.0)
    ref = _tservice(pair)
    ref_res = IngestionDaemon(ref, **kw).run(events)
    svc = _tservice(pair)
    svc.retry_backoff_s = 0.0
    real, calls = svc.scorer.score_stack, []

    def flaky(params, stack):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("transient device loss")
        return real(params, stack)

    svc.scorer.score_stack = flaky
    daemon = IngestionDaemon(svc, **kw)
    res = daemon.run(events)
    st = daemon.stats()
    assert (svc.stats["scorer_retries"], st["scorer_retries"],
            st["flush_failures"]) == (1, 1, 0)
    assert sorted(res) == sorted(ref_res)
    for n in ref_res:
        for got, want in zip(res[n], ref_res[n]):
            np.testing.assert_array_equal(got.anomaly_prob,
                                          want.anomaly_prob)
            np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(svc.store.anomaly, ref.store.anomaly)


def test_terminal_scorer_failure_degrades_not_dies(pair):
    svc = _tservice(pair)
    svc.dispatch_retries = 1
    svc.retry_backoff_s = 0.0

    def dead(params, stack):
        raise RuntimeError("device gone")

    svc.scorer.score_stack = dead
    events = fleet_telemetry(MACHINES, rounds=2, runs_per_type=1, seed=62,
                             interval=1.0, jitter=0.01)
    daemon = IngestionDaemon(svc, capacity_rows=512, flush_interval=0.5,
                             flush_rows=1 << 30, service_time_scale=0.0)
    assert daemon.run(events) == {}  # must not raise
    st = daemon.stats()
    assert st["flush_failures"] >= 1
    assert svc.stats["scorer_retries"] == st["flush_failures"]
    n_hist = len(pair.torch.frame)
    assert len(svc.store) == n_hist + sum(len(e.frame) for e in events)
    assert np.isnan(svc.store.anomaly[n_hist:]).all()
    assert "ingest.flush_failed" in [e.name for e in daemon.tracer.events()]
    assert not daemon.degraded  # failure != backpressure degradation


def test_threaded_serve(pair):
    """Wall-clock mode: a poll source drains into the daemon thread,
    rounds get scored, close() joins the thread."""
    events = fleet_telemetry(MACHINES, rounds=2, runs_per_type=1, seed=43,
                             interval=0.05)
    pending = list(events)
    lock = threading.Lock()

    def poll(now):
        with lock:
            due = [e for e in pending if e.arrival <= now]
            for e in due:
                pending.remove(e)
            return due

    daemon = IngestionDaemon(_tservice(pair), capacity_rows=512,
                             flush_interval=0.2, flush_rows=1 << 30,
                             service_time_scale=0.0)
    daemon.attach_source(poll)
    daemon.serve(poll_interval=0.02)
    with pytest.raises(RuntimeError, match="already running"):
        daemon.serve()
    deadline = time.time() + 30.0
    while time.time() < deadline:
        with lock:
            empty = not pending
        if empty and daemon.stats()["staged_rows"] == 0 \
                and daemon.results():
            break
        time.sleep(0.05)
    daemon.close(drain=True)
    assert daemon._thread is None
    res = daemon.results()
    assert sorted(res) == sorted(MACHINES)
    total = sum(len(r.anomaly_prob) for rs in res.values() for r in rs)
    assert total == sum(len(e.frame) for e in events)


def test_push_intake_and_ladder_instants(pair):
    events = fleet_telemetry(MACHINES, rounds=8, runs_per_type=2, seed=13,
                             interval=0.05, jitter=0.01)
    daemon = IngestionDaemon(_tservice(pair), capacity_rows=48,
                             flush_interval=10.0, flush_rows=1 << 30,
                             min_flush_gap=5.0, degrade_after=2,
                             recover_after=1, service_time_scale=0.0)
    for ev in events:
        daemon.push(ev.frame, now=ev.arrival, node=ev.node)
    assert not daemon.push(events[0].frame, node="x", uid=-1)  # a dup
    st = daemon.stats()
    assert st["events_seen"] == len(events) + 1
    assert st["duplicates_dropped"] == 1
    names = {e.name for e in daemon.tracer.events()
             if e.cat == CAT_LADDER}
    assert {"ladder.shed", "ladder.degrade"} <= names
