"""The port's telemetry plane (``obs/metrics.py``, ``obs/trace.py``,
``obs/timeline.py``, ``obs/dispatch.py``) and straggler monitor
(``runtime/straggler.py``) against the JAX package's on the same
operations, and the port's dispatch accounting on the engine and the
fleet scorer."""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import timeline as jtimeline  # noqa: E402
from repro.obs.trace import SpanEvent as JSpanEvent  # noqa: E402
from repro.obs.trace import Tracer as JTracer  # noqa: E402
from repro.runtime.straggler import StragglerMonitor as JMonitor  # noqa
from repro_torch import obs  # noqa: E402
from repro_torch.fingerprint.runner import SuiteRunner  # noqa: E402
from repro_torch.fleet import FleetScoringService  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.obs.dispatch import DispatchSite, instance_site  # noqa
from repro_torch.obs.timeline import (chrome_trace,  # noqa: E402
                                      validate_chrome_trace,
                                      validate_chrome_trace_file,
                                      write_chrome_trace)
from repro_torch.obs.trace import (CAT_DEVICE, CAT_HOST,  # noqa: E402
                                   CAT_LADDER, CAT_PLANE, SpanEvent, Tracer)
from repro_torch.runtime import StragglerMonitor  # noqa: E402
from repro_torch.serving.engine import FingerprintEngine  # noqa: E402

from _torch_fleet_pair import fleet_pair  # noqa: E402


def _drive_registry(m, samples, exact_limit):
    """One sequence of operations on a registry module ``m``."""
    reg = m.MetricsRegistry()
    c = reg.counter("x.hits", site="a")
    c.inc()
    c.inc(3)
    reg.counter("x.hits", site="b").add(0.5)
    reg.gauge("x.depth").set(7.5)
    h = reg.histogram("lat", exact_limit=exact_limit, site="a")
    for x in samples[:len(samples) // 2]:
        h.observe(x)
    h.observe_many(list(samples[len(samples) // 2:]))
    before = reg.snapshot()
    reg.counter("x.hits", site="a").inc(2)
    return reg, h, before


@pytest.mark.parametrize("exact_limit", [4096, 64, 2])
def test_registry_equals_jax(exact_limit):
    rng = np.random.default_rng(0)
    samples = np.concatenate([rng.lognormal(0.0, 1.5, size=500),
                              [0.0, -1.0]])
    reg, h, before = _drive_registry(metrics, samples, exact_limit)
    jreg, jh, jbefore = _drive_registry(jmetrics, samples, exact_limit)
    assert reg.snapshot() == jreg.snapshot()
    assert reg.render() == jreg.render()
    assert reg.snapshot_delta(before, reg.snapshot()) == \
        jreg.snapshot_delta(jbefore, jreg.snapshot())
    assert h.exact == jh.exact == (exact_limit > len(samples))
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q)
    assert h.summary() == jh.summary()
    if h.exact:
        assert h.quantile(0.5) == float(np.quantile(samples, 0.5))
    with pytest.raises(TypeError):
        reg.gauge("x.hits", site="a")  # same key, another type
    assert metrics.parse_key("x.hits{site=a}") == \
        jmetrics.parse_key("x.hits{site=a}")


def test_counter_thread_safety():
    c = metrics.MetricsRegistry().counter("threads.incs")
    n_threads, per = 8, 2000

    def work():
        for _ in range(per):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert c.value == n_threads * per


def test_tracer_equals_jax_on_an_injected_clock():
    events = []
    for cls in (Tracer, JTracer):
        clock = {"t": 10.0}
        tr = cls(clock=lambda: clock["t"], max_events=4)
        with tr.span("work", cat=CAT_HOST, args={"k": 1}):
            clock["t"] = 12.5
        tr.instant("mark", CAT_LADDER, ts=11.0)
        tr.complete("flush", CAT_HOST, ts=10.5, dur=0.25)
        for i in range(3):
            tr.instant(f"e{i}")
        events.append(([(e.name, e.cat, e.ts, e.dur, e.ph, e.args)
                        for e in tr.events()], tr.dropped))
    assert events[0] == events[1]
    assert events[0][1] == 2  # the ring keeps the newest 4


def test_disabled_plane_records_nothing():
    reg = metrics.MetricsRegistry()
    c, h, tr = reg.counter("off.hits"), reg.histogram("off.lat"), Tracer()
    site = DispatchSite("off.site", registry=reg, tracer=tr)
    with obs.disabled():
        assert not obs.enabled()
        c.inc(5)
        h.observe(1.0)
        with tr.span("s"):
            pass
        tr.instant("i")
        with site.dispatch(("a",)):
            pass
    assert obs.enabled()
    assert c.value == 0 and h.count == 0 and tr.events() == []
    assert site.dispatches == 0 and site.count == 0
    # the signature was still seen: a later call is not a first call
    with site.dispatch(("a",)):
        pass
    assert (site.count, site.dispatches, site.first_seconds) == (0, 1, 0.0)


def test_dispatch_site_books_first_and_later_calls():
    reg, tr = metrics.MetricsRegistry(), Tracer()
    site = DispatchSite("t.site", registry=reg, tracer=tr)
    for sig in ((4, 64), (4, 64), (8, 64)):
        with site.dispatch(sig, "call", args={"sig": sig}):
            pass
    with pytest.raises(RuntimeError):
        with site.dispatch((16, 64)):
            raise RuntimeError("a failed call books nothing")
    assert site.count == site.trace_count == 2
    assert site.dispatches == 3
    assert site.first_seconds > 0.0 and site.run_seconds > 0.0
    evs = tr.events()
    assert [e.cat for e in evs] == [CAT_DEVICE] * 3
    assert [e.args["first"] for e in evs] == [True, False, True]
    assert evs[0].args["sig"] == (4, 64)
    assert site.stats() == {"traces": 2, "dispatches": 3,
                            "first_s": site.first_seconds,
                            "run_s": site.run_seconds}
    snap = reg.snapshot()
    assert snap["dispatch.signatures{site=t.site}"] == 2
    assert snap["dispatch.calls{site=t.site}"] == 3
    # the failed signature is still new
    with site.dispatch((16, 64)):
        pass
    assert site.count == 3


def test_instance_site_labels_are_unique():
    a, b = instance_site("x.y"), instance_site("x.y")
    assert a != b and a.startswith("x.y/")


@pytest.fixture(scope="module")
def pair():
    return fleet_pair()


def test_engine_counts_one_signature_per_bucket_as_jax_traces(pair):
    from repro.fingerprint.runner import SuiteRunner as JRunner
    from repro.serving.engine import FingerprintEngine as JEngine

    sizes = (4, 4, 20)  # runs a type: buckets 64, 64, 128
    engine = FingerprintEngine(pair.torch.model, pair.torch.params,
                               pair.torch.pre, device="cpu")
    jengine = JEngine(pair.jax.model, pair.jax.params, pair.jax.pre)
    assert engine.trace_count == 0
    counts = []
    for n in sizes:
        engine.score(SuiteRunner(seed=3).run_frame({"m-0": "e2-medium"}, n))
        jengine.score(JRunner(seed=3).run_frame({"m-0": "e2-medium"}, n))
        counts.append((engine.trace_count, jengine.trace_count))
    assert counts == [(1, 1), (1, 1), (2, 2)]
    assert engine.site.dispatches == 3
    key = f"dispatch.signatures{{site={engine.site.site}}}"
    assert obs.registry().snapshot()[key] == 2


def test_service_reports_through_the_registry(pair):
    svc = FleetScoringService(pair.torch.model, pair.torch.params,
                              pair.torch.pre, device="cpu")
    svc.seed_history(pair.torch.frame)
    tracer = obs.tracer()
    tracer.clear()
    svc.score_round(SuiteRunner(seed=4).run_frame(pair.machines, 1))
    assert svc.stats["traces"] == svc.scorer.site.count == 1
    site = svc.scorer.site.site
    snap = obs.registry().snapshot()
    assert f"fleet.quarantined{{kind=nonfinite,site={site}}}" in snap
    assert snap[f"fleet.flushes{{site={site}}}"] == 1
    assert snap[f"fleet.flush_wall_s{{site={site}}}"]["count"] == 1
    names = [(e.name, e.cat) for e in tracer.events()]
    assert ("fleet.stack", CAT_HOST) in names
    assert ("fleet.score_stack", CAT_DEVICE) in names
    assert ("fleet.flush", CAT_HOST) in names


# ---------------------------------------------------------- timeline

def _recorded(cls):
    """One recording on an injected clock (tests/test_obs.py:171-186)."""
    clock = {"t": 0.0}
    tr = cls(clock=lambda: clock["t"])
    with tr.span("outer"):
        clock["t"] = 1.0
    tr.instant("ladder.block", CAT_LADDER, ts=0.5)
    with tr.span("later", cat=CAT_DEVICE, args={"rows": 3}):
        clock["t"] = 3.0
    tr.instant("modelplane.promote", CAT_PLANE, args={"version": 2},
               ts=2.0)
    return tr


def test_chrome_trace_export_equals_jax_and_is_valid(tmp_path):
    path = str(tmp_path / "t.json")
    obj = write_chrome_trace(path, tracer=_recorded(Tracer),
                             process_name="test-proc")
    want = jtimeline.chrome_trace(tracer=_recorded(JTracer),
                                  process_name="test-proc")
    # thread ids differ between recordings only if the threads do
    assert obj == want
    summary = validate_chrome_trace_file(path)
    assert summary == jtimeline.validate_chrome_trace(want)
    assert summary["spans"] == 2 and summary["threads"] == 1
    timed = [e for e in obj["traceEvents"] if e["ph"] != "M"]
    assert [e["ts"] for e in timed] == [0.0, 500_000.0, 1_000_000.0,
                                        2_000_000.0]
    xs = [e for e in timed if e["ph"] == "X"]
    assert xs[0]["dur"] == 1_000_000.0 and xs[1]["dur"] == 2_000_000.0
    with open(path) as f:
        assert json.load(f) == obj  # the artifact round-trips


def test_chrome_trace_interleaves_threads_like_jax():
    spans = [("a", CAT_HOST, 0.0, 1.0, 111, "main"),
             ("b", CAT_DEVICE, 0.5, 1.0, 222, "worker"),
             ("c", CAT_HOST, 2.0, 0.5, 111, "main")]
    obj = chrome_trace([SpanEvent(n, c, ts, d, tid=t, thread=th)
                        for n, c, ts, d, t, th in spans])
    want = jtimeline.chrome_trace([JSpanEvent(n, c, ts, d, tid=t,
                                              thread=th)
                                   for n, c, ts, d, t, th in spans])
    assert obj == want
    validate_chrome_trace(obj)
    by_name = {e["name"]: e["tid"] for e in obj["traceEvents"]
               if e["ph"] == "X"}
    assert by_name == {"a": 0, "b": 1, "c": 0}


BASE = [{"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
         "args": {"name": "p"}},
        {"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
         "args": {"name": "t"}}]
MALFORMED = {
    "unknown phase": [{"ph": "Z", "pid": 1, "tid": 0, "name": "x",
                       "ts": 0}],
    "goes backwards": [
        {"ph": "X", "pid": 1, "tid": 0, "name": "x", "ts": 5, "dur": 1},
        {"ph": "X", "pid": 1, "tid": 0, "name": "y", "ts": 4, "dur": 1}],
    "dur": [{"ph": "X", "pid": 1, "tid": 0, "name": "x", "ts": 0}],
    "no open B": [{"ph": "E", "pid": 1, "tid": 0, "name": "x", "ts": 0}],
    "unclosed B": [{"ph": "B", "pid": 1, "tid": 0, "name": "x", "ts": 0}],
    "does not match": [
        {"ph": "B", "pid": 1, "tid": 0, "name": "x", "ts": 0},
        {"ph": "E", "pid": 1, "tid": 0, "name": "y", "ts": 1}],
    "thread_name": [{"ph": "X", "pid": 1, "tid": 9, "name": "x", "ts": 0,
                     "dur": 0}],
}


@pytest.mark.parametrize("fault", list(MALFORMED))
def test_validator_rejects_what_jax_rejects(fault):
    obj = {"traceEvents": BASE + MALFORMED[fault]}
    with pytest.raises(ValueError) as got:
        validate_chrome_trace(obj)
    with pytest.raises(ValueError) as want:
        jtimeline.validate_chrome_trace(obj)
    assert fault in str(got.value)
    assert str(got.value) == str(want.value)


def test_validator_accepts_matched_begin_end():
    obj = {"traceEvents": BASE + [
        {"ph": "B", "pid": 1, "tid": 0, "name": "x", "ts": 0},
        {"ph": "E", "pid": 1, "tid": 0, "name": "x", "ts": 1}]}
    assert validate_chrome_trace(obj) == \
        jtimeline.validate_chrome_trace(obj)
    with pytest.raises(ValueError, match="traceEvents"):
        validate_chrome_trace({"nope": []})


# ---------------------------------------------------- straggler monitor

STEPS = {
    # tests/test_runtime.py:14-21: one persistently slow host
    "persistent": (dict(ratio_threshold=1.3, patience=3),
                   [{"h0": 100.0, "h1": 100.0, "h2": 100.0, "h3": 250.0}]
                   * 10),
    # tests/test_runtime.py:24-35: a single 4x blip decays in time
    "transient_blip": (dict(ratio_threshold=1.3, patience=6, alpha=0.3),
                       [{"a": 100.0, "b": 100.0,
                         "c": 400.0 if s == 5 else 100.0}
                        for s in range(14)]),
    "blip_short_patience": (dict(ratio_threshold=1.3, patience=3,
                                 alpha=0.3),
                            [{"a": 100.0, "b": 100.0,
                              "c": 400.0 if s == 5 else 100.0}
                             for s in range(14)]),
}


@pytest.mark.parametrize("case", list(STEPS))
def test_straggler_monitor_equals_jax(case):
    kw, steps = STEPS[case]
    mon, jmon = StragglerMonitor(**kw), JMonitor(**kw)
    for step, times in enumerate(steps):
        got = mon.record_step(step, times)
        want = jmon.record_step(step, times)
        assert [vars(e) for e in got] == [vars(e) for e in want]
    assert [vars(e) for e in mon.events] == [vars(e) for e in jmon.events]
    if case == "persistent":
        assert {e.host for e in mon.events} == {"h3"}
    elif case == "transient_blip":
        assert not mon.events


def test_daemon_timeline_is_valid_and_holds_its_spans(pair, tmp_path):
    """A daemon's own virtual-clock recording exports as a valid trace
    with one ``ingest.flush`` span a flush."""
    from repro_torch.fleet import IngestionDaemon, fleet_telemetry

    svc = FleetScoringService(pair.torch.model, pair.torch.params,
                              pair.torch.pre, device="cpu")
    svc.seed_history(pair.torch.frame)
    daemon = IngestionDaemon(svc, capacity_rows=512, flush_interval=0.5,
                             flush_rows=1 << 30, service_time_scale=0.0)
    daemon.run(fleet_telemetry(pair.machines, rounds=3, runs_per_type=1,
                               seed=7, interval=1.0, jitter=0.01))
    path = str(tmp_path / "daemon.json")
    obj = write_chrome_trace(path, tracer=daemon.tracer)
    validate_chrome_trace_file(path)
    flushes = [e for e in obj["traceEvents"] if e["name"] == "ingest.flush"]
    st = daemon.stats()
    assert len(flushes) == st["deadline_flushes"] + st["drain_flushes"] == 3
