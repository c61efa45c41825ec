"""The port's telemetry plane (``obs/metrics.py``, ``obs/trace.py``,
``obs/dispatch.py``) against the JAX package's on the same operations,
and the port's dispatch accounting on the engine and the fleet scorer."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs.trace import Tracer as JTracer  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.fingerprint.runner import SuiteRunner  # noqa: E402
from repro_torch.fleet import FleetScoringService  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.obs.dispatch import DispatchSite, instance_site  # noqa
from repro_torch.obs.trace import (CAT_DEVICE, CAT_HOST,  # noqa: E402
                                   CAT_LADDER, Tracer)
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
