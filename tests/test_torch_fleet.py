"""The port's fleet tier (``fleet/shard.py``, ``fleet/service.py``, the
watchdog's ``service=`` path) against the JAX package's, and the
reference's exactness claims proved again inside the port, on the CPU."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.common.rng import folded_generator as jfolded  # noqa: E402
from repro.fleet import FleetScoringService as JService  # noqa: E402
from repro.fleet.faults import corrupt_frame as jcorrupt  # noqa: E402
from repro.fleet.shard import ShardedScorer as JScorer  # noqa: E402
from repro.runtime.watchdog import PeronaWatchdog as JWatchdog  # noqa: E402
from repro_torch.common import mesh  # noqa: E402
from repro_torch.common.rng import folded_generator  # noqa: E402
from repro_torch.core.params import flat_params  # noqa: E402
from repro_torch.fingerprint.runner import SuiteRunner  # noqa: E402
from repro_torch.fleet import (FleetScoringService,  # noqa: E402
                               corrupt_frame, drift_report)
from repro_torch.fleet.shard import ShardedScorer  # noqa: E402
from repro_torch.runtime.watchdog import PeronaWatchdog  # noqa: E402
from repro_torch.serving.engine import (ARG_NAMES,  # noqa: E402
                                        FingerprintEngine,
                                        prepare_features)

from _torch_fleet_pair import DAY, fleet_pair, int_stats  # noqa: E402

# the reference's service-vs-engine limits (tests/test_fleet.py:194-197)
PROB_ATOL, CODE_ATOL = 2e-5, 2e-4
# the reference's exactness claims held at its own bound
EXACT_ATOL = 1e-6


@pytest.fixture(scope="module")
def pair():
    return fleet_pair()


def _service(side, **kw):
    """A service of one package with the history seeded."""
    if hasattr(side.model, "init"):  # the JAX model
        svc = JService(side.model, side.params, side.pre, sharded=False,
                       **kw)
    else:
        svc = FleetScoringService(side.model, side.params, side.pre,
                                  device=kw.pop("device", "cpu"), **kw)
    svc.seed_history(side.frame)
    return svc


def _assert_results_close(got, want):
    assert sorted(got) == sorted(want)
    for node in want:
        a, b = want[node], got[node]
        np.testing.assert_allclose(b.anomaly_prob, a.anomaly_prob,
                                   atol=PROB_ATOL, err_msg=node)
        np.testing.assert_allclose(b.codes, a.codes, atol=CODE_ATOL)
        np.testing.assert_allclose(b.type_logits, a.type_logits,
                                   atol=CODE_ATOL)
        np.testing.assert_array_equal(b.row_ids, a.row_ids)
        np.testing.assert_array_equal(b.context_row_ids,
                                      a.context_row_ids)
        assert b.bucket == a.bucket


def _assert_results_equal(got, want):
    assert sorted(got) == sorted(want)
    for node in want:
        for key in ("anomaly_prob", "codes", "type_logits", "row_ids",
                    "context_row_ids"):
            np.testing.assert_array_equal(getattr(got[node], key),
                                          getattr(want[node], key))


# --------------------------------------------------- the port vs JAX
@pytest.fixture(scope="module")
def flushes(pair):
    """Both services through the same rounds: two closed-loop rounds,
    then a burst of two rounds in one flush, with context 6 and 16."""
    out = {}
    for ctx in (6, 16):
        per_side = {}
        for name in ("jax", "torch"):
            side = getattr(pair, name)
            runner = (SuiteRunner if name == "torch" else
                      type(side.runner))(seed=21)
            svc = _service(side, context_per_chain=ctx)
            results = [svc.score_round(runner.run_frame(
                pair.machines, runs_per_type=2, t_offset=(k + 1) * DAY))
                for k in range(2)]
            for k in (2, 3):
                svc.submit(runner.run_frame(pair.machines, runs_per_type=1,
                                            t_offset=(k + 1) * DAY))
            results.append(svc.flush())
            per_side[name] = (svc, results)
        out[ctx] = per_side
    return out


@pytest.mark.parametrize("ctx", [6, 16])
def test_service_flushes_match_jax(flushes, ctx):
    (_, jres), (_, tres) = flushes[ctx]["jax"], flushes[ctx]["torch"]
    assert len(jres) == len(tres) == 3
    for want, got in zip(jres, tres):
        _assert_results_close(got, want)


@pytest.mark.parametrize("ctx", [6, 16])
def test_service_stats_and_store_match_jax(flushes, ctx):
    (jsvc, _), (tsvc, _) = flushes[ctx]["jax"], flushes[ctx]["torch"]
    assert int_stats(tsvc.stats) == int_stats(jsvc.stats)
    assert sorted(tsvc.stats) == sorted(jsvc.stats)
    js, ts = jsvc.store, tsvc.store
    np.testing.assert_array_equal(ts.row_id, js.row_id)
    for col in ("t", "metrics", "metrics_present", "machine_code",
                "type_code", "stressed"):
        np.testing.assert_array_equal(getattr(ts.frame, col),
                                      getattr(js.frame, col))
    for key in js.features:
        np.testing.assert_array_equal(ts.features[key], js.features[key])
    np.testing.assert_array_equal(np.isnan(ts.anomaly), np.isnan(js.anomaly))
    np.testing.assert_allclose(ts.anomaly, js.anomaly, atol=PROB_ATOL)
    np.testing.assert_allclose(ts.codes, js.codes, atol=CODE_ATOL)


@pytest.mark.parametrize("n_requests", [1, 3, 5])
def test_scorer_flat_graph_matches_jax_vmap(pair, n_requests):
    """A stacked batch with padded requests (zero rows) and padded rows
    (nbr -1): the port's flat graph against the reference's vmap."""
    svc = _service(pair.torch, context_per_chain=4)
    new = SuiteRunner(seed=22).run_frame(pair.machines, runs_per_type=1,
                                         t_offset=DAY)
    first = svc.store.append(new, features=prepare_features(pair.torch.pre,
                                                            new))
    requests = svc._assemble_requests(first)
    inputs = [r["inputs"] for r in requests]
    inputs = (inputs * 2)[:n_requests]
    jscorer = JScorer(pair.jax.model, pair.jax.pre,
                      devices=jax.devices()[:1])
    r_pad = jscorer.pad_requests(len(inputs))
    assert svc.scorer.pad_requests(len(inputs)) == r_pad
    stack = mesh.stack_padded(inputs, r_pad)
    want = jscorer.score_stack(pair.jax.params,
                               {k: v.copy() for k, v in stack.items()})
    got = svc.scorer.score_stack(pair.torch.params, stack)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == want[key].shape
        tol = PROB_ATOL if key == "anomaly_prob" else CODE_ATOL
        np.testing.assert_allclose(got[key], want[key], atol=tol,
                                   err_msg=key)


def test_flat_graph_offsets_predecessors_per_request(pair):
    scorer = ShardedScorer(pair.torch.model, pair.torch.pre, devices=["cpu"])
    nbr = np.array([[[-1, -1, -1], [0, -1, -1], [1, 0, -1], [-1, -1, -1]],
                    [[-1, -1, -1], [0, -1, -1], [-1, -1, -1], [2, -1, -1]],
                    [[0, 0, 0]] * 4], np.int32)
    stack = {k: np.zeros((3, 4) + ((3,) if k in ("nbr", "nbr_mask") else ()),
                         np.int32) for k in ARG_NAMES}
    stack["nbr"] = nbr
    args = scorer.to_device(stack, 0, 3, torch.device("cpu"))
    flat = args[ARG_NAMES.index("nbr")].numpy()
    want = np.where(nbr >= 0, nbr + 4 * np.arange(3)[:, None, None], -1)
    np.testing.assert_array_equal(flat, want.reshape(12, 3))
    # a shard of the request axis counts its requests from 0
    args = scorer.to_device(stack, 1, 3, torch.device("cpu"))
    np.testing.assert_array_equal(args[ARG_NAMES.index("nbr")].numpy(),
                                  (want[1:] - 4).clip(-1).reshape(8, 3))


def test_mesh_host_half_matches_jax():
    from repro.common import mesh as jmesh

    for n in range(0, 70):
        for d in (1, 2, 4, 8):
            for floor in (1, 4):
                assert mesh.shard_size(n, d, floor) == \
                    jmesh.shard_size(n, d, floor)
    rng = np.random.default_rng(0)
    a = rng.random((3, 5)).astype(np.float32)
    np.testing.assert_array_equal(mesh.pad_lanes(a, 8),
                                  jmesh.pad_lanes(a, 8))
    inputs = [{"x": rng.random((4, 2)), "m": rng.random(4) < 0.5}
              for _ in range(3)]
    got, want = mesh.stack_padded(inputs, 4), jmesh.stack_padded(inputs, 4)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


@pytest.fixture(scope="module")
def watchdogs(pair):
    """Watchdogs over a service (both packages) and the port's engine
    path, on the same history and rounds, two of them degraded."""
    out = {}
    for name in ("jax", "torch"):
        side = getattr(pair, name)
        runner = (SuiteRunner if name == "torch" else
                  type(side.runner))(seed=99)
        if name == "jax":
            svc = JService(side.model, side.params, side.pre,
                           context_per_chain=6, sharded=False)
            wd = JWatchdog(side.model, side.params, side.pre, service=svc)
        else:
            svc = FleetScoringService(side.model, side.params, side.pre,
                                      context_per_chain=6, device="cpu")
            wd = PeronaWatchdog(side.model, side.params, side.pre,
                                service=svc, device="cpu")
        wd.history = side.frame
        rounds = [runner.run_frame(pair.machines, runs_per_type=1,
                                   degraded_machines=["in-1"],
                                   t_offset=(k + 1) * DAY)
                  for k in range(3)]
        out[name] = (wd, [wd.observe(r) for r in rounds], rounds)
    twd = PeronaWatchdog(pair.torch.model, pair.torch.params,
                         pair.torch.pre, history_per_chain=6, device="cpu")
    twd.history = pair.torch.frame
    out["engine"] = (twd, [twd.observe(r) for r in out["torch"][2]], None)
    return out


@pytest.mark.parametrize("other", ["jax", "engine"])
def test_watchdog_service_path_decides_as(pair, watchdogs, other):
    wd, decisions, _ = watchdogs["torch"]
    _, want, _ = watchdogs[other]
    assert wd.store is wd.service.store
    assert wd.history_per_chain == wd.service.context_per_chain == 6
    assert len(decisions) == len(want) == 3
    for got_round, want_round in zip(decisions, want):
        assert [d.node for d in got_round] == sorted(pair.machines)
        for a, b in zip(want_round, got_round):
            assert (a.node, a.flagged, a.confirmed, a.flag_fraction) == \
                (b.node, b.flagged, b.confirmed, b.flag_fraction)
            assert b.anomaly_prob == pytest.approx(a.anomaly_prob,
                                                   abs=PROB_ATOL)
            assert b.anomaly_ewma == pytest.approx(a.anomaly_ewma,
                                                   abs=PROB_ATOL)


def test_watchdog_service_path_store_and_drift_match_jax(watchdogs):
    jwd, twd = watchdogs["jax"][0], watchdogs["torch"][0]
    assert len(twd.store) == len(jwd.store)  # a shared store: no compact
    np.testing.assert_array_equal(twd.store.row_id, jwd.store.row_id)
    np.testing.assert_allclose(twd.store.anomaly, jwd.store.anomaly,
                               atol=PROB_ATOL)
    jr, tr = jwd.drift_report(), twd.drift_report()
    assert sorted(jr) == sorted(tr)
    for node in jr:
        assert jr[node].n_scored == tr[node].n_scored
        assert tr[node].anomaly_ewma == pytest.approx(
            jr[node].anomaly_ewma, abs=PROB_ATOL)
    assert sorted(twd.excluded_nodes()) == sorted(jwd.excluded_nodes())
    assert twd.service.stats["requests_served"] == 3 * 3


def test_watchdog_service_path_refuses_to_wipe_a_shared_store(pair):
    svc = _service(pair.torch)
    wd = PeronaWatchdog(pair.torch.model, pair.torch.params,
                        pair.torch.pre, service=svc, device="cpu")
    with pytest.raises(ValueError, match="already holds history"):
        wd.history = pair.torch.frame
    empty = pair.torch.frame.select(np.arange(0))
    fresh = PeronaWatchdog(pair.torch.model, pair.torch.params,
                           pair.torch.pre, device="cpu",
                           service=FleetScoringService(
                               pair.torch.model, pair.torch.params,
                               pair.torch.pre, device="cpu"))
    assert fresh.observe(empty) == []
    assert fresh.history == []


# ------------------------------------ exactness claims inside the port
def test_service_matches_per_request_engine(pair):
    engine = FingerprintEngine(pair.torch.model, pair.torch.params,
                               pair.torch.pre, device="cpu")
    svc = _service(pair.torch, context_per_chain=6)
    results = svc.score_round(SuiteRunner(seed=31).run_frame(
        pair.machines, runs_per_type=2))
    assert sorted(results) == sorted(pair.machines)
    store = svc.store
    for node, r in results.items():
        assert len(r.anomaly_prob) == 12  # 6 types x 2 runs
        assert len(r.context_row_ids) == 36  # 6 chains x 6 context
        ids = np.concatenate([r.context_row_ids, r.row_ids])
        rows = np.nonzero(np.isin(store.row_id, ids))[0]
        rows = rows[np.lexsort((rows, store.frame.t[rows]))]
        ref = engine.score(store.frame.select(rows))
        is_new = np.isin(store.row_id[rows], r.row_ids)
        np.testing.assert_allclose(r.anomaly_prob, ref.anomaly_prob[is_new],
                                   atol=PROB_ATOL)
        np.testing.assert_allclose(r.codes, ref.codes[is_new],
                                   atol=CODE_ATOL)
        rows = np.nonzero(np.isin(store.row_id, r.row_ids))[0]
        assert not np.isnan(store.anomaly[rows]).any()


def test_minimal_context_matches_full_history(pair):
    engine = FingerprintEngine(pair.torch.model, pair.torch.params,
                               pair.torch.pre, device="cpu")
    svc = _service(pair.torch)
    assert svc.context_per_chain == 6  # P=3 x tag_hops=2
    results = svc.score_round(SuiteRunner(seed=32).run_frame(
        pair.machines, runs_per_type=2, t_offset=DAY))
    store = svc.store
    first = min(r.row_ids.min() for r in results.values())
    for node, r in results.items():
        rows = store.view(node)
        ref = engine.score(store.frame.select(rows))
        is_new = store.row_id[rows] >= first
        np.testing.assert_allclose(r.anomaly_prob, ref.anomaly_prob[is_new],
                                   rtol=0, atol=EXACT_ATOL)


def test_burst_flush_matches_round_by_round(pair):
    rounds = [SuiteRunner(seed=33).run_frame(
        pair.machines, runs_per_type=1, t_offset=(k + 1) * DAY)
        for k in range(3)]
    seq = _service(pair.torch)
    seq_probs = {n: [] for n in pair.machines}
    for rnd in rounds:
        for n, r in seq.score_round(rnd).items():
            seq_probs[n].append(r.anomaly_prob)
    burst = _service(pair.torch)
    for rnd in rounds:
        burst.submit(rnd)
    merged = burst.flush()
    assert burst.stats["flushes"] == 1
    for n in pair.machines:
        np.testing.assert_allclose(merged[n].anomaly_prob,
                                   np.concatenate(seq_probs[n]),
                                   rtol=0, atol=EXACT_ATOL)


def test_rescore_reproduces_the_flush_bit_for_bit(pair):
    svc = _service(pair.torch)
    first = svc.store.next_id
    flushed = svc.score_round(SuiteRunner(seed=34).run_frame(
        pair.machines, runs_per_type=2, t_offset=DAY))
    stored = svc.store.anomaly.copy()
    shadow = svc.rescore(first)
    _assert_results_equal(shadow, flushed)
    assert svc.stats["shadow_dispatches"] == 1
    np.testing.assert_array_equal(svc.store.anomaly, stored)
    again = svc.rescore(first, attach=True)
    _assert_results_equal(again, flushed)
    np.testing.assert_array_equal(svc.store.anomaly, stored)
    assert svc.rescore(svc.store.next_id) == {}


@pytest.mark.parametrize("n_devices", [2, 4])
def test_split_request_axis_matches_one_shard_bit_for_bit(pair, n_devices):
    nodes = {f"s{i}": "e2-medium" for i in range(6)}
    history = SuiteRunner(seed=2).run_frame(nodes, runs_per_type=6,
                                            stress_fraction=0.2)
    new = SuiteRunner(seed=3).run_frame(nodes, runs_per_type=1,
                                        t_offset=DAY)
    out = {}
    for devices in (["cpu"], ["cpu"] * n_devices):
        svc = FleetScoringService(pair.torch.model, pair.torch.params,
                                  pair.torch.pre, context_per_chain=4,
                                  devices=devices)
        svc.seed_history(history)
        out[len(devices)] = (svc, svc.score_round(new))
    assert out[n_devices][0].stats["devices"] == n_devices
    _assert_results_equal(out[n_devices][1], out[1][1])


def test_retried_dispatch_matches_a_clean_run(pair):
    rnd = SuiteRunner(seed=35).run_frame(pair.machines, runs_per_type=1,
                                         t_offset=DAY)
    clean = _service(pair.torch)
    want = clean.score_round(rnd)
    svc = _service(pair.torch)
    svc.retry_backoff_s = 0.0
    real, calls = svc.scorer.score_stack, []

    def flaky(params, stack):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("transient device loss")
        return real(params, stack)

    svc.scorer.score_stack = flaky
    _assert_results_equal(svc.score_round(rnd), want)
    assert svc.stats["scorer_retries"] == 1 and len(calls) == 2
    np.testing.assert_array_equal(svc.store.anomaly, clean.store.anomaly)


def test_terminal_dispatch_failure_raises_after_the_retries(pair):
    svc = _service(pair.torch, dispatch_retries=2)
    svc.retry_backoff_s = 0.0

    def dead(params, stack):
        raise RuntimeError("device gone")

    svc.scorer.score_stack = dead
    with pytest.raises(RuntimeError, match="device gone"):
        svc.score_round(SuiteRunner(seed=36).run_frame(
            pair.machines, runs_per_type=1, t_offset=DAY))
    assert svc.stats["scorer_retries"] == 2


def test_quarantine_matches_jax(pair):
    out = {}
    for name, corrupt, folded in (("jax", jcorrupt, jfolded),
                                  ("torch", corrupt_frame, folded_generator)):
        side = getattr(pair, name)
        runner = (SuiteRunner if name == "torch" else
                  type(side.runner))(seed=37)
        svc = _service(side)
        rnd = runner.run_frame(pair.machines, runs_per_type=2, t_offset=DAY)
        bad, n_bad = corrupt(rnd, folded(0), n_cols=2, row_fraction=0.3)
        results = svc.score_round(bad)
        alien = dataclasses.replace(
            rnd, benchmark_types=("bogus",) + rnd.benchmark_types[1:])
        svc.submit(alien)
        out[name] = (svc, results, n_bad, len(rnd),
                     int((alien.type_code == 0).sum()))
    jsvc, jres, n_bad, n_rnd, n_alien = out["jax"]
    tsvc, tres, t_bad, *_ = out["torch"]
    assert t_bad == n_bad > 0
    _assert_results_close(tres, jres)
    assert int_stats(tsvc.stats) == int_stats(jsvc.stats)
    st = tsvc.stats
    assert st["quarantined_nonfinite"] == n_bad
    assert st["quarantined_unknown_type"] == n_alien
    assert sum(len(r.anomaly_prob) for r in tres.values()) == n_rnd - n_bad
    f = tsvc.store.frame
    assert np.isfinite(np.where(f.metrics_present, f.metrics, 0.0)).all()
    assert sum(len(q) for q in tsvc.quarantine) == n_bad + n_alien
    strict = FleetScoringService(pair.torch.model, pair.torch.params,
                                 pair.torch.pre, device="cpu",
                                 on_invalid="raise")
    with pytest.raises(ValueError, match="NaN/Inf"):
        strict.submit(bad)
    with pytest.raises(ValueError, match="unknown"):
        FleetScoringService(pair.torch.model, pair.torch.params,
                            pair.torch.pre, device="cpu",
                            on_invalid="bad-mode")


def test_one_signature_per_stacked_shape_and_warm_swap(pair):
    svc = _service(pair.torch, context_per_chain=6)
    runner = SuiteRunner(seed=38)
    svc.score_round(runner.run_frame(pair.machines, runs_per_type=2))
    assert svc.trace_count == 1 and svc.stats["dispatches"] == 1
    for _ in range(3):
        svc.score_round(runner.run_frame(pair.machines, runs_per_type=2))
    assert svc.trace_count == 1
    assert svc.stats["requests_served"] == 4 * len(pair.machines)
    assert svc.scorer.site.dispatches == 4
    candidate = {k: v.clone()
                 for k, v in flat_params(pair.torch.params).items()}
    assert svc.warm(candidate) == 1
    old = svc.swap_params(candidate)
    assert old is pair.torch.params and svc.params is candidate
    st = svc.stats
    assert (st["warm_dispatches"], st["param_swaps"], st["traces"]) == \
        (1, 1, 1)


def test_drift_report_over_the_service_store(pair):
    svc = _service(pair.torch, context_per_chain=6)
    runner = SuiteRunner(seed=39)
    for _ in range(3):
        svc.score_round(runner.run_frame(pair.machines, runs_per_type=1))
    report = drift_report(svc.store)
    assert sorted(report) == sorted(pair.machines)
    for d in report.values():
        assert d.n_scored == 18  # 3 rounds x 6 types
        assert 0.0 <= d.anomaly_ewma <= 1.0
