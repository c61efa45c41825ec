"""The port's batched BO replay (``repro_torch.optimizer``) on the CPU:
the eighteen cases of ``tests/test_optimizer.py`` inside the port (the
GP pinned against the scipy reference, per-seed trace parity with the
port's CherryPick/Arrow, Perona-weighting equivalence, degraded-fleet
scenarios, signature amortization, pipelined and seeded paths, and a
lane axis split over ``devices=["cpu"] * 2`` and ``* 4`` in place of
the reference's 8-device subprocess); and the port against the JAX
package: batched GP, EI and weighting factors on the same inputs, and
the picks of the 48-lane matrix equal to JAX's.

The JAX package's dataset and replay import
``jax.experimental.enable_x64``: the module fixture aliases it
(``tests/_jax_x64.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _jax_x64  # noqa: E402
from _trace_utils import expect_traces  # noqa: E402
from repro_torch.optimizer import (HEALTHY, REPLAY_TRACES,  # noqa: E402
                                   FleetCondition, ReplayConfig,
                                   build_scenarios, condition_from_drift,
                                   degrade_scores, lane_spec, lane_tables,
                                   reference_search, replay,
                                   replay_pipelined, replay_scenarios,
                                   replay_seeded, simulate_degraded_fleet,
                                   traces_from_result, traces_from_spec)
from repro_torch.tuning.scout import (VM_TYPES, WORKLOAD_NAMES,  # noqa: E402
                                      ScoutDataset)

# the batched GP against the scipy GP: tests/test_optimizer.py's limits
GP_MU_TOL = 1e-9
GP_SD_RTOL, GP_SD_ATOL = 1e-6, 1e-8
# the port's batched GP against JAX's on the same padded inputs
GP_JAX_RTOL = 1e-12
# the port's scout grids against JAX's (tests/test_torch_rng.py)
GRID_RTOL = 1e-13


@pytest.fixture(scope="module", autouse=True)
def x64_alias():
    with _jax_x64.alias(), _jax_x64.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def ds():
    return ScoutDataset(seed=0, device="cpu")


@pytest.fixture(scope="module")
def machine_scores():
    """Deterministic fingerprint-score stand-in (tests/test_optimizer.py)."""
    rng = np.random.default_rng(3)
    return {vm: {a: float(rng.uniform(0.5, 2.0))
                 for a in ("cpu", "memory", "disk", "network")}
            for vm in VM_TYPES}


@pytest.fixture(scope="module")
def degraded_condition():
    report, node_types = simulate_degraded_fleet(
        ("c4.large", "c4.xlarge"), degraded={"c4.large": ("cpu",),
                                             "c4.xlarge": ("cpu",)},
        seed=1)
    return condition_from_drift("c4-cpu", report, node_types)


def _padded(rng, m, P=16, D=4):
    X = rng.normal(size=(m, D))
    y = rng.normal(size=m) * 3.0 + 1.0
    Xp = np.zeros((P, D))
    Xp[:m] = X
    yp = np.zeros(P)
    yp[:m] = y
    return X, y, Xp, yp, np.arange(P) < m


# ------------------------------------------------------------ GP parity
def test_batched_gp_matches_scipy_reference():
    """Masked padded batched fit/predict == dense scipy fit/predict."""
    from repro_torch.optimizer.gp import gp_fit, gp_predict
    from repro_torch.tuning.gp import GP

    rng = np.random.default_rng(0)
    for m in (1, 2, 3, 5, 9):
        X, y, Xp, yp, mask = _padded(rng, m)
        Xs = rng.normal(size=(12, 4))
        ref = GP(noise=1e-3).fit(X, y)
        mu_ref, sd_ref = ref.predict(Xs)
        state = gp_fit(torch.as_tensor(Xp)[None], torch.as_tensor(yp)[None],
                       torch.as_tensor(mask)[None], noise=1e-3)
        mu, sd = gp_predict(state, torch.as_tensor(Xs)[None])
        np.testing.assert_allclose(mu[0].numpy(), mu_ref, rtol=GP_MU_TOL,
                                   atol=GP_MU_TOL)
        np.testing.assert_allclose(sd[0].numpy(), sd_ref, rtol=GP_SD_RTOL,
                                   atol=GP_SD_ATOL)
        # length scales equal the reference's median heuristic
        np.testing.assert_array_equal(state.scales[0].numpy(), ref.scales)


def test_batched_ei_matches_numpy():
    from repro_torch.optimizer.acquire import expected_improvement as ei_t
    from repro_torch.tuning.gp import expected_improvement as ei_np

    rng = np.random.default_rng(1)
    mu = rng.normal(size=50)
    sigma = np.abs(rng.normal(size=50)) + 1e-3
    got = ei_t(torch.as_tensor(mu), torch.as_tensor(sigma), 0.3).numpy()
    ref = ei_np(mu, sigma, 0.3)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)
    assert np.all(ref >= 0) and np.all(got >= 0)


# --------------------------------------------------------- trace parity
def _assert_trace_equal(seq, bat, scenario):
    label = (scenario.workload, scenario.seed, scenario.variant,
             scenario.condition.name)
    assert [c.key for c in seq.evaluated] == \
        [c.key for c in bat.evaluated], label
    assert seq.best_valid_cost == bat.best_valid_cost, label
    assert seq.costs == bat.costs, label
    assert seq.runtimes == bat.runtimes, label
    assert seq.search_cost == bat.search_cost, label


def test_replay_matches_sequential_traces(ds, machine_scores,
                                          degraded_condition):
    """Every lane reproduces its sequential numpy search exactly across
    variants, seeds and conditions."""
    scens = build_scenarios(
        ds, workloads=WORKLOAD_NAMES[:3], seeds=(0, 1),
        conditions=(HEALTHY, degraded_condition))
    traces = replay_scenarios(ds, scens, machine_scores)
    assert len(traces) == len(scens) == 3 * 2 * 4 * 2
    for sc, bt in zip(scens, traces):
        _assert_trace_equal(reference_search(ds, sc, machine_scores),
                            bt, sc)


def test_perona_lanes_reproduce_weighter_rankings(ds, machine_scores):
    """The tensor weighting reproduces the sequential
    ``PeronaAcquisitionWeighter`` on the same inputs."""
    from repro_torch.core.ranking import machine_score_matrix
    from repro_torch.optimizer.acquire import perona_weight_factors
    from repro_torch.tuning.perona_weights import (
        PeronaAcquisitionWeighter, normalized_machine_scores)
    from repro_torch.tuning.scout import PRICES

    weighter = PeronaAcquisitionWeighter(ds, machine_scores)
    wl = WORKLOAD_NAMES[0]
    evaluated = [ds.configs[i] for i in (3, 17, 40)]
    rng = np.random.default_rng(0)
    acq = np.abs(rng.normal(size=len(ds.configs)))
    ref = weighter(ds.configs, acq, workload=wl, evaluated=evaluated,
                   any_valid=True)
    norm = normalized_machine_scores(machine_scores)
    ns = np.stack([norm[c.vm_type] for c in ds.configs])
    prices = np.asarray([PRICES[c.vm_type] for c in ds.configs])
    util = np.mean([ds.low_level_metrics(wl, c) for c in evaluated],
                   axis=0)
    factors = perona_weight_factors(
        torch.as_tensor(util)[None], torch.as_tensor(ns)[None],
        torch.as_tensor(prices)[None], torch.tensor([True]))[0].numpy()
    got = acq * factors
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    np.testing.assert_array_equal(np.argsort(got), np.argsort(ref))
    mats = machine_score_matrix(machine_scores, list(machine_scores))
    assert mats.shape == (len(machine_scores), 4)
    for vm in machine_scores:
        np.testing.assert_array_equal(weighter.norm_scores[vm], norm[vm])


def test_degraded_condition_changes_search(ds, machine_scores,
                                           degraded_condition):
    """The reference's case and its claims, but one: that the degraded
    fleet changes at least one of the six weighted searches. Under
    JAX's current partitionable threefry layout no trace changes in
    either package (one did under the old layout, ROADMAP §3), so the
    port's traces under both fleets are held to the JAX package's
    instead, and the weighting inputs of the degraded types must move."""
    import repro.optimizer as jopt
    from repro.tuning.scout import ScoutDataset as JaxScout

    degraded = degrade_scores(machine_scores, degraded_condition)
    assert degraded["c4.large"]["cpu"] < machine_scores["c4.large"]["cpu"]
    assert degraded["c4.large"]["memory"] == \
        machine_scores["c4.large"]["memory"]
    kw = dict(workloads=WORKLOAD_NAMES[:6], seeds=(0,),
              variants=("cherrypick+perona",))
    healthy = build_scenarios(ds, conditions=(HEALTHY,), **kw)
    sick = build_scenarios(ds, conditions=(degraded_condition,), **kw)
    t_h = replay_scenarios(ds, healthy, machine_scores)
    t_s = replay_scenarios(ds, sick, machine_scores)
    c4 = [j for j, c in enumerate(ds.configs) if c.vm_type == "c4.large"]
    assert not np.array_equal(
        lane_tables(ds, healthy, machine_scores).norm_scores[:, c4],
        lane_tables(ds, sick, machine_scores).norm_scores[:, c4])
    jds = JaxScout(seed=0)
    jcond = jopt.FleetCondition("c4-cpu", degraded_condition.score_drop)
    for cond, got in ((jopt.HEALTHY, t_h), (jcond, t_s)):
        want = jopt.replay_scenarios(
            jds, jopt.build_scenarios(jds, conditions=(cond,), **kw),
            machine_scores)
        for a, b in zip(want, got):  # each on its own dataset's draws
            assert [c.key for c in a.evaluated] == \
                [c.key for c in b.evaluated]
            np.testing.assert_allclose(b.best_valid_cost, a.best_valid_cost,
                                       rtol=GRID_RTOL)


def test_distinct_conditions_sharing_a_name(ds, machine_scores):
    a = FleetCondition("degraded", {"c4.large": {"cpu": 0.5}})
    b = FleetCondition("degraded", {"r4.large": {"disk": 0.5}})
    scens = build_scenarios(ds, workloads=WORKLOAD_NAMES[:1], seeds=(0,),
                            variants=("cherrypick+perona",),
                            conditions=(a, b))
    tab = lane_tables(ds, scens, machine_scores, ReplayConfig())
    assert not np.array_equal(tab.norm_scores[0], tab.norm_scores[1])


def test_replay_signature_amortized(ds, machine_scores):
    """Same lane/slot shapes -> one signature (the reference's one
    tracing)."""
    cfg = ReplayConfig()
    scens = build_scenarios(ds, workloads=WORKLOAD_NAMES[:2],
                            seeds=(0, 1), conditions=(HEALTHY,))
    tab = lane_tables(ds, scens, machine_scores, cfg)
    replay(tab, cfg, device="cpu")
    with expect_traces(REPLAY_TRACES, 0):
        r1 = replay(tab, cfg, device="cpu")
        r2 = replay(tab, cfg, device="cpu")
    np.testing.assert_array_equal(r1.chosen, r2.chosen)
    assert r1.dispatches == 1


def _assert_same_traces(ref_traces, got_traces):
    assert len(ref_traces) == len(got_traces)
    for a, b in zip(ref_traces, got_traces):
        assert [c.key for c in a.evaluated] == [c.key for c in b.evaluated]
        assert a.best_valid_cost == b.best_valid_cost


def test_pipelined_matches_unpipelined(ds, machine_scores):
    """Blocked replay equals the one-dispatch path lane for lane, in
    both dispatch modes (round-robin placement and split blocks)."""
    scens = build_scenarios(ds, workloads=WORKLOAD_NAMES[:2],
                            seeds=(0, 1), conditions=(HEALTHY,))
    ref = replay_scenarios(ds, scens, machine_scores)
    got, stats = replay_pipelined(ds, scens, machine_scores,
                                  block_lanes=8, return_stats=True)
    _assert_same_traces(ref, got)
    assert stats["block_lanes"] == 8
    assert stats["blocks"] == stats["dispatches"] == 2
    assert stats["table_s"] > 0.0
    split = replay_pipelined(ds, scens, machine_scores, block_lanes=8,
                             devices=["cpu"] * 2, shard_blocks=True)
    _assert_same_traces(ref, split)
    robin, stats = replay_pipelined(ds, scens, machine_scores,
                                    block_lanes=8, devices=["cpu"] * 2,
                                    return_stats=True)
    _assert_same_traces(ref, robin)
    assert stats["devices"] == 2


def test_deferred_condition_resolves_lazily(ds, machine_scores):
    from repro_torch.optimizer import (DeferredFleetCondition,
                                       resolve_condition)

    calls = []
    eager = FleetCondition("deg", {"c4.large": {"cpu": 0.4}})

    def factory():
        calls.append(1)
        return eager

    lazy = DeferredFleetCondition("deg", factory)
    kwargs = dict(workloads=WORKLOAD_NAMES[:1], seeds=(0,),
                  variants=("cherrypick+perona",))
    lazy_scens = build_scenarios(ds, conditions=(lazy,),
                                 condition_major=True, **kwargs)
    assert calls == [] and not lazy.resolved
    cfg = ReplayConfig()
    tab_lazy = lane_tables(ds, lazy_scens, machine_scores, cfg)
    assert calls == [1] and lazy.resolved
    lane_tables(ds, lazy_scens, machine_scores, cfg)
    assert calls == [1]  # cached
    eager_scens = build_scenarios(ds, conditions=(eager,), **kwargs)
    tab_eager = lane_tables(ds, eager_scens, machine_scores, cfg)
    np.testing.assert_array_equal(tab_lazy.norm_scores,
                                  tab_eager.norm_scores)
    assert resolve_condition(lazy).score_drop == eager.score_drop
    assert resolve_condition(eager) is eager


def test_condition_major_order_same_traces(ds, machine_scores):
    conds = (HEALTHY, FleetCondition("deg", {"r4.large": {"disk": 0.5}}))
    kwargs = dict(workloads=WORKLOAD_NAMES[:2], seeds=(0, 1),
                  conditions=conds)
    a = build_scenarios(ds, **kwargs)
    b = build_scenarios(ds, condition_major=True, **kwargs)
    assert sorted(map(repr, a)) == sorted(map(repr, b)) and a != b
    ta = {repr(s): t for s, t in
          zip(a, replay_scenarios(ds, a, machine_scores))}
    tb = {repr(s): t for s, t in
          zip(b, replay_scenarios(ds, b, machine_scores))}
    for k in ta:
        assert [c.key for c in ta[k].evaluated] == \
            [c.key for c in tb[k].evaluated]
        assert ta[k].best_valid_cost == tb[k].best_valid_cost


def test_pipelined_empty_and_partial_block(ds, machine_scores):
    assert replay_pipelined(ds, [], machine_scores) == []
    scens = build_scenarios(ds, workloads=WORKLOAD_NAMES[:1], seeds=(0,),
                            variants=("cherrypick",),
                            conditions=(HEALTHY,))
    ref = replay_scenarios(ds, scens, machine_scores)
    got = replay_pipelined(ds, scens, machine_scores, block_lanes=8)
    _assert_same_traces(ref, got)


def test_signature_amortized_across_lane_counts(ds, machine_scores,
                                                degraded_condition):
    """100-, 200- and 432-lane matrices: the unpipelined path adds one
    signature per pow2 lane bucket (128/256/512), the pipelined path
    ONE fixed-block signature for all three sizes."""
    cfg = ReplayConfig()
    scens = build_scenarios(ds, seeds=(0, 1, 2),
                            conditions=(HEALTHY, degraded_condition))
    assert len(scens) == 432
    sizes = (100, 200, 432)
    tabs = {n: lane_tables(ds, scens[:n], machine_scores, cfg)
            for n in sizes}
    results = {}
    for n in sizes:
        before = REPLAY_TRACES.count
        results[n] = replay(tabs[n], cfg, device="cpu")
        assert REPLAY_TRACES.count - before <= 1
    with expect_traces(REPLAY_TRACES, 0):
        for n in sizes:
            again = replay(tabs[n], cfg, device="cpu")
            np.testing.assert_array_equal(again.chosen, results[n].chosen)
    replay_pipelined(ds, scens[:100], machine_scores, cfg, block_lanes=64)
    with expect_traces(REPLAY_TRACES, 0):
        for n in (200, 432):
            got = replay_pipelined(ds, scens[:n], machine_scores, cfg,
                                   block_lanes=64)
            _assert_same_traces(
                traces_from_result(tabs[n], results[n], ds.configs), got)


# ----------------------------------------------------- seeded replay
def test_seeded_replay_bit_identical_to_host_tables(
        ds, machine_scores, degraded_condition):
    cfg = ReplayConfig()
    scens = build_scenarios(ds, workloads=WORKLOAD_NAMES[:3], seeds=(0, 1),
                            conditions=(HEALTHY, degraded_condition))
    tab = lane_tables(ds, scens, machine_scores, cfg)
    host = replay(tab, cfg, device="cpu")
    spec = lane_spec(ds, scens, machine_scores, cfg)
    seeded = replay_seeded(spec, cfg, device="cpu")
    np.testing.assert_array_equal(host.chosen, seeded.chosen)
    np.testing.assert_array_equal(host.count, seeded.count)
    for a, b in zip(traces_from_result(tab, host, ds.configs),
                    traces_from_spec(spec, seeded, ds.configs)):
        assert [c.key for c in a.evaluated] == [c.key for c in b.evaluated]
        assert a.costs == b.costs and a.runtimes == b.runtimes
        assert a.best_valid_cost == b.best_valid_cost
        assert a.search_cost == b.search_cost


def test_seeded_scenarios_end_to_end(ds, machine_scores):
    scens = build_scenarios(ds, workloads=WORKLOAD_NAMES[:2], seeds=(0,),
                            conditions=(HEALTHY,))
    ref = replay_scenarios(ds, scens, machine_scores)
    got = replay_scenarios(ds, scens, machine_scores, seeded=True)
    _assert_same_traces(ref, got)
    for sc, bt in zip(scens, got):
        _assert_trace_equal(reference_search(ds, sc, machine_scores), bt,
                            sc)


def test_seeded_pipelined_matches_unpipelined(ds, machine_scores):
    scens = build_scenarios(ds, workloads=WORKLOAD_NAMES[:2],
                            seeds=(0, 1), conditions=(HEALTHY,))
    ref = replay_scenarios(ds, scens, machine_scores)
    got, stats = replay_pipelined(ds, scens, machine_scores, block_lanes=8,
                                  seeded=True, return_stats=True)
    _assert_same_traces(ref, got)
    assert stats["blocks"] == stats["dispatches"] == 2


def test_seeded_replay_signature_amortized(ds, machine_scores):
    cfg = ReplayConfig()
    scens = build_scenarios(ds, workloads=WORKLOAD_NAMES[:2],
                            seeds=(0, 1), conditions=(HEALTHY,))
    spec = lane_spec(ds, scens, machine_scores, cfg)
    replay_seeded(spec, cfg, device="cpu")
    with expect_traces(REPLAY_TRACES, 0):
        r1 = replay_seeded(spec, cfg, device="cpu")
        r2 = replay_seeded(spec, cfg, device="cpu")
    np.testing.assert_array_equal(r1.chosen, r2.chosen)
    assert r1.dispatches == 1


# ---------------------------------------------------- split lane axis
@pytest.mark.parametrize("n_devices", [2, 4])
def test_split_replay_bit_identical(ds, machine_scores, n_devices):
    """The lane axis split over ``n_devices`` reproduces the one-device
    replay bit for bit on the 432-lane matrix, host-table and seeded,
    and the pipelined split paths match lane for lane."""
    cfg = ReplayConfig()
    cond = FleetCondition("deg", {"c4.large": {"cpu": 0.3},
                                  "m4.xlarge": {"memory": 0.4}})
    scens = build_scenarios(ds, seeds=(0, 1, 2),
                            conditions=(HEALTHY, cond))
    assert len(scens) == 432
    devices = ["cpu"] * n_devices
    tab = lane_tables(ds, scens, machine_scores, cfg)
    single = replay(tab, cfg, device="cpu")
    split = replay(tab, cfg, devices=devices)
    np.testing.assert_array_equal(single.chosen, split.chosen)
    np.testing.assert_array_equal(single.count, split.count)
    spec = lane_spec(ds, scens, machine_scores, cfg)
    seeded = replay_seeded(spec, cfg, devices=devices)
    np.testing.assert_array_equal(single.chosen, seeded.chosen)
    np.testing.assert_array_equal(single.count, seeded.count)
    ref = traces_from_result(tab, single, ds.configs)
    for seeded_blocks in (False, True):
        piped = replay_pipelined(ds, scens, machine_scores, cfg,
                                 block_lanes=64, seeded=seeded_blocks,
                                 devices=devices)
        _assert_same_traces(ref, piped)


def test_traces_from_result_fields(ds, machine_scores):
    cfg = ReplayConfig()
    scens = build_scenarios(ds, workloads=WORKLOAD_NAMES[:1], seeds=(0,),
                            conditions=(HEALTHY,))
    tab = lane_tables(ds, scens, machine_scores, cfg)
    result = replay(tab, cfg, device="cpu")
    traces = traces_from_result(tab, result, ds.configs)
    for sc, tr in zip(scens, traces):
        assert len(tr.evaluated) == len(tr.costs) == len(tr.runtimes) \
            == len(tr.best_valid_cost)
        assert cfg.n_init <= len(tr.evaluated) <= cfg.max_runs
        assert tr.search_cost == float(np.sum(tr.costs))
        running = np.inf
        for cost, rt, best in zip(tr.costs, tr.runtimes,
                                  tr.best_valid_cost):
            if rt <= sc.limit:
                running = min(running, cost)
            assert best == running
        keys = [c.key for c in tr.evaluated]
        assert len(keys) == len(set(keys))


# ------------------------------------------------ the port against JAX
def test_batched_gp_matches_jax():
    """The batched GP on padded lanes against JAX's vmapped GP on the
    same inputs (summation orders differ: relative 1e-12)."""
    from repro.optimizer.gp import gp_fit as jfit
    from repro.optimizer.gp import gp_predict as jpredict
    from repro_torch.optimizer.gp import gp_fit, gp_predict

    rng = np.random.default_rng(2)
    lanes = [_padded(rng, m, D=10) for m in (1, 2, 3, 5, 8, 9, 9, 4)]
    Xp = np.stack([lane[2] for lane in lanes])
    yp = np.stack([lane[3] for lane in lanes])
    mask = np.stack([lane[4] for lane in lanes])
    Xs = rng.normal(size=(len(lanes), 69, 10))
    with jax.enable_x64(True):
        def one(x, y, m, xs):
            return jpredict(jfit(x, y, m, noise=1e-3, median_rows=9), xs)

        mu_j, sd_j = jax.jit(jax.vmap(one))(*map(jnp.asarray,
                                                 (Xp, yp, mask, Xs)))
        scales_j = jax.vmap(lambda x, y, m: jfit(
            x, y, m, median_rows=9).scales)(*map(jnp.asarray,
                                                 (Xp, yp, mask)))
    state = gp_fit(torch.as_tensor(Xp), torch.as_tensor(yp),
                   torch.as_tensor(mask), noise=1e-3, median_rows=9)
    mu, sd = gp_predict(state, torch.as_tensor(Xs))
    np.testing.assert_array_equal(state.scales.numpy(), np.asarray(scales_j))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j),
                               rtol=GP_JAX_RTOL, atol=GP_JAX_RTOL)
    np.testing.assert_allclose(sd.numpy(), np.asarray(sd_j),
                               rtol=GP_JAX_RTOL, atol=GP_JAX_RTOL)


def test_acquisition_matches_jax():
    from repro.optimizer.acquire import expected_improvement as jei
    from repro.optimizer.acquire import perona_weight_factors as jpw
    from repro_torch.optimizer.acquire import (expected_improvement,
                                               perona_weight_factors)

    rng = np.random.default_rng(4)
    mu, sigma = rng.normal(size=(2, 8, 69))
    sigma = np.abs(sigma) + 1e-4
    best = rng.normal(size=8)
    util = np.abs(rng.normal(size=(8, 4)))
    ns = np.abs(rng.normal(size=(8, 69, 4))) + 0.1
    prices = np.abs(rng.normal(size=(8, 69))) + 0.1
    valid = rng.random(8) < 0.5
    with jax.enable_x64(True):
        ei_j = jax.vmap(lambda m, s, b: jei(m, s, b))(
            *map(jnp.asarray, (mu, sigma, best)))
        pw_j = jax.vmap(jpw)(*map(jnp.asarray, (util, ns, prices, valid)))
    ei = expected_improvement(torch.as_tensor(mu), torch.as_tensor(sigma),
                              torch.as_tensor(best)[:, None])
    pw = perona_weight_factors(*map(torch.as_tensor,
                                    (util, ns, prices, valid)))
    # tests/test_optimizer.py's limits for EI (its far tail is the
    # cancellation of two terms)
    np.testing.assert_allclose(ei.numpy(), np.asarray(ei_j), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(pw.numpy(), np.asarray(pw_j), rtol=1e-13)


def test_replay_picks_equal_jax(ds, machine_scores):
    """The 48-lane matrix (3 workloads x 2 seeds x 4 variants x healthy
    and a degraded fleet) through both packages' replays, each on its
    own dataset: the same picks and counts in every lane, host-table
    and seeded."""
    import repro.optimizer as jopt
    import repro_torch.optimizer as topt
    from repro.tuning.scout import ScoutDataset as JaxScout

    def matrix(opt, dset):
        report, node_types = opt.simulate_degraded_fleet(
            ("c4.large", "c4.xlarge"), degraded={"c4.large": ("cpu",),
                                                 "c4.xlarge": ("cpu",)},
            seed=1)
        cond = opt.condition_from_drift("c4-cpu", report, node_types)
        return opt.build_scenarios(dset, workloads=WORKLOAD_NAMES[:3],
                                   seeds=(0, 1),
                                   conditions=(opt.HEALTHY, cond))

    jds = JaxScout(seed=0)
    want = jopt.replay(jopt.lane_tables(jds, matrix(jopt, jds),
                                        machine_scores))
    scens = matrix(topt, ds)
    assert len(scens) == len(want.count) == 48
    for got in (replay(lane_tables(ds, scens, machine_scores),
                       device="cpu"),
                replay_seeded(lane_spec(ds, scens, machine_scores),
                              device="cpu")):
        np.testing.assert_array_equal(got.chosen, want.chosen)
        np.testing.assert_array_equal(got.count, want.count)
