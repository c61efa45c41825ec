"""§IV-D scenario matrix over the scout simulator (the port of
``repro/optimizer/scenarios.py``).

A *scenario* is one configuration search: (workload, seed, tuner
variant, fleet condition). The matrix spans the paper's evaluation grid
— 18 workloads x seeds x {cherrypick, arrow} x {vanilla,
perona-weighted} — extended with *fleet conditions*: degraded-node
fleets derived from ``fleet.drift`` analytics, so fingerprint-aware
search is exercised under exactly the degradation the paper motivates
(a degraded machine type's fingerprint scores drop, steering the
weighted acquisition away from it).

``lane_tables`` lowers a scenario list to the stacked arrays the replay
engine consumes; ``reference_search`` runs the identically-configured
sequential tuner (the parity baseline). Both paths must share one
``ScoutDataset`` instance: ``build_scenarios`` materializes the
simulator's runtime cache in canonical (workload, config) order while
computing runtime limits, which pins the contention-noise draws for
every later consumer.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.common.bucketing import next_pow2
from repro_torch.core.ranking import machine_score_matrix, \
    machine_score_vector
from repro_torch.obs import trace as obs_trace
from repro_torch.optimizer.replay import (LaneTables, ReplayConfig,
                                          SeededLaneSpec, replay,
                                          replay_async,
                                          replay_seeded_async,
                                          traces_from_result,
                                          traces_from_spec)
from repro_torch.tuning.scout import LOW_CAPS, PRICES, ScoutDataset

VARIANTS = ("cherrypick", "cherrypick+perona", "arrow", "arrow+perona")


@dataclasses.dataclass(frozen=True)
class FleetCondition:
    """A fleet health state: relative fingerprint-score drops per
    (machine type, resource aspect). The healthy fleet has none."""

    name: str
    score_drop: Mapping[str, Mapping[str, float]] = \
        dataclasses.field(default_factory=dict)


HEALTHY = FleetCondition("healthy")


class DeferredFleetCondition:
    """A fleet condition whose score drops are derived on first use —
    typically through the real store path (``simulate_degraded_fleet``
    -> ``fleet.drift`` EWMAs -> ``condition_from_drift``), which costs
    real host time. ``replay_pipelined`` exploits the laziness: with a
    condition-major scenario order (``build_scenarios(
    condition_major=True)``) each block's conditions are derived on the
    host while the previous block's scan runs on device."""

    def __init__(self, name: str, factory):
        self.name = name
        self._factory = factory
        self._resolved: Optional[FleetCondition] = None
        self._lock = threading.Lock()

    @property
    def resolved(self) -> bool:
        return self._resolved is not None

    def resolve(self) -> FleetCondition:
        # double-checked: concurrent resolvers (pipelined per-device
        # workers touching a shared condition) must not run the
        # factory twice — beyond the wasted store-path simulation, two
        # FleetCondition objects would split the replay engine's
        # id()-keyed condition caches
        if self._resolved is None:
            with self._lock:
                if self._resolved is None:
                    cond = self._factory()
                    self._resolved = FleetCondition(self.name,
                                                    cond.score_drop)
        return self._resolved


def resolve_condition(condition) -> FleetCondition:
    """An eager :class:`FleetCondition` as-is; a deferred one derived
    (cached on the deferred object)."""
    if isinstance(condition, DeferredFleetCondition):
        return condition.resolve()
    return condition


def degrade_scores(machine_scores: Dict[str, Dict[str, float]],
                   condition: FleetCondition
                   ) -> Dict[str, Dict[str, float]]:
    """Apply a condition's relative drops to a machine-score dict."""
    condition = resolve_condition(condition)
    out = {m: dict(per) for m, per in machine_scores.items()}
    for vm, aspects in condition.score_drop.items():
        if vm not in out:
            continue
        for aspect, drop in aspects.items():
            if aspect in out[vm]:
                out[vm][aspect] *= (1.0 - drop)
    return out


def condition_from_drift(name: str, report: Dict[str, "NodeDrift"],
                         node_types: Mapping[str, str],
                         rel_drop: float = 0.2) -> FleetCondition:
    """Build a condition from ``fleet.drift.drift_report`` output:
    every drop ``fleet.drift.degradation_factors`` reports for a node
    votes for its machine type; drops average per type."""
    from repro_torch.fleet.drift import degradation_factors

    acc: Dict[str, Dict[str, List[float]]] = {}
    for node, drops in degradation_factors(report, rel_drop).items():
        vm = node_types.get(node)
        if vm is None:
            continue
        for aspect, frac in drops.items():
            acc.setdefault(vm, {}).setdefault(aspect, []).append(frac)
    return FleetCondition(name, {
        vm: {a: float(np.mean(v)) for a, v in per.items()}
        for vm, per in acc.items()})


def simulate_degraded_fleet(machine_types: Sequence[str],
                            degraded: Mapping[str, Sequence[str]],
                            *, severity: float = 0.9, rounds: int = 10,
                            healthy_rounds: int = 3, seed: int = 0):
    """Run one simulated node per machine type through streaming
    benchmark rounds, attach synthetic quality scores that decay on the
    ``degraded`` types' aspects over the later rounds, and return the
    resulting ``fleet.drift`` report plus the node->type map.

    This exercises the real fleet path (store appends, chain views,
    EWMA analytics) without model training: attached codes are unit
    vectors scaled so ``core.ranking.code_scores`` equals the intended
    quality directly."""
    from repro_torch.core.ranking import ASPECT_OF_TYPE
    from repro_torch.fingerprint.runner import SuiteRunner
    from repro_torch.fleet.drift import drift_report
    from repro_torch.fleet.store import FingerprintStore

    day = 86400.0
    runner = SuiteRunner(seed=seed)
    machines = {f"{vm}-0": vm for vm in machine_types}
    store = FingerprintStore()
    for k in range(rounds):
        frame = runner.run_frame(machines, runs_per_type=1,
                                 t_offset=k * day)
        first = store.append(frame)
        n = len(frame)
        codes = np.zeros((n, 4), np.float32)
        anomaly = np.full(n, 0.05, np.float32)
        ramp = max(0.0, (k - healthy_rounds + 1)
                   / max(rounds - healthy_rounds, 1))
        for j in range(n):
            vm = frame.machine_types[frame.machine_type_code[j]]
            aspect = ASPECT_OF_TYPE[
                frame.benchmark_types[frame.type_code[j]]]
            quality = 1.0
            if aspect in degraded.get(vm, ()):
                quality = 1.0 - severity * ramp
                anomaly[j] = 0.05 + 0.9 * ramp
            codes[j, 0] = quality
        store.attach(np.arange(first, first + n), anomaly, codes)
    return drift_report(store), machines


def drifted_condition(machine_types: Sequence[str],
                      aspects: Sequence[str] = ("cpu",),
                      name: Optional[str] = None,
                      seed: int = 0, deferred: bool = False):
    """The canonical degraded-fleet condition used by the benchmark and
    the example: simulate the given machine types losing quality on the
    given aspects, run the fleet drift analytics, and turn the report
    into a condition.

    ``deferred=True`` returns a :class:`DeferredFleetCondition` that
    runs the store-path simulation on first use instead of now — the
    pipelined replay then overlaps that host work with device scans."""
    if name is None:
        name = f"{'/'.join(machine_types)}-{'/'.join(aspects)}-degraded"

    def derive() -> FleetCondition:
        report, node_types = simulate_degraded_fleet(
            machine_types, degraded={vm: tuple(aspects)
                                     for vm in machine_types}, seed=seed)
        return condition_from_drift(name, report, node_types)

    if deferred:
        return DeferredFleetCondition(name, derive)
    return derive()


@dataclasses.dataclass(frozen=True)
class Scenario:
    workload: str
    seed: int
    variant: str  # one of VARIANTS
    condition: FleetCondition  # or DeferredFleetCondition
    limit: float  # runtime constraint (seconds)


def build_scenarios(ds: ScoutDataset, *,
                    workloads: Optional[Sequence[str]] = None,
                    seeds: Sequence[int] = (0,),
                    variants: Sequence[str] = VARIANTS,
                    conditions: Sequence[FleetCondition] = (HEALTHY,),
                    limit_percentile: float = 40.0,
                    condition_major: bool = False) -> List[Scenario]:
    """Cartesian scenario matrix. Computing the per-workload runtime
    limits materializes the simulator cache in canonical order (see
    module docstring).

    ``condition_major=True`` orders the matrix condition-outermost, so
    every contiguous lane block touches as few conditions as possible
    — with deferred (store-path-derived) conditions, the pipelined
    replay then derives each block's conditions while the previous
    block runs on device. Building the matrix never resolves deferred
    conditions."""
    workloads = list(ds.workloads) if workloads is None else workloads
    limits = {}
    for wl in workloads:
        rts, _, _ = ds.workload_arrays(wl)
        limits[wl] = float(np.percentile(rts, limit_percentile))
    if condition_major:
        return [Scenario(wl, seed, variant, cond, limits[wl])
                for cond in conditions for wl in workloads
                for seed in seeds for variant in variants]
    return [Scenario(wl, seed, variant, cond, limits[wl])
            for wl in workloads for seed in seeds
            for variant in variants for cond in conditions]


def _scenario_scores(scenario: Scenario, machine_scores):
    return degrade_scores(machine_scores, scenario.condition)


def reference_search(ds: ScoutDataset, scenario: Scenario,
                     machine_scores: Dict[str, Dict[str, float]],
                     cfg: Optional[ReplayConfig] = None):
    """The sequential numpy tuner for one scenario — the parity and
    wall-clock baseline the batched lanes are pinned against."""
    from repro_torch.tuning.arrow import Arrow
    from repro_torch.tuning.cherrypick import CherryPick
    from repro_torch.tuning.perona_weights import PeronaAcquisitionWeighter

    cfg = ReplayConfig() if cfg is None else cfg
    scores = _scenario_scores(scenario, machine_scores)
    weighter = None
    if scenario.variant.endswith("+perona"):
        weighter = PeronaAcquisitionWeighter(
            ds, scores, strength=cfg.strength, per_dollar=cfg.per_dollar)
    kw = dict(max_runs=cfg.max_runs, n_init=cfg.n_init,
              ei_threshold=cfg.ei_threshold, seed=scenario.seed,
              acquisition_weighter=weighter)
    if scenario.variant.startswith("arrow"):
        low_fn = None
        if scenario.variant == "arrow+perona":
            low_fn = (lambda wl, c:
                      machine_score_vector(scores, c.vm_type))
        tuner = Arrow(ds, scenario.limit, low_level_fn=low_fn, **kw)
    else:
        tuner = CherryPick(ds, scenario.limit, **kw)
    return tuner.search(scenario.workload)


def lane_tables(ds: ScoutDataset, scenarios: Sequence[Scenario],
                machine_scores: Dict[str, Dict[str, float]],
                cfg: Optional[ReplayConfig] = None) -> LaneTables:
    """Lower scenarios to the replay engine's stacked lane tables.

    Feature layout is unified across variants at D = 6 base + 4
    low-level dims; variants that do not use a block hold it constant,
    which leaves the reference GP's kernel unchanged exactly (constant
    dimensions median to zero pairwise distance and are floored out of
    the length scales). Arrow's candidate rows keep the low-level block
    at its search-start value (zeros): the sequential implementation
    computes candidate features once, before any run is observed."""
    from repro_torch.tuning.perona_weights import normalized_machine_scores

    cfg = ReplayConfig() if cfg is None else cfg
    configs = ds.configs
    n_cand = len(configs)
    x_base = np.stack([ds.config_features(c) for c in configs])
    prices = np.asarray([PRICES[c.vm_type] for c in configs])

    workload_cache: Dict[str, Tuple] = {}

    def workload_tables(wl: str):
        if wl not in workload_cache:
            workload_cache[wl] = ds.workload_arrays(wl)
        return workload_cache[wl]

    # keyed by object identity: distinct conditions may share a name
    cond_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def condition_tables(cond: FleetCondition):
        if id(cond) not in cond_cache:
            scores = degrade_scores(machine_scores, cond)
            norm = normalized_machine_scores(scores)
            ns = np.stack([norm.get(c.vm_type, np.ones(4))
                           for c in configs])
            fp_low = machine_score_matrix(
                scores, [c.vm_type for c in configs])
            cond_cache[id(cond)] = (ns, fp_low)
        return cond_cache[id(cond)]

    dim = x_base.shape[1] + 4
    n_lanes = len(scenarios)
    tab = LaneTables(
        x_train=np.zeros((n_lanes, n_cand, dim)),
        x_cand=np.zeros((n_lanes, n_cand, dim)),
        y=np.zeros((n_lanes, n_cand)),
        runtime=np.zeros((n_lanes, n_cand)),
        cost=np.zeros((n_lanes, n_cand)),
        limit=np.zeros(n_lanes),
        price=np.tile(prices, (n_lanes, 1)),
        norm_scores=np.zeros((n_lanes, n_cand, 4)),
        util_low=np.zeros((n_lanes, n_cand, 4)),
        use_weighter=np.zeros(n_lanes, bool),
        init_idx=np.zeros((n_lanes, cfg.n_init), np.int32))

    base_dim = x_base.shape[1]
    tab.x_train[:, :, :base_dim] = x_base
    tab.x_cand[:, :, :base_dim] = x_base
    # lanes sharing (workload, condition, variant, limit) get identical
    # rows: assign per group (one fancy-index write each) instead of
    # per lane — the python work is O(groups + lanes), which keeps
    # table construction cheap enough to overlap with device scans
    groups: Dict[Tuple, List[int]] = {}
    for lane, sc in enumerate(scenarios):
        groups.setdefault(
            (sc.workload, id(sc.condition), sc.variant, sc.limit),
            []).append(lane)
    for (wl, _, variant, limit), lanes in groups.items():
        sc = scenarios[lanes[0]]
        rows = np.asarray(lanes)
        runtimes, costs, lows = workload_tables(wl)
        ns, fp_low = condition_tables(sc.condition)
        if variant == "arrow":
            # evaluated runs carry their observed low-level metrics;
            # candidates keep the search-start zeros block
            tab.x_train[rows, :, base_dim:] = lows
        elif variant == "arrow+perona":
            # fingerprint scores exist before any run: both sides
            tab.x_train[rows, :, base_dim:] = fp_low
            tab.x_cand[rows, :, base_dim:] = fp_low
        tab.runtime[rows] = runtimes
        tab.cost[rows] = costs
        tab.y[rows] = np.where(runtimes <= limit, costs, costs * 5.0)
        tab.limit[rows] = limit
        tab.norm_scores[rows] = ns
        tab.util_low[rows] = lows
        tab.use_weighter[rows] = variant.endswith("+perona")
    init_cache: Dict[int, np.ndarray] = {}
    for lane, sc in enumerate(scenarios):
        if sc.seed not in init_cache:
            init_cache[sc.seed] = np.random.default_rng(sc.seed).choice(
                n_cand, cfg.n_init, replace=False).astype(np.int32)
        tab.init_idx[lane] = init_cache[sc.seed]
    return tab


def lane_spec(ds: ScoutDataset, scenarios: Sequence[Scenario],
              machine_scores: Dict[str, Dict[str, float]],
              cfg: Optional[ReplayConfig] = None) -> SeededLaneSpec:
    """Lower scenarios to the *seeded* replay inputs: the shared
    deterministic grid (``ds.grid``), one score matrix per distinct
    fleet condition, and per-lane ids. O(W*C + K*C + L) host work and
    memory — the O(L*C*D) lane tables are generated on the device
    instead (``replay.replay_seeded_async``), with the contention noise
    re-drawn there from ``ds.grid.noise_key`` counter-based keys."""
    from repro_torch.tuning.perona_weights import normalized_machine_scores

    cfg = ReplayConfig() if cfg is None else cfg
    configs = ds.configs
    n_cand = len(configs)
    grid = ds.grid
    n_lanes = len(scenarios)

    # one score-matrix pair per distinct condition object (identity
    # keyed: distinct conditions may share a name); resolving a
    # deferred condition happens here, on the host, thread-safely
    cond_rows: Dict[int, int] = {}
    ns_rows: List[np.ndarray] = []
    fp_rows: List[np.ndarray] = []
    condition_id = np.empty(n_lanes, np.int32)
    workload_id = np.empty(n_lanes, np.int32)
    variant_id = np.empty(n_lanes, np.int32)
    limit = np.empty(n_lanes, np.float64)
    init_idx = np.zeros((n_lanes, cfg.n_init), np.int32)
    init_cache: Dict[int, np.ndarray] = {}
    for lane, sc in enumerate(scenarios):
        row = cond_rows.get(id(sc.condition))
        if row is None:
            scores = degrade_scores(machine_scores, sc.condition)
            norm = normalized_machine_scores(scores)
            ns_rows.append(np.stack([norm.get(c.vm_type, np.ones(4))
                                     for c in configs]))
            fp_rows.append(machine_score_matrix(
                scores, [c.vm_type for c in configs]))
            row = cond_rows[id(sc.condition)] = len(ns_rows) - 1
        condition_id[lane] = row
        workload_id[lane] = ds.workload_id(sc.workload)
        variant_id[lane] = VARIANTS.index(sc.variant)
        limit[lane] = sc.limit
        if sc.seed not in init_cache:
            init_cache[sc.seed] = np.random.default_rng(sc.seed).choice(
                n_cand, cfg.n_init, replace=False).astype(np.int32)
        init_idx[lane] = init_cache[sc.seed]

    from repro_torch.tuning.scout import CONTENTION_SCALE

    return SeededLaneSpec(
        base_runtime=grid.base_runtime, low_num=grid.low_num,
        low_caps=np.asarray(LOW_CAPS, np.float64),
        x_base=grid.x_base, price=grid.price,
        count=grid.count.astype(np.float64, copy=False),
        config_uid=grid.config_uid,
        norm_scores=np.stack(ns_rows), fp_low=np.stack(fp_rows),
        noise_key=grid.noise_key, noise_scale=CONTENTION_SCALE,
        workload_id=workload_id, condition_id=condition_id,
        variant_id=variant_id, limit=limit, init_idx=init_idx,
        runtime=grid.runtime, cost=grid.cost)


def replay_scenarios(ds: ScoutDataset, scenarios: Sequence[Scenario],
                     machine_scores: Dict[str, Dict[str, float]],
                     cfg: Optional[ReplayConfig] = None,
                     return_result: bool = False, *,
                     devices: Optional[Sequence] = None,
                     seeded: bool = False):
    """End to end: lower the matrix, run the batched replay (its lanes
    split over ``devices`` when given, else on the dataset's device),
    return the per-scenario :class:`SearchTrace` list (order matches
    input).

    ``seeded=True`` lowers to the compact :class:`SeededLaneSpec` and
    generates the lane tables on the device instead of materializing
    them on the host — bit-identical traces."""
    cfg = ReplayConfig() if cfg is None else cfg
    device = ds.device if devices is None else None
    if seeded:
        spec = lane_spec(ds, scenarios, machine_scores, cfg)
        result = replay_seeded_async(spec, cfg, devices=devices,
                                     device=device).result()
        traces = traces_from_spec(spec, result, ds.configs)
    else:
        tab = lane_tables(ds, scenarios, machine_scores, cfg)
        result = replay(tab, cfg, devices=devices, device=device)
        traces = traces_from_result(tab, result, ds.configs)
    if return_result:
        return traces, result
    return traces


def replay_pipelined(ds: ScoutDataset, scenarios: Sequence[Scenario],
                     machine_scores: Dict[str, Dict[str, float]],
                     cfg: Optional[ReplayConfig] = None, *,
                     block_lanes: int = 128,
                     devices: Optional[Sequence] = None,
                     shard_blocks: bool = False,
                     seeded: bool = False,
                     return_stats: bool = False):
    """Host-pipelined replay of a large scenario matrix over per-device
    lane buckets.

    The matrix is chunked into fixed-size lane blocks; block N+1's
    tables — workload arrays, deferred (store-path-derived) fleet
    conditions, condition score matrices, seeded init draws — are
    built on the host *while earlier blocks run on device*. Blocks are
    round-robined over ``devices`` (default: the dataset's device) as
    independent dispatches (``replay_async(device=...)``), one worker
    thread per device, up to ``len(devices)`` dispatches in flight:
    devices execute different lane buckets concurrently while the main
    thread keeps building tables and materializing finished blocks'
    traces (torch releases the GIL while a worker waits for its
    device).

    Every block pads its lane axis to the same ``block_lanes`` bucket
    (lane padding repeats lane 0, masked out), so ONE signature serves
    any matrix size — replaying 100-, 200- and 432-lane matrices adds
    no signature (``REPLAY_TRACES``; asserted in
    tests/test_torch_optimizer.py). Results are identical to the
    unpipelined ``replay_scenarios`` lane-for-lane: blocks never
    interact, and a lane's math does not depend on which device runs
    it.

    ``shard_blocks=True`` instead splits each block's lane axis over
    ALL the devices with one dispatch in flight (the whole-matrix split
    layout, blocked for table overlap): prefer it when a single block
    fills every device; the default round-robin keeps devices busy on
    independent blocks.

    ``seeded=True`` lowers each block to the compact
    :class:`SeededLaneSpec` (O(block) host work per block instead of
    O(block x candidates x dims)) and generates the lane tables on the
    device — same traces, far less host table time, so the pipeline
    stays device-bound at matrix sizes where host table construction
    would otherwise dominate.

    Returns the per-scenario trace list; with ``return_stats`` also a
    dict of pipeline counters (blocks, dispatches, device count, host
    table seconds).
    """
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.common.mesh import pow2_devices

    cfg = ReplayConfig() if cfg is None else cfg
    if shard_blocks and devices is None:
        raise ValueError("shard_blocks=True needs devices= (the devices "
                         "to split each block over)")
    block = next_pow2(max(block_lanes, 1))
    all_devs = pow2_devices(devices or [ds.device])
    # one split dispatch in flight at a time with shard_blocks
    devs = [None] if shard_blocks else all_devs
    traces: List = []
    stats = {"blocks": 0, "dispatches": 0, "block_lanes": block,
             "devices": len(all_devs), "table_s": 0.0}

    dispatch = replay_seeded_async if seeded else replay_async

    def run_block(tab, dev, block_idx):
        # worker thread: dispatch + device wait (GIL released while
        # waiting); per-device workers keep each device's blocks in
        # order. The span lands on the worker's own timeline track — its
        # overlap with the main thread's replay.build_tables spans IS
        # the pipelining.
        with obs_trace.span("replay.block_scan",
                            cat=obs_trace.CAT_DEVICE,
                            args={"block": block_idx,
                                  "lanes": len(tab)}):
            if shard_blocks:
                return dispatch(tab, cfg, devices=devices,
                                lanes_floor=block).result()
            return dispatch(tab, cfg, device=dev,
                            lanes_floor=block).result()

    def collect(tab, future):
        result = future.result()
        stats["dispatches"] += result.dispatches
        with obs_trace.span("replay.materialize_traces",
                            args={"lanes": len(tab)}):
            if seeded:
                traces.extend(
                    traces_from_spec(tab, result, ds.configs))
            else:
                traces.extend(
                    traces_from_result(tab, result, ds.configs))

    in_flight: List = []  # (tables, future), submission order
    # one single-worker pool per device: a device's blocks dispatch in
    # order from its own thread, and a long-running block on one
    # device never steals the worker a later block needs for another
    pools = [ThreadPoolExecutor(max_workers=1) for _ in devs]
    try:
        for i, start in enumerate(range(0, len(scenarios), block)):
            chunk = scenarios[start:start + block]
            t0 = time.perf_counter()  # host work, overlapped with the
            with obs_trace.span("replay.build_tables",
                                args={"block": i,
                                      "lanes": len(chunk)}):
                if seeded:
                    tab = lane_spec(ds, chunk, machine_scores, cfg)
                else:
                    tab = lane_tables(ds, chunk, machine_scores, cfg)
            stats["table_s"] += time.perf_counter() - t0
            d = i % len(devs)
            in_flight.append(
                (tab, pools[d].submit(run_block, tab, devs[d], i)))
            stats["blocks"] += 1
            # drain finished blocks (in order) without blocking, and
            # cap the queue at one block per device
            while in_flight and (in_flight[0][1].done()
                                 or len(in_flight) > len(devs)):
                collect(*in_flight.pop(0))
        for pending in in_flight:
            collect(*pending)
    finally:
        for pool in pools:
            pool.shutdown(wait=True)
    if return_stats:
        return traces, stats
    return traces
