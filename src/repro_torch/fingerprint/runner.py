"""Suite runner: quasi-random scheduling of benchmark executions.

Mirrors the paper's acquisition (§IV-A): per machine, each benchmark
type is executed ``runs_per_type`` times, quasi-randomly spread over the
experiment window; network benchmarks are serialized cluster-wide (only
one in flight); a configurable fraction of runs receives ChaosMesh-style
stress on the benchmarked resource.

Acquisition is *columnar*: ``run_frame`` batches the RNG draws per
(machine type x benchmark type) group — one vectorized draw per metric
column — and materializes a :class:`BenchmarkFrame` directly, instead of
looping records x tools x metrics in Python. ``run`` keeps the
record-list API as a thin conversion wrapper, and ``run_reference`` is
the original per-record loop, retained as the benchmarking baseline
(see ``benchmarks/bench_fingerprint.py``).

``run_frame`` draws are *counter-based* (``common.rng``): every group
pulls from an independent generator keyed by ``(seed, round,
benchmark_type, machine_type)`` and nodes iterate in sorted order, so
a group's values are a pure function of that key path and the group's
membership — never of dict insertion order or of which other machine
types are present. The per-call ``round`` counter keeps streaming
semantics (repeated rounds draw fresh values). ``run_reference``
deliberately keeps the single sequential stream (``self.rng``) — it
is the order-*dependent* baseline the frame path is measured against.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.common.rng import folded_generator
from repro_torch.fingerprint.frame import BenchmarkFrame
from repro_torch.fingerprint.machines import MACHINE_PROFILES
from repro_torch.fingerprint.records import BenchmarkExecution
from repro_torch.fingerprint.tools import (EXTRA_CONSTANTS, TOOLS,
                                           node_metrics)

BENCHMARK_TYPES = tuple(TOOLS)

# fold-in stream tag of the columnar frame draws (bumping it re-rolls
# every run_frame realization without touching run_reference)
_FRAME_STREAM = 1

_ASPECT = {
    "sysbench-cpu": "cpu",
    "sysbench-memory": "memory",
    "fio": "disk",
    "ioping": "disk",
    "qperf": "network",
    "iperf3": "network",
}

# metric column layout per benchmark type: (name, unit) in tool order,
# resolved lazily from one probe draw + the constant echoes
_COLUMNS_CACHE: Dict[str, List[Tuple[str, str]]] = {}


def _columns_of(btype: str) -> List[Tuple[str, str]]:
    cols = _COLUMNS_CACHE.get(btype)
    if cols is None:
        probe = TOOLS[btype](MACHINE_PROFILES["e2-medium"],
                             np.random.default_rng(0), np.zeros(1))
        cols = [(name, unit) for name, (_, unit) in probe.items()]
        cols += [(name, unit)
                 for name, (_, unit) in EXTRA_CONSTANTS[btype].items()]
        _COLUMNS_CACHE[btype] = cols
    return cols


class SuiteRunner:
    def __init__(self, seed: int = 0, duration_s: float = 86400.0):
        self.seed = seed
        self.rng = np.random.default_rng(seed)  # run_reference only
        self.duration_s = duration_s
        self._round = 0  # per-call counter: frame rounds stay distinct

    # ------------------------------------------------------------ columnar
    def run_frame(self, machines: Dict[str, str], runs_per_type: int,
                  stress_fraction: float = 0.0,
                  degraded_machines: Optional[Sequence[str]] = None,
                  t_offset: float = 0.0) -> BenchmarkFrame:
        """Columnar acquisition. ``machines``: {node_name: machine_type}.
        ``degraded_machines`` are permanently degraded (every run
        stressed) — used by the runtime watchdog tests. ``t_offset``
        shifts every timestamp (streaming re-fingerprinting rounds
        happen *after* the history they are scored against)."""
        degraded = set(degraded_machines or ())
        node_names = list(machines)
        mtype_vocab = list(dict.fromkeys(machines.values()))
        node_code = {n: i for i, n in enumerate(node_names)}
        mtype_code = {m: i for i, m in enumerate(mtype_vocab)}

        # global metric column layout (union over benchmark types)
        col_index: Dict[Tuple[str, str], int] = {}
        for btype in BENCHMARK_TYPES:
            for key in _columns_of(btype):
                col_index.setdefault(key, len(col_index))
        node_cols = list(node_metrics(
            MACHINE_PROFILES["e2-medium"], np.random.default_rng(0),
            np.zeros(1), "cpu"))
        ncol_index = {k: i for i, k in enumerate(node_cols)}

        n_nodes = len(node_names)
        N = n_nodes * len(BENCHMARK_TYPES) * runs_per_type
        metrics = np.zeros((N, len(col_index)), np.float64)
        present = np.zeros((N, len(col_index)), bool)
        nmetrics = np.zeros((N, len(node_cols)), np.float64)
        type_code = np.empty(N, np.int32)
        machine_code = np.empty(N, np.int32)
        machine_type_code = np.empty(N, np.int32)
        t = np.empty(N, np.float64)
        stressed_all = np.empty(N, bool)

        # per-call round counter: repeated frame rounds on one runner
        # draw fresh (but order-independent) values
        rnd = self._round
        self._round += 1

        # cluster-wide serialized slots for the network benchmarks: one
        # sorted pool, randomly assigned, so only one network benchmark
        # is in flight at any time; its own fold-in stream, consumed in
        # canonical group order
        n_net = sum(runs_per_type * n_nodes
                    for b in BENCHMARK_TYPES if _ASPECT[b] == "network")
        net_rng = folded_generator(self.seed, rnd, "net-slots",
                                   _FRAME_STREAM)
        net_slots = np.sort(net_rng.uniform(0, self.duration_s, n_net))
        net_order = net_rng.permutation(n_net)
        net_used = 0

        # group rows by (benchmark type x machine type): profile constant
        # within a group, so every metric is one batched draw. Groups
        # iterate in canonical sorted order and each pulls from its own
        # (seed, round, btype, mtype) fold-in generator, so a group's
        # draws never depend on dict insertion order or on which other
        # machine types are present.
        nodes_by_mtype: Dict[str, List[str]] = {}
        for node, mtype in machines.items():
            nodes_by_mtype.setdefault(mtype, []).append(node)
        group_mtypes = sorted(nodes_by_mtype)
        for mtype in group_mtypes:
            nodes_by_mtype[mtype].sort()

        off = 0
        for btype in BENCHMARK_TYPES:
            aspect = _ASPECT[btype]
            bt_code = BENCHMARK_TYPES.index(btype)
            cols = np.asarray([col_index[key] for key in
                               _columns_of(btype)], np.int64)
            n_tool_cols = len(cols) - len(EXTRA_CONSTANTS[btype])
            for mtype in group_mtypes:
                nodes = nodes_by_mtype[mtype]
                profile = MACHINE_PROFILES[mtype]
                grng = folded_generator(self.seed, rnd, btype, mtype,
                                        _FRAME_STREAM)
                R = len(nodes) * runs_per_type
                sl = slice(off, off + R)
                rows_node = np.repeat(
                    np.asarray([node_code[n] for n in nodes], np.int32),
                    runs_per_type)
                if aspect == "network":
                    slots = net_slots[net_order[net_used:net_used + R]]
                    net_used += R
                    t[sl] = slots
                else:
                    t[sl] = grng.uniform(0, self.duration_s, R)
                degraded_mask = np.isin(
                    rows_node,
                    [node_code[n] for n in degraded if n in node_code])
                stressed = degraded_mask | (
                    grng.random(R) < stress_fraction)
                severity = np.where(
                    stressed, grng.uniform(0.15, 1.0, R), 0.0)

                md = TOOLS[btype](profile, grng, severity)
                block = np.empty((R, len(cols)), np.float64)
                for j, (name, (vals, _unit)) in enumerate(md.items()):
                    block[:, j] = vals
                for j, (name, (v, _unit)) in enumerate(
                        EXTRA_CONSTANTS[btype].items()):
                    block[:, n_tool_cols + j] = v
                metrics[sl, cols] = block
                present[sl, cols] = True

                nd = node_metrics(profile, grng, severity, aspect)
                for name, vals in nd.items():
                    nmetrics[sl, ncol_index[name]] = vals

                type_code[sl] = bt_code
                machine_code[sl] = rows_node
                machine_type_code[sl] = mtype_code[mtype]
                stressed_all[sl] = stressed
                off += R

        frame = BenchmarkFrame(
            benchmark_types=BENCHMARK_TYPES,
            machines=tuple(node_names),
            machine_types=tuple(mtype_vocab),
            metric_names=tuple(k[0] for k in col_index),
            metric_units=tuple(k[1] for k in col_index),
            node_metric_names=tuple(node_cols),
            type_code=type_code, machine_code=machine_code,
            machine_type_code=machine_type_code, t=t,
            stressed=stressed_all,
            metrics=metrics, metrics_present=present,
            node_metrics=nmetrics,
            node_metrics_present=np.ones_like(nmetrics, bool))
        if t_offset:
            frame.t += t_offset
        return frame.sort_by_time()

    # ----------------------------------------------------- record wrapper
    def run(self, machines: Dict[str, str], runs_per_type: int,
            stress_fraction: float = 0.0,
            degraded_machines: Optional[Sequence[str]] = None,
            ) -> List[BenchmarkExecution]:
        """Record-list acquisition (conversion wrapper over
        :meth:`run_frame`)."""
        return self.run_frame(machines, runs_per_type, stress_fraction,
                              degraded_machines).to_records()

    # ------------------------------------------------------ seed baseline
    def run_reference(self, machines: Dict[str, str], runs_per_type: int,
                      stress_fraction: float = 0.0,
                      degraded_machines: Optional[Sequence[str]] = None,
                      ) -> List[BenchmarkExecution]:
        """The original per-record triple loop (node x type x run, one
        tool-simulator call per record). Kept as the acquisition
        throughput baseline; statistically equivalent to ``run_frame``
        but draws the RNG stream in a different order."""
        degraded = set(degraded_machines or ())
        records: List[BenchmarkExecution] = []
        net_slots = iter(np.sort(self.rng.uniform(
            0, self.duration_s,
            2 * runs_per_type * max(len(machines), 1) + 8)))
        one = np.ones(1)
        for node, mtype in machines.items():
            profile = MACHINE_PROFILES[mtype]
            for btype in BENCHMARK_TYPES:
                aspect = _ASPECT[btype]
                times = np.sort(self.rng.uniform(0, self.duration_s,
                                                 runs_per_type))
                for t in times:
                    stressed = (node in degraded or
                                bool(self.rng.random() < stress_fraction))
                    severity = (float(self.rng.uniform(0.15, 1.0))
                                if stressed else 0.0) * one
                    if aspect == "network":
                        t = float(next(net_slots))  # serialized slot
                    metrics = {
                        name: (float(vals[0]), unit)
                        for name, (vals, unit) in TOOLS[btype](
                            profile, self.rng, severity).items()
                    }
                    metrics.update(EXTRA_CONSTANTS[btype])
                    records.append(BenchmarkExecution(
                        benchmark_type=btype,
                        machine=node,
                        machine_type=mtype,
                        t=float(t),
                        metrics=metrics,
                        node_metrics={
                            k: float(v[0]) for k, v in node_metrics(
                                profile, self.rng, severity,
                                aspect).items()},
                        stressed=bool(stressed),
                    ))
        records.sort(key=lambda r: r.t)
        return records


def paper_acquisition(seed: int = 0) -> List[BenchmarkExecution]:
    """§IV-C setup: 3 benchmarking nodes (e2-medium), 6 types x 100 runs
    each, 20% stressed -> 1800 executions."""
    return paper_acquisition_frame(seed).to_records()


def paper_acquisition_frame(seed: int = 0) -> BenchmarkFrame:
    """Columnar §IV-C acquisition (same content as
    :func:`paper_acquisition`, no record conversion)."""
    runner = SuiteRunner(seed=seed)
    machines = {f"node-{i}": "e2-medium" for i in range(1, 4)}
    return runner.run_frame(machines, runs_per_type=100,
                            stress_fraction=0.2)
