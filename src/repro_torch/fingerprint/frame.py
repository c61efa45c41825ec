"""Columnar (struct-of-arrays) representation of benchmark executions.

``BenchmarkFrame`` is the canonical in-memory format for Perona's
acquisition and scoring path: per-metric float columns plus int-coded
benchmark type / machine / machine type, timestamps and stress flags.
The record-list format (:class:`BenchmarkExecution`) remains as the
interchange/compat type; ``from_records``/``to_records`` are lossless
converters between the two.

Metric columns are keyed by *(name, unit)* so that mixed-unit
recordings of one metric (e.g. latencies in ``ms`` and ``s``) round-trip
exactly; the preprocessing layer merges same-name columns after unit
unification. Node-metric columns (Prometheus-style gauges sampled
during a run) are keyed by name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple, Union

import numpy as np

from repro_torch.fingerprint.records import BenchmarkExecution


@dataclasses.dataclass
class BenchmarkFrame:
    # vocabularies (code -> name)
    benchmark_types: Tuple[str, ...]
    machines: Tuple[str, ...]
    machine_types: Tuple[str, ...]
    # column keys
    metric_names: Tuple[str, ...]  # (M,) per column
    metric_units: Tuple[str, ...]  # (M,) per column
    node_metric_names: Tuple[str, ...]  # (E,)
    # row arrays
    type_code: np.ndarray  # (N,) int32 into benchmark_types
    machine_code: np.ndarray  # (N,) int32 into machines
    machine_type_code: np.ndarray  # (N,) int32 into machine_types
    t: np.ndarray  # (N,) float64 seconds since experiment start
    stressed: np.ndarray  # (N,) bool ground-truth degradation marker
    # column data
    metrics: np.ndarray  # (N, M) float64 raw (un-unified) values
    metrics_present: np.ndarray  # (N, M) bool
    node_metrics: np.ndarray  # (N, E) float64
    node_metrics_present: np.ndarray  # (N, E) bool

    # ------------------------------------------------------------- basics
    def __len__(self) -> int:
        return int(self.t.shape[0])

    @property
    def n_metrics(self) -> int:
        return len(self.metric_names)

    def machine_names(self) -> List[str]:
        return [self.machines[c] for c in self.machine_code]

    def type_names(self) -> List[str]:
        return [self.benchmark_types[c] for c in self.type_code]

    def select(self, idx: np.ndarray) -> "BenchmarkFrame":
        """Row subset (column layout and vocabularies unchanged)."""
        idx = np.asarray(idx)
        return dataclasses.replace(
            self,
            type_code=self.type_code[idx],
            machine_code=self.machine_code[idx],
            machine_type_code=self.machine_type_code[idx],
            t=self.t[idx], stressed=self.stressed[idx],
            metrics=self.metrics[idx],
            metrics_present=self.metrics_present[idx],
            node_metrics=self.node_metrics[idx],
            node_metrics_present=self.node_metrics_present[idx])

    def sort_by_time(self) -> "BenchmarkFrame":
        """Stable sort of rows by timestamp."""
        return self.select(np.argsort(self.t, kind="stable"))

    # -------------------------------------------------------- converters
    @classmethod
    def from_records(cls, records: Sequence[BenchmarkExecution]
                     ) -> "BenchmarkFrame":
        n = len(records)
        btypes = sorted({r.benchmark_type for r in records})
        machines = sorted({r.machine for r in records})
        mtypes = sorted({r.machine_type for r in records})
        cols = sorted({(name, unit) for r in records
                       for name, (_, unit) in r.metrics.items()})
        ncols = sorted({k for r in records for k in r.node_metrics})
        bidx = {b: i for i, b in enumerate(btypes)}
        midx = {m: i for i, m in enumerate(machines)}
        tidx = {m: i for i, m in enumerate(mtypes)}
        cidx = {c: i for i, c in enumerate(cols)}
        nidx = {k: i for i, k in enumerate(ncols)}

        metrics = np.zeros((n, len(cols)), np.float64)
        present = np.zeros((n, len(cols)), bool)
        nmetrics = np.zeros((n, len(ncols)), np.float64)
        npresent = np.zeros((n, len(ncols)), bool)
        type_code = np.empty(n, np.int32)
        machine_code = np.empty(n, np.int32)
        machine_type_code = np.empty(n, np.int32)
        t = np.empty(n, np.float64)
        stressed = np.empty(n, bool)
        for j, r in enumerate(records):
            type_code[j] = bidx[r.benchmark_type]
            machine_code[j] = midx[r.machine]
            machine_type_code[j] = tidx[r.machine_type]
            t[j] = r.t
            stressed[j] = r.stressed
            for name, (v, unit) in r.metrics.items():
                i = cidx[(name, unit)]
                metrics[j, i] = v
                present[j, i] = True
            for k, v in r.node_metrics.items():
                i = nidx[k]
                nmetrics[j, i] = v
                npresent[j, i] = True
        return cls(
            benchmark_types=tuple(btypes), machines=tuple(machines),
            machine_types=tuple(mtypes),
            metric_names=tuple(c[0] for c in cols),
            metric_units=tuple(c[1] for c in cols),
            node_metric_names=tuple(ncols),
            type_code=type_code, machine_code=machine_code,
            machine_type_code=machine_type_code, t=t, stressed=stressed,
            metrics=metrics, metrics_present=present,
            node_metrics=nmetrics, node_metrics_present=npresent)

    def to_records(self) -> List[BenchmarkExecution]:
        out: List[BenchmarkExecution] = []
        cols = list(zip(self.metric_names, self.metric_units))
        for j in range(len(self)):
            metrics = {
                cols[i][0]: (float(self.metrics[j, i]), cols[i][1])
                for i in np.nonzero(self.metrics_present[j])[0]
            }
            node = {
                self.node_metric_names[i]: float(self.node_metrics[j, i])
                for i in np.nonzero(self.node_metrics_present[j])[0]
            }
            out.append(BenchmarkExecution(
                benchmark_type=self.benchmark_types[self.type_code[j]],
                machine=self.machines[self.machine_code[j]],
                machine_type=self.machine_types[
                    self.machine_type_code[j]],
                t=float(self.t[j]), metrics=metrics, node_metrics=node,
                stressed=bool(self.stressed[j])))
        return out


FrameOrRecords = Union[BenchmarkFrame, Sequence[BenchmarkExecution]]


def as_frame(data: FrameOrRecords) -> BenchmarkFrame:
    if isinstance(data, BenchmarkFrame):
        return data
    return BenchmarkFrame.from_records(data)


def _remap_vocab(vocabs: Iterable[Tuple[str, ...]]
                 ) -> Tuple[Tuple[str, ...], List[np.ndarray]]:
    """Union of vocabularies + per-input code remap LUTs."""
    union: List[str] = []
    seen: Dict[str, int] = {}
    luts = []
    for vocab in vocabs:
        lut = np.empty(max(len(vocab), 1), np.int32)
        for i, name in enumerate(vocab):
            if name not in seen:
                seen[name] = len(union)
                union.append(name)
            lut[i] = seen[name]
        luts.append(lut)
    return tuple(union), luts


def concat_frames(frames: Sequence[BenchmarkFrame]) -> BenchmarkFrame:
    """Row-wise concatenation with column/vocabulary union."""
    frames = [f for f in frames if f is not None]
    assert frames, "concat_frames needs at least one frame"
    if len(frames) == 1:
        return frames[0]

    btypes, blut = _remap_vocab(f.benchmark_types for f in frames)
    machines, mlut = _remap_vocab(f.machines for f in frames)
    mtypes, tlut = _remap_vocab(f.machine_types for f in frames)

    first = frames[0]
    if all(f.metric_names == first.metric_names
           and f.metric_units == first.metric_units
           and f.node_metric_names == first.node_metric_names
           for f in frames[1:]):
        # fast path (the fleet store's append cadence): identical
        # column layout -> plain row concatenation, only vocabulary
        # codes need remapping
        return BenchmarkFrame(
            benchmark_types=btypes, machines=machines,
            machine_types=mtypes,
            metric_names=first.metric_names,
            metric_units=first.metric_units,
            node_metric_names=first.node_metric_names,
            type_code=np.concatenate(
                [bl[f.type_code] for f, bl in zip(frames, blut)]),
            machine_code=np.concatenate(
                [ml[f.machine_code] for f, ml in zip(frames, mlut)]),
            machine_type_code=np.concatenate(
                [tl[f.machine_type_code]
                 for f, tl in zip(frames, tlut)]),
            t=np.concatenate([f.t for f in frames]),
            stressed=np.concatenate([f.stressed for f in frames]),
            metrics=np.concatenate([f.metrics for f in frames]),
            metrics_present=np.concatenate(
                [f.metrics_present for f in frames]),
            node_metrics=np.concatenate(
                [f.node_metrics for f in frames]),
            node_metrics_present=np.concatenate(
                [f.node_metrics_present for f in frames]))

    cols: List[Tuple[str, str]] = []
    cseen: Dict[Tuple[str, str], int] = {}
    ncols: List[str] = []
    nseen: Dict[str, int] = {}
    for f in frames:
        for key in zip(f.metric_names, f.metric_units):
            if key not in cseen:
                cseen[key] = len(cols)
                cols.append(key)
        for key in f.node_metric_names:
            if key not in nseen:
                nseen[key] = len(ncols)
                ncols.append(key)

    n = sum(len(f) for f in frames)
    metrics = np.zeros((n, len(cols)), np.float64)
    present = np.zeros((n, len(cols)), bool)
    nmetrics = np.zeros((n, len(ncols)), np.float64)
    npresent = np.zeros((n, len(ncols)), bool)
    type_code = np.empty(n, np.int32)
    machine_code = np.empty(n, np.int32)
    machine_type_code = np.empty(n, np.int32)
    t = np.empty(n, np.float64)
    stressed = np.empty(n, bool)

    off = 0
    for f, bl, ml, tl in zip(frames, blut, mlut, tlut):
        m = len(f)
        sl = slice(off, off + m)
        ci = np.asarray([cseen[key] for key in
                         zip(f.metric_names, f.metric_units)], np.int64)
        ni = np.asarray([nseen[key] for key in f.node_metric_names],
                        np.int64)
        if len(ci):
            metrics[sl, ci] = f.metrics
            present[sl, ci] = f.metrics_present
        if len(ni):
            nmetrics[sl, ni] = f.node_metrics
            npresent[sl, ni] = f.node_metrics_present
        type_code[sl] = bl[f.type_code]
        machine_code[sl] = ml[f.machine_code]
        machine_type_code[sl] = tl[f.machine_type_code]
        t[sl] = f.t
        stressed[sl] = f.stressed
        off += m
    return BenchmarkFrame(
        benchmark_types=btypes, machines=machines, machine_types=mtypes,
        metric_names=tuple(c[0] for c in cols),
        metric_units=tuple(c[1] for c in cols),
        node_metric_names=tuple(ncols),
        type_code=type_code, machine_code=machine_code,
        machine_type_code=machine_type_code, t=t, stressed=stressed,
        metrics=metrics, metrics_present=present,
        node_metrics=nmetrics, node_metrics_present=npresent)
