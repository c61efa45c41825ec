"""Stateful preprocessing of benchmark metrics (paper §III-B).

Ordered steps, all statistics fitted on training executions only:

1. Unification  — convert every recording to a canonical unit per unit
   family (s, MiB, MiB/s, ratio, ...) so recordings of one metric are
   comparable across runs/machines.
2. Selection    — keep metrics with >= 2 distinct historical values and
   dispersion >= threshold (coefficient of variation by default; the
   paper says "standard deviation >= configurable threshold" — CV is the
   scale-free variant, configurable via ``std_mode="abs"``).
3. Orientation  — a metric is maximized if its max is closer to its
   median than its min (stress injection skews the tail of the
   to-be-minimized side); minimized metrics are flipped so that *larger
   is better* for every retained feature.
4. Normalization— min-max to (0,1) (boundaries from training, clipped at
   inference) — matches the sigmoid decoder head.
5. Imputation   — metrics absent for a benchmark type are filled with
   the so-far-observed (training) mean of that metric.
6. Enrichment   — one-hot encoding of the benchmark type is appended.

All stages operate on the columnar :class:`BenchmarkFrame`; record
lists are accepted everywhere and converted on entry, so the historical
record-list API keeps working.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fingerprint.frame import (BenchmarkFrame, FrameOrRecords,
                                           as_frame)
from repro_torch.fingerprint.records import BenchmarkExecution

# unit -> (canonical family, multiplier)
UNIT_TABLE: Dict[str, Tuple[str, float]] = {
    "s": ("s", 1.0), "ms": ("s", 1e-3), "us": ("s", 1e-6),
    "ns": ("s", 1e-9), "min": ("s", 60.0),
    "bytes": ("MiB", 1.0 / (1024 * 1024)), "KiB": ("MiB", 1.0 / 1024),
    "MiB": ("MiB", 1.0), "GiB": ("MiB", 1024.0), "MB": ("MiB", 0.95367),
    "KiB/s": ("MiB/s", 1.0 / 1024), "MiB/s": ("MiB/s", 1.0),
    "GiB/s": ("MiB/s", 1024.0), "MB/s": ("MiB/s", 0.95367),
    "bps": ("MiB/s", 1.0 / (8 * 1024 * 1024)),
    "Kbps": ("MiB/s", 1e3 / (8 * 1024 * 1024)),
    "Mbps": ("MiB/s", 1e6 / (8 * 1024 * 1024)),
    "Gbps": ("MiB/s", 1e9 / (8 * 1024 * 1024)),
    "%": ("ratio", 0.01), "ratio": ("ratio", 1.0),
    "K/s": ("1/s", 1e3), "iops": ("1/s", 1.0), "ops/s": ("1/s", 1.0),
    "events/s": ("1/s", 1.0), "1/s": ("1/s", 1.0),
    "count": ("count", 1.0), "events": ("count", 1.0), "ops": ("count", 1.0),
}


def unify(value: float, unit: str) -> float:
    family, mult = UNIT_TABLE.get(unit, ("unknown", 1.0))
    del family
    return float(value) * mult


def _unit_multipliers(units: Sequence[str]) -> np.ndarray:
    return np.asarray([UNIT_TABLE.get(u, ("unknown", 1.0))[1]
                       for u in units], np.float64)


def _merged_columns(frame: BenchmarkFrame
                    ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Unify units and merge same-name metric columns (a frame keys
    columns by (name, unit); one record reports one unit per name, so at
    most one cell per row is present within a name group).

    Returns (names, values (N, G), present (N, G)); group order is
    first-appearance column order.
    """
    uni = frame.metrics * _unit_multipliers(frame.metric_units)
    pres = frame.metrics_present
    groups: Dict[str, List[int]] = {}
    for i, name in enumerate(frame.metric_names):
        groups.setdefault(name, []).append(i)
    names = list(groups)
    n = len(frame)
    values = np.zeros((n, len(names)), np.float64)
    present = np.zeros((n, len(names)), bool)
    for g, (name, cols) in enumerate(groups.items()):
        if len(cols) == 1:
            values[:, g] = np.where(pres[:, cols[0]], uni[:, cols[0]], 0.0)
            present[:, g] = pres[:, cols[0]]
        else:
            for c in cols:
                sel = pres[:, c]
                values[sel, g] = uni[sel, c]
                present[:, g] |= sel
    return names, values, present


@dataclasses.dataclass
class Preprocessor:
    std_threshold: float = 0.02
    std_mode: str = "cv"  # cv | abs
    p_norm: float = 10.0

    # fitted state
    feature_names: Optional[List[str]] = None
    benchmark_types: Optional[List[str]] = None
    maximize: Optional[np.ndarray] = None  # (F',) bool
    lo: Optional[np.ndarray] = None  # (F',)
    hi: Optional[np.ndarray] = None
    fill_mean: Optional[np.ndarray] = None  # normalized-space means
    raw_feature_count: int = 0
    edge_lo: Optional[np.ndarray] = None
    edge_hi: Optional[np.ndarray] = None
    edge_names: Optional[List[str]] = None

    # ------------------------------------------------------------------ fit
    def fit(self, data: FrameOrRecords) -> "Preprocessor":
        frame = as_frame(data)
        names, values, present = _merged_columns(frame)
        self.raw_feature_count = len(names)
        gidx = {n: i for i, n in enumerate(names)}

        selected = []
        for name in sorted(names):
            arr = values[present[:, gidx[name]], gidx[name]]
            if len(np.unique(np.round(arr, 12))) < 2:
                continue
            std = float(np.std(arr))
            if self.std_mode == "cv":
                denom = max(abs(float(np.mean(arr))), 1e-12)
                disp = std / denom
            else:
                disp = std
            if disp >= self.std_threshold:
                selected.append(name)
        self.feature_names = selected

        F = len(selected)
        self.maximize = np.zeros((F,), bool)
        self.lo = np.zeros((F,))
        self.hi = np.ones((F,))
        for i, name in enumerate(selected):
            arr = values[present[:, gidx[name]], gidx[name]]
            mx, mn, med = float(arr.max()), float(arr.min()), float(
                np.median(arr))
            self.maximize[i] = (mx - med) <= (med - mn)
            self.lo[i] = mn
            self.hi[i] = mx if mx > mn else mn + 1.0

        self.benchmark_types = sorted(
            frame.benchmark_types[c] for c in np.unique(frame.type_code))

        # normalized-space training means per feature, for imputation
        # (reuse the merged columns from selection — no second pass)
        raw, fpresent = self._select_features(frame, (names, values,
                                                      present))
        norm = self._normalize(raw)
        cnt = np.maximum(fpresent.sum(0), 1)
        self.fill_mean = (norm * fpresent).sum(0) / cnt

        # edge-attribute scaler (node metrics during the run)
        ecols = [i for i, n in enumerate(frame.node_metric_names)
                 if frame.node_metrics_present[:, i].any()]
        self.edge_names = sorted(frame.node_metric_names[i] for i in ecols)
        em = self.raw_edges(frame)
        self.edge_lo = em.min(0)
        self.edge_hi = np.where(em.max(0) > em.min(0), em.max(0),
                                em.min(0) + 1.0)
        return self

    # ------------------------------------------------------------ transform
    def raw_features(self, data: FrameOrRecords
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Unified (pre-normalization) values of the selected features:
        (N, F') values + presence mask. Feature columns missing from the
        frame come back absent (imputed downstream)."""
        frame = as_frame(data)
        return self._select_features(frame, _merged_columns(frame))

    def _select_features(self, frame, merged):
        names, values, present = merged
        gidx = {n: i for i, n in enumerate(names)}
        F = len(self.feature_names)
        raw = np.zeros((len(frame), F))
        fpresent = np.zeros((len(frame), F), bool)
        for i, name in enumerate(self.feature_names):
            g = gidx.get(name)
            if g is None:
                continue
            raw[:, i] = values[:, g]
            fpresent[:, i] = present[:, g]
        return raw, fpresent

    def _normalize(self, raw: np.ndarray) -> np.ndarray:
        norm = (raw - self.lo) / (self.hi - self.lo)
        norm = np.clip(norm, 0.0, 1.0)
        # orientation: flip minimized metrics so larger is always better
        return np.where(self.maximize, norm, 1.0 - norm)

    def type_ids(self, frame: BenchmarkFrame) -> np.ndarray:
        """(N,) int32 indices into the fitted ``benchmark_types``."""
        tindex = {t: i for i, t in enumerate(self.benchmark_types)}
        lut = np.asarray([tindex.get(t, -1) for t in
                          frame.benchmark_types], np.int32)
        ids = lut[frame.type_code]
        if len(ids) and ids.min() < 0:
            bad = frame.benchmark_types[
                int(frame.type_code[np.argmin(ids)])]
            raise KeyError(f"benchmark type {bad!r} was not fitted")
        return ids

    def transform(self, data: FrameOrRecords) -> np.ndarray:
        """Returns x' (N, F' + n_types) in (0,1)."""
        frame = as_frame(data)
        raw, present = self.raw_features(frame)
        norm = self._normalize(raw)
        norm = np.where(present, norm, self.fill_mean)
        onehot = np.zeros((len(frame), len(self.benchmark_types)))
        onehot[np.arange(len(frame)), self.type_ids(frame)] = 1.0
        return np.concatenate([norm, onehot], axis=1)

    def raw_edges(self, data: FrameOrRecords) -> np.ndarray:
        """Raw (unscaled) node-metric matrix in fitted ``edge_names``
        column order; absent gauges are 0 (as in the record path)."""
        frame = as_frame(data)
        nidx = {n: i for i, n in enumerate(frame.node_metric_names)}
        em = np.zeros((len(frame), len(self.edge_names)))
        for j, name in enumerate(self.edge_names):
            c = nidx.get(name)
            if c is None:
                continue
            em[:, j] = np.where(frame.node_metrics_present[:, c],
                                frame.node_metrics[:, c], 0.0)
        return em

    def transform_edges(self, data: FrameOrRecords) -> np.ndarray:
        em = self.raw_edges(data)
        return np.clip((em - self.edge_lo) / (self.edge_hi - self.edge_lo),
                       0.0, 1.0)

    # ---------------------------------------------------------------- info
    @property
    def n_selected(self) -> int:
        return len(self.feature_names or ())

    @property
    def feature_dim(self) -> int:
        return self.n_selected + len(self.benchmark_types or ())

    def type_id(self, r: BenchmarkExecution) -> int:
        return self.benchmark_types.index(r.benchmark_type)

    def groundtruth_norm(self, x: np.ndarray) -> np.ndarray:
        """p-norm (p=10) of preprocessed vectors — the ranking ground
        truth of §III-D (computed on the metric block, sans one-hot)."""
        feats = x[..., : self.n_selected]
        return np.power(
            np.power(np.abs(feats), self.p_norm).sum(-1),
            1.0 / self.p_norm)

    def aspect_slices(self) -> Dict[str, np.ndarray]:
        """Feature indices per resource aspect (cpu/memory/disk/network)."""
        prefix_aspect = {
            "cpu.": "cpu", "mem.": "memory", "fio.": "disk",
            "ioping.": "disk", "qperf.": "network", "iperf3.": "network",
        }
        out: Dict[str, List[int]] = {}
        for i, name in enumerate(self.feature_names):
            for pre, asp in prefix_aspect.items():
                if name.startswith(pre):
                    out.setdefault(asp, []).append(i)
        return {k: np.asarray(v) for k, v in out.items()}
