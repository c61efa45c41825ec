"""Append-only columnar fingerprint store (paper §III-C context).

Perona scores a new benchmark execution *against the history of
previous executions of the same node*; Karasu extends that history to
profiling data shared across users. Both need a durable, queryable
store whose context-assembly path is cheap at fleet traffic rates.

``FingerprintStore`` keeps executions in *amortized growable column
buffers* (capacity-doubling preallocated arrays, one per
:class:`BenchmarkFrame` column), parallel per-row arrays for global row
ids and attached scores (anomaly probability + fingerprint codes, NaN
until scored), and an optional per-row *feature cache* (the §III-B
preprocessed columns produced by ``serving.engine.prepare_features``)
so the fleet service never re-runs Python-side preprocessing for
context rows.

Views are pure array gathers over an *incrementally maintained*
per-(machine x benchmark type) chain index: every chain holds its row
indices sorted by (t, row), and an appended chunk merges into only the
chains it touches — in O(chunk) when the chunk's timestamps extend the
chain (the streaming fleet cadence), O(chain) otherwise. Appends never
touch the whole store (the old consolidate-and-rebuild design was
O(total rows) per flush), context reads locate a round's new rows by
``searchsorted`` on the sorted row ids, and per-chain filters touch
only the selected chains; ``bench_fleet`` asserts the amortized
append-round throughput. Vocabulary growth is in-place; only a
*schema* change (a chunk introducing new metric columns) pays a
one-off O(total) column widening.

``save``/``load`` round-trip the whole store through one ``.npz`` file
for durability; saves are atomic (temp file + ``os.replace``), so a
crash mid-save never corrupts the previous snapshot.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.fingerprint.frame import (BenchmarkFrame, FrameOrRecords,
                                           as_frame)

FEATURE_KEYS = ("raw", "present", "type_ids", "edge_raw")

_MIN_CAP = 64


def atomic_savez(path: str, **payload) -> None:
    """Crash-safe ``np.savez_compressed``: write to a temp file in the
    target's directory, then ``os.replace`` — a crash mid-save leaves
    the previous snapshot intact instead of a truncated ``.npz``.
    Shared by :meth:`FingerprintStore.save` and the ingestion daemon's
    staging checkpoints."""
    path = os.path.abspath(path)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez_compressed(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


class _IntVec:
    """Growable int64 vector (amortized O(1) append)."""

    __slots__ = ("a", "n")

    def __init__(self, cap: int = 8):
        self.a = np.empty(cap, np.int64)
        self.n = 0

    def view(self) -> np.ndarray:
        return self.a[: self.n]

    def extend(self, vals: np.ndarray) -> None:
        need = self.n + len(vals)
        if need > len(self.a):
            grown = np.empty(max(2 * len(self.a), need), np.int64)
            grown[: self.n] = self.a[: self.n]
            self.a = grown
        self.a[self.n: need] = vals
        self.n = need

    def replace(self, vals: np.ndarray) -> None:
        self.a = np.asarray(vals, np.int64).copy()
        self.n = len(vals)


class FingerprintStore:
    """Append-only columnar store of scored benchmark executions."""

    def __init__(self):
        self._n = 0
        self._cap = 0
        # vocabularies (grow in place; code -> name)
        self._btypes: List[str] = []
        self._bidx: Dict[str, int] = {}
        self._machines: List[str] = []
        self._midx: Dict[str, int] = {}
        self._mtypes: List[str] = []
        self._tidx: Dict[str, int] = {}
        # column schema (append-only union across chunks)
        self._cols: List[Tuple[str, str]] = []  # (name, unit)
        self._cidx: Dict[Tuple[str, str], int] = {}
        self._ncols: List[str] = []
        self._nidx: Dict[str, int] = {}
        # row buffers (capacity _cap, first _n rows live)
        self._type_code = np.empty(0, np.int32)
        self._machine_code = np.empty(0, np.int32)
        self._machine_type_code = np.empty(0, np.int32)
        self._t = np.empty(0, np.float64)
        self._stressed = np.empty(0, bool)
        self._metrics = np.empty((0, 0), np.float64)
        self._metrics_present = np.empty((0, 0), bool)
        self._node_metrics = np.empty((0, 0), np.float64)
        self._node_metrics_present = np.empty((0, 0), bool)
        self._row_id = np.empty(0, np.int64)
        self._anomaly = np.empty(0, np.float32)
        self._codes: Optional[np.ndarray] = None  # (cap, K) once known
        self._features: Optional[Dict[str, np.ndarray]] = None
        self._has_features: Optional[bool] = None  # set on first append
        self._next_id = 0
        # row ids are appended in increasing order, so they stay
        # sorted by row index until a compact reorders rows by time
        self._ids_sorted = True
        # incremental index: machine code -> benchmark code -> row
        # indices sorted by (t, row)
        self._chains: Dict[int, Dict[int, _IntVec]] = {}
        self._frame_cache: Optional[BenchmarkFrame] = None

    # ------------------------------------------------------------- basics
    def __len__(self) -> int:
        return self._n

    @property
    def frame(self) -> Optional[BenchmarkFrame]:
        """The live rows as one columnar frame (None while empty).
        Zero-copy column views; stable object identity between
        mutations."""
        if self._n == 0:
            return None
        if self._frame_cache is None:
            self._frame_cache = BenchmarkFrame(
                benchmark_types=tuple(self._btypes),
                machines=tuple(self._machines),
                machine_types=tuple(self._mtypes),
                metric_names=tuple(c[0] for c in self._cols),
                metric_units=tuple(c[1] for c in self._cols),
                node_metric_names=tuple(self._ncols),
                type_code=self._type_code[: self._n],
                machine_code=self._machine_code[: self._n],
                machine_type_code=self._machine_type_code[: self._n],
                t=self._t[: self._n],
                stressed=self._stressed[: self._n],
                metrics=self._metrics[: self._n],
                metrics_present=self._metrics_present[: self._n],
                node_metrics=self._node_metrics[: self._n],
                node_metrics_present=self._node_metrics_present[
                    : self._n])
        return self._frame_cache

    @property
    def next_id(self) -> int:
        """The global row id the next appended row will receive."""
        return self._next_id

    @property
    def row_id(self) -> np.ndarray:
        """(N,) monotonically increasing global row ids (append order);
        ids survive :meth:`compact`."""
        return self._row_id[: self._n]

    @property
    def anomaly(self) -> np.ndarray:
        """(N,) attached anomaly probabilities (NaN until scored)."""
        return self._anomaly[: self._n]

    @property
    def codes(self) -> Optional[np.ndarray]:
        """(N, K) attached fingerprint codes (NaN rows until scored)."""
        return None if self._codes is None else self._codes[: self._n]

    @property
    def features(self) -> Optional[Dict[str, np.ndarray]]:
        """Cached per-row preprocessed columns (see FEATURE_KEYS)."""
        if self._features is None:
            return None
        return {k: v[: self._n] for k, v in self._features.items()}

    # ----------------------------------------------------------- capacity
    def _grow_rows(self, need: int) -> None:
        if need <= self._cap:
            return
        cap = max(2 * self._cap, need, _MIN_CAP)

        def grow(buf, fill=None):
            out = np.empty((cap,) + buf.shape[1:], buf.dtype)
            out[: self._n] = buf[: self._n]
            if fill is not None:
                out[self._n:] = fill
            return out

        self._type_code = grow(self._type_code)
        self._machine_code = grow(self._machine_code)
        self._machine_type_code = grow(self._machine_type_code)
        self._t = grow(self._t)
        self._stressed = grow(self._stressed)
        self._metrics = grow(self._metrics)
        self._metrics_present = grow(self._metrics_present, fill=False)
        self._node_metrics = grow(self._node_metrics)
        self._node_metrics_present = grow(self._node_metrics_present,
                                          fill=False)
        self._row_id = grow(self._row_id)
        self._anomaly = grow(self._anomaly, fill=np.nan)
        if self._codes is not None:
            self._codes = grow(self._codes, fill=np.nan)
        if self._features is not None:
            self._features = {k: grow(v)
                              for k, v in self._features.items()}
        self._cap = cap

    def _widen_columns(self, n_cols: int, n_ncols: int) -> None:
        """Grow the metric column axes (rare: only when a chunk
        introduces new metric names — an O(total) schema change)."""
        if n_cols > self._metrics.shape[1]:
            for name in ("_metrics", "_metrics_present"):
                buf = getattr(self, name)
                out = np.zeros((self._cap, n_cols), buf.dtype)
                out[: self._n, : buf.shape[1]] = buf[: self._n]
                setattr(self, name, out)
        if n_ncols > self._node_metrics.shape[1]:
            for name in ("_node_metrics", "_node_metrics_present"):
                buf = getattr(self, name)
                out = np.zeros((self._cap, n_ncols), buf.dtype)
                out[: self._n, : buf.shape[1]] = buf[: self._n]
                setattr(self, name, out)

    @staticmethod
    def _intern_one(key, vocab: List, index: Dict) -> int:
        """Get-or-append one key in a (vocab, index) pair."""
        code = index.get(key)
        if code is None:
            code = len(vocab)
            vocab.append(key)
            index[key] = code
        return code

    @classmethod
    def _intern(cls, names, vocab: List[str],
                index: Dict) -> np.ndarray:
        """Map chunk-local names to global codes, growing the
        vocabulary in place; returns the chunk-code -> global-code LUT."""
        lut = np.empty(max(len(names), 1), np.int32)
        for i, name in enumerate(names):
            lut[i] = cls._intern_one(name, vocab, index)
        return lut

    # ------------------------------------------------------------- append
    def append(self, data: FrameOrRecords,
               features: Optional[Dict[str, np.ndarray]] = None,
               anomaly: Optional[np.ndarray] = None,
               codes: Optional[np.ndarray] = None) -> int:
        """Append one chunk of executions; returns the first global row
        id of the chunk (ids are contiguous per chunk)."""
        frame = as_frame(data)
        n = len(frame)
        if n == 0:
            return self._next_id
        if self._has_features is None:
            self._has_features = features is not None
        elif self._has_features != (features is not None):
            raise ValueError(
                "cannot mix feature-cached and plain appends: the "
                "store either caches features for every row or none")
        first = self._next_id

        blut = self._intern(frame.benchmark_types, self._btypes,
                            self._bidx)
        mlut = self._intern(frame.machines, self._machines, self._midx)
        tlut = self._intern(frame.machine_types, self._mtypes,
                            self._tidx)
        ci = np.asarray([self._intern_metric(key) for key
                         in zip(frame.metric_names,
                                frame.metric_units)], np.int64)
        ni = np.asarray([self._intern_col(key) for key
                         in frame.node_metric_names], np.int64)

        self._grow_rows(self._n + n)
        self._widen_columns(len(self._cols), len(self._ncols))

        lo, hi = self._n, self._n + n
        self._type_code[lo:hi] = blut[frame.type_code]
        self._machine_code[lo:hi] = mlut[frame.machine_code]
        self._machine_type_code[lo:hi] = tlut[frame.machine_type_code]
        self._t[lo:hi] = frame.t
        self._stressed[lo:hi] = frame.stressed
        self._metrics[lo:hi] = 0.0
        self._metrics_present[lo:hi] = False
        self._node_metrics[lo:hi] = 0.0
        self._node_metrics_present[lo:hi] = False
        if len(ci):
            self._metrics[lo:hi, ci] = frame.metrics
            self._metrics_present[lo:hi, ci] = frame.metrics_present
        if len(ni):
            self._node_metrics[lo:hi, ni] = frame.node_metrics
            self._node_metrics_present[lo:hi, ni] = \
                frame.node_metrics_present
        self._row_id[lo:hi] = np.arange(first, first + n)
        self._anomaly[lo:hi] = (np.nan if anomaly is None
                                else np.asarray(anomaly, np.float32))
        if codes is not None:
            codes = np.asarray(codes, np.float32)
            if self._codes is None:
                self._codes = np.full((self._cap, codes.shape[1]),
                                      np.nan, np.float32)
            self._codes[lo:hi] = codes
        elif self._codes is not None:
            self._codes[lo:hi] = np.nan
        if features is not None:
            if self._features is None:
                self._features = {}
                for key in FEATURE_KEYS:
                    col = np.asarray(features[key])
                    buf = np.zeros((self._cap,) + col.shape[1:],
                                   col.dtype)
                    self._features[key] = buf
            for key in FEATURE_KEYS:
                self._features[key][lo:hi] = np.asarray(features[key])

        self._merge_into_chains(lo, hi)
        self._n = hi
        self._next_id += n
        self._frame_cache = None
        return first

    def _intern_metric(self, key: Tuple[str, str]) -> int:
        return self._intern_one(key, self._cols, self._cidx)

    def _intern_col(self, key: str) -> int:
        return self._intern_one(key, self._ncols, self._nidx)

    # -------------------------------------------------------------- index
    def _merge_into_chains(self, lo: int, hi: int) -> None:
        """Merge the rows [lo, hi) into their per-chain sorted index:
        O(chunk) when a chunk extends its chains in time (the streaming
        cadence), O(chain) per out-of-order chain otherwise."""
        rows = np.arange(lo, hi, dtype=np.int64)
        key = (self._machine_code[lo:hi].astype(np.int64)
               * max(len(self._btypes), 1)
               + self._type_code[lo:hi])
        order = np.lexsort((rows, self._t[lo:hi], key))
        key_sorted = key[order]
        boundary = np.nonzero(np.diff(key_sorted))[0] + 1
        starts = np.concatenate([[0], boundary])
        ends = np.concatenate([boundary, [hi - lo]])
        nb = max(len(self._btypes), 1)
        for s, e in zip(starts, ends):
            k = int(key_sorted[s])
            m_code, b_code = k // nb, k % nb
            chain = self._chains.setdefault(m_code, {}).get(b_code)
            if chain is None:
                chain = _IntVec()
                self._chains[m_code][b_code] = chain
            new_rows = rows[order[s:e]]
            old = chain.view()
            if (len(old) == 0
                    or self._t[new_rows[0]] >= self._t[old[-1]]):
                chain.extend(new_rows)
            else:
                both = np.concatenate([old, new_rows])
                chain.replace(both[np.lexsort((both, self._t[both]))])

    def _rebuild_chains(self) -> None:
        self._chains = {}
        if self._n:
            self._merge_into_chains(0, self._n)

    # ------------------------------------------------------------ scoring
    def attach(self, idx: np.ndarray, anomaly: np.ndarray,
               codes: Optional[np.ndarray] = None) -> None:
        """Attach scores to rows (by current row *index*, not id)."""
        idx = np.asarray(idx)
        self._anomaly[idx] = np.asarray(anomaly, np.float32)
        if codes is not None:
            codes = np.asarray(codes, np.float32)
            if self._codes is None:
                self._codes = np.full((self._cap, codes.shape[1]),
                                      np.nan, np.float32)
            self._codes[idx] = codes

    # -------------------------------------------------------------- views
    def view(self, node: Optional[str] = None,
             benchmark_type: Optional[str] = None, *,
             t_min: Optional[float] = None,
             t_max: Optional[float] = None,
             before_id: Optional[int] = None,
             newest_per_chain: Optional[int] = None) -> np.ndarray:
        """Row indices (chronological, stable) of the selected
        executions: per-(node x benchmark type) chains filtered to a
        time window and/or rows appended before a given global row id
        (``before_id``, applied before the per-chain ``newest`` cap —
        "history as of that append") and/or the newest K rows per
        chain. Pure array gather — one slice + searchsorted/mask per
        selected chain."""
        if self._n == 0:
            return np.zeros(0, np.int64)
        if node is None:
            m_codes = sorted(self._chains)
        else:
            m_code = self._midx.get(node)
            if m_code is None:
                return np.zeros(0, np.int64)
            m_codes = [m_code]
        b_code = None
        if benchmark_type is not None:
            b_code = self._bidx.get(benchmark_type)
            if b_code is None:
                return np.zeros(0, np.int64)
        parts = []
        for mc in m_codes:
            for bc in sorted(self._chains.get(mc, {})):
                if b_code is not None and bc != b_code:
                    continue
                rows = self._chains[mc][bc].view()
                if t_min is not None or t_max is not None:
                    ts = self._t[rows]
                    lo = 0 if t_min is None else int(
                        np.searchsorted(ts, t_min, "left"))
                    hi = len(rows) if t_max is None else int(
                        np.searchsorted(ts, t_max, "right"))
                    rows = rows[lo:hi]
                if before_id is not None:
                    rows = rows[self._row_id[rows] < before_id]
                if newest_per_chain is not None:
                    rows = rows[max(len(rows) - newest_per_chain, 0):]
                parts.append(rows)
        if not parts:
            return np.zeros(0, np.int64)
        sel = np.concatenate(parts)
        return sel[np.lexsort((sel, self._t[sel]))]

    def context(self, node: str, per_chain: int) -> np.ndarray:
        """Scoring context for ``node``: the newest ``per_chain`` rows
        of each of its benchmark-type chains, chronological."""
        return self.view(node, newest_per_chain=per_chain)

    def context_with_new(self, first_id: int, per_chain: int,
                         node: Optional[str] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """THE scoring-context rule shared by the fleet service, the
        watchdog and the benchmarks: for rows appended at or after
        ``first_id`` ("the round"), assemble the newest ``per_chain``
        rows of every chain *as of before the round* plus every new
        row (of ``node`` only, when given), in chronological (t, row)
        order. Returns (row indices, is-new mask)."""
        if self._n == 0:
            return np.zeros(0, np.int64), np.zeros(0, bool)
        ctx = self.view(node, before_id=first_id,
                        newest_per_chain=per_chain)
        if self._ids_sorted:
            # never-compacted stores keep row_id sorted by row index:
            # the round's rows are a tail slice, found in O(log n)
            start = int(np.searchsorted(self.row_id, first_id, "left"))
            new = np.arange(start, self._n, dtype=np.int64)
        else:
            new = np.nonzero(self.row_id >= first_id)[0]
        if node is not None:
            m_code = self._midx.get(node, -1)
            new = new[self._machine_code[new] == m_code]
        idx = np.concatenate([ctx, new])
        idx = idx[np.lexsort((idx, self._t[idx]))]
        return idx, self._row_id[idx] >= first_id

    # ------------------------------------------------------------ compact
    def _select_inplace(self, idx: np.ndarray) -> None:
        """Rebuild the buffers around a row subset (ids preserved)."""
        n = len(idx)
        for name in ("_type_code", "_machine_code",
                     "_machine_type_code", "_t", "_stressed",
                     "_metrics", "_metrics_present", "_node_metrics",
                     "_node_metrics_present", "_row_id", "_anomaly"):
            setattr(self, name, getattr(self, name)[idx].copy())
        if self._codes is not None:
            self._codes = self._codes[idx].copy()
        if self._features is not None:
            self._features = {k: v[idx].copy()
                              for k, v in self._features.items()}
        self._n = n
        self._cap = n
        self._ids_sorted = bool(np.all(np.diff(self._row_id) >= 0))
        self._rebuild_chains()
        self._frame_cache = None

    def compact(self, per_chain: int) -> None:
        """Drop all but the newest ``per_chain`` rows of every chain
        (row ids are preserved). Bounds memory for long-running owners
        like the watchdog; the fleet service keeps the full history."""
        if self._n == 0:
            return
        self._select_inplace(self.view(newest_per_chain=per_chain))

    def clear(self) -> None:
        self.__init__()

    # ---------------------------------------------------------- save/load
    def save(self, path: str) -> None:
        """Durable one-file snapshot (compressed .npz). The write is
        atomic (:func:`atomic_savez`): a crash mid-save can never leave
        a corrupt or truncated snapshot behind."""
        f = self.frame
        if f is None:
            atomic_savez(path, empty=np.asarray(True),
                         next_id=np.asarray(self._next_id))
            return
        payload = {
            "empty": np.asarray(False),
            "next_id": np.asarray(self._next_id),
            "benchmark_types": np.asarray(f.benchmark_types),
            "machines": np.asarray(f.machines),
            "machine_types": np.asarray(f.machine_types),
            "metric_names": np.asarray(f.metric_names),
            "metric_units": np.asarray(f.metric_units),
            "node_metric_names": np.asarray(f.node_metric_names),
            "type_code": f.type_code, "machine_code": f.machine_code,
            "machine_type_code": f.machine_type_code,
            "t": f.t, "stressed": f.stressed,
            "metrics": f.metrics, "metrics_present": f.metrics_present,
            "node_metrics": f.node_metrics,
            "node_metrics_present": f.node_metrics_present,
            "row_id": self.row_id, "anomaly": self.anomaly,
        }
        if self._codes is not None:
            payload["codes"] = self.codes
        if self._features is not None:
            for k in FEATURE_KEYS:
                payload[f"feat_{k}"] = self.features[k]
        atomic_savez(path, **payload)

    @classmethod
    def load(cls, path: str) -> "FingerprintStore":
        with np.load(path, allow_pickle=False) as z:
            store = cls()
            store._next_id = int(z["next_id"])
            if bool(z["empty"]):
                return store

            def names(key):
                return [str(x) for x in z[key]]

            store._btypes = names("benchmark_types")
            store._machines = names("machines")
            store._mtypes = names("machine_types")
            store._cols = list(zip(names("metric_names"),
                                   names("metric_units")))
            store._ncols = names("node_metric_names")
            store._bidx = {b: i for i, b in enumerate(store._btypes)}
            store._midx = {m: i for i, m in enumerate(store._machines)}
            store._tidx = {m: i for i, m in enumerate(store._mtypes)}
            store._cidx = {c: i for i, c in enumerate(store._cols)}
            store._nidx = {k: i for i, k in enumerate(store._ncols)}
            store._type_code = z["type_code"].copy()
            store._machine_code = z["machine_code"].copy()
            store._machine_type_code = z["machine_type_code"].copy()
            store._t = z["t"].copy()
            store._stressed = z["stressed"].copy()
            store._metrics = z["metrics"].copy()
            store._metrics_present = z["metrics_present"].copy()
            store._node_metrics = z["node_metrics"].copy()
            store._node_metrics_present = \
                z["node_metrics_present"].copy()
            store._row_id = z["row_id"].copy()
            store._anomaly = z["anomaly"].copy()
            if "codes" in z.files:
                store._codes = z["codes"].copy()
            if f"feat_{FEATURE_KEYS[0]}" in z.files:
                store._features = {k: z[f"feat_{k}"].copy()
                                   for k in FEATURE_KEYS}
            store._has_features = store._features is not None
            store._n = store._cap = len(store._t)
            store._ids_sorted = bool(
                np.all(np.diff(store._row_id) >= 0))
            store._rebuild_chains()
            return store
