"""Labeled metrics registry: counters, gauges, streaming histograms (a
copy of ``repro/obs/metrics.py``, numpy only).

Instruments are keyed by ``(name, sorted labels)`` and created lazily
through :class:`MetricsRegistry` (``registry().counter("x", site="y")``
returns the same object on every call). All mutation paths are
thread-safe — the daemon's producer threads, the pipelined replay's
per-device workers and the serve loop all write into one process-wide
registry.

The whole plane can be switched off (:func:`disable`): every
``inc`` / ``set`` / ``observe`` then returns after a single attribute
check, so instrumented hot paths pay near-zero cost. The enabled-path
cost is one lock acquire per update, which is why instruments sit at
dispatch boundaries (per flush, per stacked dispatch, per block) and
never inside traced code.

Histograms keep an **exact** sample list while small
(``exact_limit``): quantiles are then literally ``np.quantile`` over
the observations (bit-identical to the ad-hoc deque quantiles they
replace). Past the limit the samples fold into base-2 log buckets —
O(1) memory forever after, quantiles accurate to the bucket width
(under 50% relative error, typically far less), with ``count`` /
``sum`` / ``min`` / ``max`` staying exact.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

#: The unified stats-dict shape shared by ``fleet.service`` and
#: ``fleet.ingest`` (counters are ints, wall times floats, nested
#: sub-dicts allowed) — one annotation for every ``stats()`` surface.
StatsDict = Dict[str, object]


class _State:
    enabled = True


_STATE = _State()


def enable() -> None:
    """Turn the telemetry plane on (the default)."""
    _STATE.enabled = True


def disable() -> None:
    """Turn the telemetry plane off: every instrument update and span
    becomes a no-op after one attribute check."""
    _STATE.enabled = False


def enabled() -> bool:
    return _STATE.enabled


@contextlib.contextmanager
def disabled() -> Iterator[None]:
    """Context manager: run the block with the plane disabled (the
    overhead benchmark / tests)."""
    prev = _STATE.enabled
    _STATE.enabled = False
    try:
        yield
    finally:
        _STATE.enabled = prev


LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_key(name: str, labels: LabelKey) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


def parse_key(key: str) -> Tuple[str, LabelKey]:
    """Inverse of the snapshot key format: ``"name{k=v,k2=v2}"`` ->
    ``("name", (("k", "v"), ("k2", "v2")))``. Label values must not
    contain ``,`` or ``=`` (they never do — see :func:`_label_key`)."""
    if key.endswith("}") and "{" in key:
        name, inner = key[:-1].split("{", 1)
        labels = tuple(tuple(kv.split("=", 1))
                       for kv in inner.split(",")) if inner else ()
        return name, labels  # type: ignore[return-value]
    return key, ()


class Counter:
    """Monotonic labeled counter (int or float increments)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if not _STATE.enabled:
            return
        with self._lock:
            self._value += n

    # float accumulation (wall seconds); same path, clearer call sites
    add = inc

    @property
    def value(self):
        return self._value

    def snapshot_value(self):
        return self._value


class Gauge:
    """Last-value labeled gauge."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        if not _STATE.enabled:
            return
        with self._lock:
            self._value = v

    @property
    def value(self):
        return self._value

    def snapshot_value(self):
        return self._value


class Histogram:
    """Streaming histogram with an exact-quantile small-N path.

    Up to ``exact_limit`` observations are kept verbatim and quantiles
    are ``np.quantile`` over them. Beyond the limit, samples fold into
    base-2 log buckets (exponent of ``math.frexp``); quantiles then
    interpolate the geometric bucket midpoint. ``count``/``sum``/
    ``min``/``max`` are exact in both regimes.
    """

    __slots__ = ("name", "labels", "exact_limit", "_exact", "_buckets",
                 "_count", "_sum", "_min", "_max", "_lock")

    # frexp exponents clamp to this symmetric range; one underflow
    # bucket (index 0) catches zeros and negatives
    _E_LO, _E_HI = -64, 64

    def __init__(self, name: str, labels: LabelKey = (),
                 exact_limit: int = 4096):
        self.name = name
        self.labels = labels
        self.exact_limit = exact_limit
        self._exact: Optional[List[float]] = []
        self._buckets: Optional[np.ndarray] = None
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def _bucket_index(self, v: float) -> int:
        if v <= 0.0 or not math.isfinite(v):
            return 0
        e = math.frexp(v)[1]  # v in [2**(e-1), 2**e)
        e = min(max(e, self._E_LO), self._E_HI)
        return e - self._E_LO + 1

    def _fold(self) -> None:
        self._buckets = np.zeros(self._E_HI - self._E_LO + 2, np.int64)
        for v in self._exact:
            self._buckets[self._bucket_index(v)] += 1
        self._exact = None

    def observe(self, v: float) -> None:
        if not _STATE.enabled:
            return
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if self._exact is not None:
                self._exact.append(v)
                if len(self._exact) > self.exact_limit:
                    self._fold()
            else:
                self._buckets[self._bucket_index(v)] += 1

    def observe_many(self, vs) -> None:
        """Batch observe under one lock round-trip (the hot-path form:
        the ingestion daemon records a whole flush's queue latencies
        in one call)."""
        if not _STATE.enabled or not vs:
            return
        with self._lock:
            for v in vs:
                v = float(v)
                self._count += 1
                self._sum += v
                self._min = min(self._min, v)
                self._max = max(self._max, v)
                if self._exact is not None:
                    self._exact.append(v)
                    if len(self._exact) > self.exact_limit:
                        self._fold()
                else:
                    self._buckets[self._bucket_index(v)] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def exact(self) -> bool:
        """True while quantiles come from the verbatim sample list."""
        return self._exact is not None

    def quantile(self, q: float) -> float:
        with self._lock:
            if self._count == 0:
                return float("nan")
            if self._exact is not None:
                return float(np.quantile(np.asarray(self._exact), q))
            # folded: walk the cumulative counts to the target rank,
            # answer with the bucket's geometric midpoint
            target = q * (self._count - 1)
            cum = 0
            for i, c in enumerate(self._buckets):
                if c == 0:
                    continue
                cum += int(c)
                if cum - 1 >= target:
                    if i == 0:
                        return min(self._min, 0.0)
                    e = i - 1 + self._E_LO  # bucket [2**(e-1), 2**e)
                    return float(math.sqrt(2.0 ** (e - 1) * 2.0 ** e))
            return self._max

    def quantiles(self, qs: Sequence[float]) -> Dict[str, float]:
        return {f"p{int(q * 100)}": self.quantile(q) for q in qs}

    def summary(self) -> Dict[str, float]:
        n = self._count
        return {
            "count": n,
            "sum": self._sum,
            "mean": self._sum / n if n else float("nan"),
            "min": self._min if n else float("nan"),
            "max": self._max if n else float("nan"),
            "p50": self.quantile(0.5),
            "p99": self.quantile(0.99),
        }

    def snapshot_value(self):
        return self.summary()


class MetricsRegistry:
    """Process-wide (or test-local) instrument registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelKey], object] = {}

    def _get(self, cls, name: str, labels: Dict[str, object],
             **kwargs):
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._metrics.get(key)
            if inst is None:
                inst = cls(name, key[1], **kwargs)
                self._metrics[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {_fmt_key(*key)} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, exact_limit: int = 4096,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels,
                         exact_limit=exact_limit)

    def snapshot(self, prefix: str = "") -> Dict[str, object]:
        """Flat ``{"name{k=v}": value}`` dict — counters/gauges as
        scalars, histograms as their summary dicts. The diagnostics
        blob benchmarks attach to each ``BENCH_*.json`` payload."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, object] = {}
        for (name, labels), inst in sorted(items,
                                           key=lambda kv: kv[0]):
            if prefix and not name.startswith(prefix):
                continue
            out[_fmt_key(name, labels)] = inst.snapshot_value()
        return out

    def render(self, prefix: str = "") -> str:
        """Human-readable text dump (the ``serve.py --metrics`` page)."""
        lines = []
        for key, val in self.snapshot(prefix).items():
            if isinstance(val, dict):
                inner = " ".join(
                    f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in val.items())
                lines.append(f"{key} {inner}")
            elif isinstance(val, float):
                lines.append(f"{key} {val:.6g}")
            else:
                lines.append(f"{key} {val}")
        return "\n".join(lines)

    def instrument_kind(self, key: str) -> Optional[str]:
        """``"counter"`` / ``"gauge"`` / ``"histogram"`` for a snapshot
        key that resolves to a live instrument, else None (stale keys
        from a historical snapshot)."""
        with self._lock:
            inst = self._metrics.get(parse_key(key))
        if inst is None:
            return None
        return type(inst).__name__.lower()

    def snapshot_delta(self, before: Dict[str, object],
                       after: Dict[str, object]
                       ) -> Dict[str, Dict[str, object]]:
        """Typed diff of two :meth:`snapshot` dicts (``before`` ->
        ``after``): each key maps to ``{"kind", "before", "after",
        "delta"}`` where **counters** diff (missing side counts as 0,
        so instruments created between the snapshots still diff
        cleanly), **gauges** carry the last value (``delta`` is None —
        a gauge is not a rate), and **histogram** summaries diff their
        exact ``count``/``sum`` and carry the last quantiles. Types
        come from the live instrument when the key resolves in this
        registry; for stale keys (snapshots loaded from an old
        ``BENCH_*.json`` in another process) dict values are
        histograms and scalars default to counter semantics — the
        conservative choice for the regression-attribution pass, which
        only acts on positive counter deltas.
        """
        out: Dict[str, Dict[str, object]] = {}
        for key in sorted(set(before) | set(after)):
            b, a = before.get(key), after.get(key)
            kind = self.instrument_kind(key)
            if kind is None:
                kind = ("histogram"
                        if isinstance(a if a is not None else b, dict)
                        else "counter")
            if kind == "histogram":
                bd = b if isinstance(b, dict) else {}
                ad = a if isinstance(a, dict) else {}
                delta = {f: ad.get(f, 0) - bd.get(f, 0)
                         for f in ("count", "sum")}
            elif kind == "gauge":
                delta = None
            else:
                delta = (a or 0) - (b or 0)
            out[key] = {"kind": kind, "before": b, "after": a,
                        "delta": delta}
        return out

    def reset(self) -> None:
        """Drop every instrument (tests/benchmark isolation)."""
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry every subsystem reports into."""
    return _REGISTRY
