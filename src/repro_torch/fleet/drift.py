"""Store-backed degradation analytics (paper §III-C / §III-D).

Perona's context-aware scoring flags single anomalous executions; what
an operator acts on is the *trend*: is a node's anomaly probability
drifting up round over round, and on which resource aspect? This
module derives exactly that from the :class:`FingerprintStore` — a
per-node EWMA over the chronological series of attached anomaly
scores, and per-(node x aspect) EWMAs over the §III-D code quality
scores (``core.ranking.code_scores``, aspects via ``ASPECT_OF_TYPE``)
— replacing the watchdog's ad-hoc frame-history bookkeeping with a
queryable analytics layer over durable history.

Only rows with attached scores participate (NaN = never scored);
series are ordered by (t, row id), matching the store's view order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.ranking import ASPECT_OF_TYPE, code_scores
from repro_torch.fleet.store import FingerprintStore


class EwmaMean:
    """THE drift fold, extracted so every trend consumer shares one
    set of semantics: ``e_0 = x_0``, ``e_i = (1-a) e_{i-1} + a x_i``,
    alongside the lifetime mean (the drift baseline). This is exactly
    the per-node/per-aspect state :class:`RollingDrift` keeps per
    flush, and what ``obs.regress`` folds over benchmark-history
    series — so a perf-gate baseline and a fleet-drift baseline are
    the same computation."""

    __slots__ = ("alpha", "ewma", "total", "n")

    def __init__(self, alpha: float):
        self.alpha = alpha
        self.ewma: Optional[float] = None  # None until first update
        self.total = 0.0
        self.n = 0

    def update(self, v) -> None:
        """Fold one observation (first observation seeds the EWMA)."""
        a = self.alpha
        self.ewma = (v if self.ewma is None
                     else (1.0 - a) * self.ewma + a * v)
        self.total += v
        self.n += 1

    def fold(self, xs) -> "EwmaMean":
        """Fold a whole series (float64, in order); returns self."""
        for v in np.asarray(xs, np.float64):
            self.update(v)
        return self

    @property
    def mean(self) -> float:
        """Lifetime mean of everything folded so far."""
        return self.total / self.n if self.n else float("nan")


def ewma_series(x: np.ndarray, alpha: float) -> np.ndarray:
    """Full exponentially-weighted moving average series:
    e_0 = x_0, e_i = (1-alpha) * e_{i-1} + alpha * x_i."""
    x = np.asarray(x, np.float64)
    out = np.empty_like(x)
    if len(x) == 0:
        return out
    acc = x[0]
    for i, v in enumerate(x):
        acc = (1.0 - alpha) * acc + alpha * v
        out[i] = acc
    out[0] = x[0]
    return out


def ewma_last(x: np.ndarray, alpha: float) -> float:
    """Final EWMA value (the :class:`EwmaMean` fold of
    :func:`ewma_series`, without materializing the series)."""
    return float(EwmaMean(alpha).fold(x).ewma)


@dataclasses.dataclass
class NodeDrift:
    """Degradation summary of one node over its stored history."""

    node: str
    n_scored: int
    anomaly_ewma: float  # current EWMA of anomaly probability
    anomaly_mean: float  # lifetime mean (drift baseline)
    aspect_ewma: Dict[str, float]  # cpu/memory/disk/network quality
    aspect_mean: Dict[str, float]
    last_t: float

    @property
    def drift(self) -> float:
        """EWMA minus lifetime mean: > 0 means anomaly probability is
        trending above the node's own baseline."""
        return self.anomaly_ewma - self.anomaly_mean

    def degraded_aspects(self, rel_drop: float = 0.2) -> Dict[str, float]:
        """Aspects whose current quality EWMA dropped at least
        ``rel_drop`` (fraction) below the lifetime mean."""
        out = {}
        for a, e in self.aspect_ewma.items():
            m = self.aspect_mean[a]
            if m > 0 and (m - e) / m >= rel_drop:
                out[a] = (m - e) / m
        return out


def drift_report(store: FingerprintStore, alpha: float = 0.3,
                 node: Optional[str] = None) -> Dict[str, NodeDrift]:
    """Per-node drift summaries over the stored, scored history."""
    frame = store.frame
    if frame is None:
        return {}
    anomaly = store.anomaly
    scored = ~np.isnan(anomaly)
    codes = store.codes
    has_codes = (np.zeros(len(frame), bool) if codes is None
                 else ~np.isnan(codes).any(axis=1))
    # quality scores only where codes were attached (never-scored rows
    # are filtered out anyway — don't pay code_scores for them)
    quality = np.full(len(frame), np.nan)
    coded_rows = np.nonzero(has_codes)[0]
    if len(coded_rows):
        quality[coded_rows] = code_scores(codes[coded_rows])
    aspect_of_code = {b: ASPECT_OF_TYPE.get(name)
                      for b, name in enumerate(frame.benchmark_types)}

    out: Dict[str, NodeDrift] = {}
    for m_code in np.unique(frame.machine_code[scored]):
        name = frame.machines[m_code]
        if node is not None and name != node:
            continue
        sel = np.nonzero((frame.machine_code == m_code) & scored)[0]
        sel = sel[np.lexsort((store.row_id[sel], frame.t[sel]))]
        series = anomaly[sel].astype(np.float64)
        aspect_ewma: Dict[str, float] = {}
        aspect_mean: Dict[str, float] = {}
        with_codes = sel[has_codes[sel]]
        if len(with_codes):
            aspects = np.asarray(
                [aspect_of_code[b] or ""
                 for b in frame.type_code[with_codes]])
            for a in sorted(set(aspects) - {""}):
                q = quality[with_codes[aspects == a]]
                aspect_ewma[a] = ewma_last(q, alpha)
                aspect_mean[a] = float(q.mean())
        out[name] = NodeDrift(
            node=name, n_scored=len(sel),
            anomaly_ewma=ewma_last(series, alpha),
            anomaly_mean=float(series.mean()),
            aspect_ewma=aspect_ewma, aspect_mean=aspect_mean,
            last_t=float(frame.t[sel[-1]]))
    return out


class RollingDrift:
    """Incremental per-flush drift state: the same per-node anomaly
    EWMA / lifetime mean and per-aspect quality EWMAs as
    :func:`drift_report`, folded forward O(new rows) per flush instead
    of recomputed over the stored history — the long-lived ingestion
    daemon's drift path. When every scored row is fed through
    :meth:`update` in the store's (t, row) order (the streaming
    cadence), :meth:`report` is equal to ``drift_report(store)``
    (asserted in ``tests/test_ingest.py``)."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self._nodes: Dict[str, dict] = {}

    def observe(self, node: str, t_last: float, probs: np.ndarray,
                aspects: Sequence[Optional[str]],
                quality: np.ndarray) -> None:
        """Fold one flush's new scored rows (chronological) for one
        node into the running state. ``aspects``/``quality`` are
        row-aligned with ``probs``; rows with aspect ``None`` update
        only the anomaly series."""
        st = self._nodes.setdefault(
            node, {"acc": EwmaMean(self.alpha), "last_t": t_last,
                   "aspects": {}})
        st["acc"].fold(probs)
        st["last_t"] = max(st["last_t"], t_last)
        for asp, q in zip(aspects, np.asarray(quality, np.float64)):
            if asp is None:
                continue
            st["aspects"].setdefault(
                asp, EwmaMean(self.alpha)).update(q)

    def update(self, store: FingerprintStore, results) -> None:
        """Fold a flush's results (``{node: FleetResult}``) into the
        running state; aspect/quality columns are derived from the
        store rows the results point at (row ids -> benchmark types ->
        aspects, codes -> §III-D quality scores)."""
        frame = store.frame
        if frame is None:
            return
        row_id = store.row_id
        order = None
        if not bool(np.all(np.diff(row_id) >= 0)):
            order = np.argsort(row_id)  # compacted stores only
        for node in sorted(results):
            r = results[node]
            if len(r.row_ids) == 0:
                continue
            if order is None:
                idx = np.searchsorted(row_id, r.row_ids)
            else:
                idx = order[np.searchsorted(row_id[order], r.row_ids)]
            aspects = [ASPECT_OF_TYPE.get(frame.benchmark_types[c])
                       for c in frame.type_code[idx]]
            # float32 codes, like the store keeps them: bit-equal to
            # what drift_report computes over the attached history
            quality = code_scores(np.asarray(r.codes, np.float32))
            self.observe(node, float(frame.t[idx].max()),
                         r.anomaly_prob, aspects, quality)

    def report(self) -> Dict[str, NodeDrift]:
        """Current state as :class:`NodeDrift` summaries (same shape
        as :func:`drift_report`'s)."""
        out: Dict[str, NodeDrift] = {}
        for node, st in self._nodes.items():
            acc = st["acc"]
            if acc.n == 0:
                continue
            out[node] = NodeDrift(
                node=node, n_scored=acc.n,
                anomaly_ewma=float(acc.ewma),
                anomaly_mean=acc.mean,
                aspect_ewma={a: float(s.ewma)
                             for a, s in st["aspects"].items()},
                aspect_mean={a: s.mean
                             for a, s in st["aspects"].items()},
                last_t=st["last_t"])
        return out


def degrading_nodes(report: Dict[str, NodeDrift],
                    ewma_threshold: float = 0.5,
                    min_scored: int = 3) -> Dict[str, NodeDrift]:
    """Nodes whose anomaly EWMA currently exceeds the threshold (with
    at least ``min_scored`` scored executions of history)."""
    return {n: d for n, d in report.items()
            if d.n_scored >= min_scored
            and d.anomaly_ewma >= ewma_threshold}


def degradation_factors(report: Dict[str, NodeDrift],
                        rel_drop: float = 0.2
                        ) -> Dict[str, Dict[str, float]]:
    """Per-node relative quality drops, {node: {aspect: fraction}}:
    each node's aspects whose quality EWMA fell at least ``rel_drop``
    below its lifetime mean. ``optimizer.scenarios.condition_from_drift``
    aggregates these into degraded-fleet search scenarios."""
    out = {}
    for node, d in report.items():
        degraded = d.degraded_aspects(rel_drop)
        if degraded:
            out[node] = degraded
    return out
