"""Deterministic fault injection for fleet telemetry streams (numpy; a
copy of ``repro/fleet/faults.py``).

A production fleet never delivers the clean closed-loop rounds the
batch path assumes: nodes stall and flood on recovery, telemetry
arrives late, duplicated or reordered, collectors emit NaN/Inf-poisoned
columns, and re-fingerprinting storms burst-arrive all at once. This
module provides (a) a seeded telemetry *source* that turns the suite
simulator into a stream of per-node :class:`TelemetryEvent` rounds —
including genuinely degraded nodes whose metrics shift through the
same ChaosMesh-style stress response the Perona model was trained on —
and (b) a seeded, composable fault *injector* (:func:`inject_faults`)
that perturbs any such event stream.

Every stochastic decision is a pure function of a
``common.rng.folded_generator`` path ``(seed, STREAM_FAULTS, kind,
uid)``: two injectors with equal plans over equal streams produce
identical faults, independent of call order — which is what lets the
tests assert exact row-level outcomes (dedup keeps the store exact,
quarantine catches every corrupted row) and lets ``bench_fleet``
re-create identical bursty arrival processes across runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.common.rng import (STREAM_ARRIVALS, STREAM_FAULTS,
                                    folded_generator)
from repro_torch.fingerprint.frame import BenchmarkFrame

DAY = 86400.0


@dataclasses.dataclass(frozen=True)
class TelemetryEvent:
    """One node's benchmark round in flight to the ingestion daemon.

    ``arrival`` is the time the round reaches the daemon (the ingest
    clock); the telemetry timestamps inside ``frame.t`` are the
    benchmark execution times and live on their own (day-scale) axis —
    a stalled node's rounds keep their original execution timestamps
    while arriving late. Duplicated events share a ``uid``; the daemon
    dedups on it.
    """

    uid: int
    node: str
    arrival: float
    frame: BenchmarkFrame


# ---------------------------------------------------------------- source
def fleet_telemetry(machines: Mapping[str, str], *, rounds: int,
                    runs_per_type: int = 1, seed: int = 0,
                    interval: float = 1.0, jitter: float = 0.0,
                    t0: float = DAY, day: float = DAY,
                    degraded: Optional[Mapping[str, int]] = None
                    ) -> List[TelemetryEvent]:
    """Seeded per-node telemetry stream: ``rounds`` re-fingerprinting
    rounds of every node in ``machines``, one event per (node, round),
    arriving ``interval`` apart (plus per-event exponential ``jitter``).

    Telemetry timestamps start at ``t0`` and advance one ``day`` per
    round (streaming rounds land after any seeded history, the fleet
    cadence). ``degraded`` maps node -> first degraded round: from that
    round on, every one of the node's runs is stressed through the
    tool simulators' stress response — *injected degradation* that the
    trained model can actually detect (paper §III-D), not a synthetic
    label flip.
    """
    from repro_torch.fingerprint.runner import SuiteRunner

    runner = SuiteRunner(seed=seed)
    degraded = dict(degraded or {})
    node_order = sorted(machines)
    events: List[TelemetryEvent] = []
    uid = 0
    for k in range(rounds):
        bad = [n for n, start in degraded.items() if k >= start]
        frame = runner.run_frame(dict(machines),
                                 runs_per_type=runs_per_type,
                                 degraded_machines=bad,
                                 t_offset=t0 + k * day)
        for node in node_order:
            code = frame.machines.index(node)
            sub = frame.select(
                np.nonzero(frame.machine_code == code)[0])
            arrival = k * interval
            if jitter:
                rng = folded_generator(seed, STREAM_ARRIVALS, k, node)
                arrival += float(rng.exponential(jitter))
            events.append(TelemetryEvent(uid=uid, node=node,
                                         arrival=arrival, frame=sub))
            uid += 1
    events.sort(key=lambda e: (e.arrival, e.uid))
    return events


# -------------------------------------------------------------- injector
@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded fault mix applied over a telemetry stream. All rates are
    per-event probabilities; every decision folds ``(seed,
    STREAM_FAULTS, kind, uid)`` so equal plans replay identically."""

    seed: int = 0
    # node dropout: the round is lost entirely
    dropout: float = 0.0
    # node stall: events of `node` with arrival inside [start, end)
    # are held and flood in together at `end` (recovery burst)
    stalls: Tuple[Tuple[str, float, float], ...] = ()
    # delayed rounds: arrival += Exp(delay_scale)
    delay: float = 0.0
    delay_scale: float = 1.0
    # duplicated rounds: a copy with the same uid arrives later
    duplicate: float = 0.0
    duplicate_delay: float = 0.5
    # reordered rounds: arrival -= U(0, reorder_window) (may jump
    # ahead of earlier telemetry)
    reorder: float = 0.0
    reorder_window: float = 1.0
    # corrupted rounds: a subset of rows gets NaN/Inf metric columns
    corrupt: float = 0.0
    corrupt_cols: int = 3
    corrupt_rows: float = 0.6  # fraction of the event's rows (>= 1)
    # burst storms: all arrivals inside a struck window collapse to
    # the window's end and land simultaneously
    burst: float = 0.0
    burst_window: float = 4.0


@dataclasses.dataclass
class FaultLog:
    """Exact record of what the injector did (uids per fault kind) —
    the ground truth the robustness tests assert against."""

    dropped: List[int] = dataclasses.field(default_factory=list)
    stalled: List[int] = dataclasses.field(default_factory=list)
    delayed: List[int] = dataclasses.field(default_factory=list)
    duplicated: List[int] = dataclasses.field(default_factory=list)
    reordered: List[int] = dataclasses.field(default_factory=list)
    corrupted: Dict[int, int] = dataclasses.field(default_factory=dict)
    burst_windows: List[int] = dataclasses.field(default_factory=list)

    @property
    def corrupted_rows(self) -> int:
        return sum(self.corrupted.values())

    def counts(self) -> Dict[str, int]:
        return {"dropped": len(self.dropped),
                "stalled": len(self.stalled),
                "delayed": len(self.delayed),
                "duplicated": len(self.duplicated),
                "reordered": len(self.reordered),
                "corrupted_events": len(self.corrupted),
                "corrupted_rows": self.corrupted_rows,
                "burst_windows": len(self.burst_windows)}


def corrupt_frame(frame: BenchmarkFrame, rng: np.random.Generator,
                  n_cols: int, row_fraction: float
                  ) -> Tuple[BenchmarkFrame, int]:
    """Poison a copy of ``frame``: pick ``n_cols`` present metric
    columns and a row subset (at least one row) and overwrite the
    present cells with NaN/+Inf/-Inf. Returns (frame, corrupted rows).
    Only *present* cells are touched, so validation can see exactly
    the poisoned values a broken collector would emit."""
    n = len(frame)
    if n == 0:
        return frame, 0
    n_rows = max(1, int(round(row_fraction * n)))
    rows = np.sort(rng.choice(n, size=n_rows, replace=False))
    metrics = frame.metrics.copy()
    hit = np.zeros(n, bool)
    present_cols = np.nonzero(frame.metrics_present[rows].any(0))[0]
    cols = rng.choice(present_cols,
                      size=min(n_cols, len(present_cols)),
                      replace=False)
    poison = np.asarray([np.nan, np.inf, -np.inf])
    for c in cols:
        cells = rows[frame.metrics_present[rows, c]]
        metrics[cells, c] = rng.choice(poison, size=len(cells))
        hit[cells] = True
    return dataclasses.replace(frame, metrics=metrics), int(hit.sum())


def inject_faults(events: Sequence[TelemetryEvent], plan: FaultPlan
                  ) -> Tuple[List[TelemetryEvent], FaultLog]:
    """Apply ``plan`` over an event stream; returns the perturbed
    stream (sorted by new arrival) and the exact :class:`FaultLog`.
    Composable: the output is a plain event list, so injectors chain
    and any source (synthetic or recorded) can be perturbed."""
    log = FaultLog()
    out: List[TelemetryEvent] = []
    for ev in events:
        rng = folded_generator(plan.seed, STREAM_FAULTS, "event",
                               ev.uid)
        if plan.dropout and rng.random() < plan.dropout:
            log.dropped.append(ev.uid)
            continue
        arrival = ev.arrival
        frame = ev.frame
        for node, start, end in plan.stalls:
            if ev.node == node and start <= arrival < end:
                arrival = end
                log.stalled.append(ev.uid)
        if plan.delay and rng.random() < plan.delay:
            arrival += float(rng.exponential(plan.delay_scale))
            log.delayed.append(ev.uid)
        if plan.reorder and rng.random() < plan.reorder:
            arrival = max(0.0,
                          arrival - rng.uniform(0, plan.reorder_window))
            log.reordered.append(ev.uid)
        if plan.corrupt and rng.random() < plan.corrupt:
            frame, n_bad = corrupt_frame(frame, rng, plan.corrupt_cols,
                                         plan.corrupt_rows)
            log.corrupted[ev.uid] = n_bad
        out.append(dataclasses.replace(ev, arrival=arrival,
                                       frame=frame))
        if plan.duplicate and rng.random() < plan.duplicate:
            dup_arrival = arrival + float(
                rng.exponential(plan.duplicate_delay))
            out.append(dataclasses.replace(ev, arrival=dup_arrival,
                                           frame=frame))
            log.duplicated.append(ev.uid)
    if plan.burst:
        horizon = max((e.arrival for e in out), default=0.0)
        n_windows = int(horizon / plan.burst_window) + 1
        struck = []
        for w in range(n_windows):
            wrng = folded_generator(plan.seed, STREAM_FAULTS,
                                    "burst", w)
            if wrng.random() < plan.burst:
                struck.append(w)
        if struck:
            struck_set = set(struck)
            log.burst_windows.extend(struck)
            patched = []
            for ev in out:
                w = int(ev.arrival / plan.burst_window)
                if w in struck_set:
                    ev = dataclasses.replace(
                        ev, arrival=(w + 1) * plan.burst_window)
                patched.append(ev)
            out = patched
    out.sort(key=lambda e: (e.arrival, e.uid))
    return out, log
