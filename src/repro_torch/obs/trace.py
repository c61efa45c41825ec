"""Span-based tracing with an injectable clock (a copy of
``repro/obs/trace.py``).

A :class:`Tracer` records *complete* spans (name, category, start,
duration, thread) and instant markers into a bounded ring. The clock is
injectable so timelines are honest in both of the repo's time domains:
the process-wide tracer (:func:`tracer`) runs on
``time.perf_counter`` wall time, while the ``IngestionDaemon`` owns a
private tracer whose clock reads the daemon's ``now`` — virtual time
under ``run()`` (arrivals + measured scoring durations), wall time
under ``serve()`` — so queue/flush spans line up with the latencies
the daemon actually reports.

Span categories make host work vs device dispatch explicit:
``CAT_HOST`` for python/numpy table building and staging,
``CAT_DEVICE`` for compiled-dispatch boundaries, ``CAT_LADDER`` for
backpressure-ladder transitions. ``events()`` hands the recording to
a reader; the port has no Chrome trace-event exporter yet.

Recording is a no-op while the plane is disabled
(``obs.disable()``) — the ``span`` context manager yields immediately
without reading the clock.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

from repro_torch.obs import metrics

CAT_HOST = "host"
CAT_DEVICE = "device"
CAT_LADDER = "ladder"
CAT_PLANE = "plane"  # model-plane lifecycle (canary/promote/rollback)

#: Chrome trace-event phases used by the recorder.
PH_COMPLETE = "X"
PH_INSTANT = "i"


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One recorded event, timestamps in the tracer's clock domain
    (seconds; ``dur`` is 0 for instants)."""

    name: str
    cat: str
    ts: float
    dur: float
    tid: int
    thread: str
    ph: str = PH_COMPLETE
    args: Optional[Dict[str, object]] = None


class Tracer:
    """Bounded-ring span recorder over an injectable clock."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 max_events: int = 200_000):
        self._clock = clock if clock is not None else time.perf_counter
        self._events: collections.deque = collections.deque(
            maxlen=max_events)
        self._lock = threading.Lock()
        self._dropped = 0

    # ---------------------------------------------------------- clock
    def set_clock(self, clock: Callable[[], float]) -> None:
        self._clock = clock

    def now(self) -> float:
        return self._clock()

    # ------------------------------------------------------ recording
    def _record(self, ev: SpanEvent) -> None:
        with self._lock:
            if (self._events.maxlen is not None
                    and len(self._events) == self._events.maxlen):
                self._dropped += 1
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = CAT_HOST,
             args: Optional[Dict[str, object]] = None) -> Iterator[None]:
        """Record the block as one complete span on the current
        thread. No-op (not even a clock read) when the plane is
        disabled."""
        if not metrics.enabled():
            yield
            return
        t0 = self._clock()
        try:
            yield
        finally:
            t1 = self._clock()
            th = threading.current_thread()
            self._record(SpanEvent(name=name, cat=cat, ts=t0,
                                   dur=max(t1 - t0, 0.0),
                                   tid=th.ident, thread=th.name,
                                   args=args))

    def complete(self, name: str, cat: str, ts: float, dur: float,
                 args: Optional[Dict[str, object]] = None) -> None:
        """Record a complete span with explicit timestamps — for
        callers whose span boundaries live in their own clock domain
        (the daemon's virtual flush windows)."""
        if not metrics.enabled():
            return
        th = threading.current_thread()
        self._record(SpanEvent(name=name, cat=cat, ts=ts,
                               dur=max(dur, 0.0), tid=th.ident,
                               thread=th.name, args=args))

    def instant(self, name: str, cat: str = CAT_HOST,
                args: Optional[Dict[str, object]] = None,
                ts: Optional[float] = None) -> None:
        """Record a zero-duration marker (ladder transitions, faults)."""
        if not metrics.enabled():
            return
        th = threading.current_thread()
        self._record(SpanEvent(name=name, cat=cat,
                               ts=self._clock() if ts is None else ts,
                               dur=0.0, tid=th.ident, thread=th.name,
                               ph=PH_INSTANT, args=args))

    # -------------------------------------------------------- reading
    def events(self) -> List[SpanEvent]:
        """Snapshot copy of the recorded events (recording order)."""
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        """Events evicted from the ring since the last clear."""
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-wide wall-clock tracer."""
    return _TRACER


def span(name: str, cat: str = CAT_HOST,
         args: Optional[Dict[str, object]] = None):
    """``tracer().span(...)`` shorthand for call sites."""
    return _TRACER.span(name, cat=cat, args=args)
