"""Long-lived streaming ingestion daemon over the fleet service.

The PyTorch port's copy of ``repro/fleet/ingest.py``: all host code; the
scoring happens in the service it drives
(:class:`repro_torch.fleet.service.FleetScoringService`).

``IngestionDaemon`` turns the closed-loop :class:`FleetScoringService`
into a production pipeline: telemetry events (per-node benchmark
rounds, see :class:`repro_torch.fleet.faults.TelemetryEvent`) arrive by push
(:meth:`push`) or from poll sources, are deduplicated, validated and
staged in a **bounded ring buffer**, and are flushed through the
service on either of two triggers — a time deadline (no staged row
waits longer than ``flush_interval``) or the row threshold
(``flush_rows``, a power of two so flushes land on the service's
pow2 row buckets). Per-flush results fold into an **incremental**
:class:`repro_torch.fleet.drift.RollingDrift` (O(new rows) per flush — no
full-history recompute), so degradation flags are always current.

Backpressure ladder (explicit, counted, in escalation order):

1. **block** — an arrival that would overflow the ring forces an
   immediate flush (the producer blocks until the consumer drains);
   counted in ``blocked_events`` / ``forced_flushes``.
2. **shed oldest per chain** — if the consumer is not allowed to run
   yet (``min_flush_gap`` models scorer capacity), the oldest staged
   rows of every (node x benchmark type) chain are dropped down to the
   largest per-chain depth that fits; newest telemetry survives.
   Counted in ``shed_rows``.
3. **degrade to sampled scoring** — sustained overload (``degrade_after``
   block/shed incidents within one flush window) switches flushes to
   scoring only the newest ``degrade_sample_per_chain`` rows per chain;
   the rest are still appended to the store (durable, usable as
   context) but unscored. ``recover_after`` consecutive clean windows
   exit degraded mode. Counted in ``degraded_flushes`` /
   ``degrade_unscored_rows``.

The daemon runs on an explicit clock. :meth:`run` drives it from an
event list in *virtual time*: the clock advances to each arrival, and
every flush advances it further by the **measured** wall-clock scoring
duration (``service_time_scale``) — so queue latencies (and their p99)
reflect real consumer capacity under the injected arrival process,
reproducibly. :meth:`serve` runs the same loop against the wall clock
in a background thread for live deployments (``launch.serve --daemon``).

Shutdown is crash-safe: :meth:`close` either drains (flushes every
staged row through the scorer) or checkpoints the staging buffer to an
atomically-written ``.npz`` (:func:`repro_torch.fleet.store.atomic_savez`);
:func:`load_staging` restores the checkpoint as events for a fresh
daemon, so no accepted telemetry is ever lost to a restart.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.common.bucketing import next_pow2
from repro_torch.fingerprint.frame import BenchmarkFrame, concat_frames
from repro_torch.fleet.drift import RollingDrift, degrading_nodes
from repro_torch.fleet.faults import TelemetryEvent
from repro_torch.fleet.store import atomic_savez
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.dispatch import instance_site


@dataclasses.dataclass
class _Staged:
    """One staged telemetry event (rows may shrink under shedding)."""

    uid: int
    node: str
    arrival: float  # event arrival time (queue-latency origin)
    staged_at: float  # time it entered the ring (deadline origin)
    frame: BenchmarkFrame


class IngestionDaemon:
    """Bounded-staging streaming front-end of the fleet service."""

    def __init__(self, service, *,
                 capacity_rows: int = 1024,
                 flush_interval: float = 60.0,
                 flush_rows: Optional[int] = None,
                 min_flush_gap: float = 0.0,
                 degrade_after: int = 3,
                 recover_after: int = 2,
                 degrade_sample_per_chain: int = 1,
                 service_time_scale: float = 1.0,
                 drift_alpha: float = 0.3,
                 dedup_window: int = 4096,
                 max_latencies: int = 100_000,
                 tracer: Optional[obs_trace.Tracer] = None):
        if capacity_rows <= 0:
            raise ValueError("capacity_rows must be positive")
        self.service = service
        self.capacity_rows = capacity_rows
        self.flush_interval = flush_interval
        # row trigger: a power of two <= capacity, aligned with the
        # service's pow2 row buckets so full flushes pad minimally
        self.flush_rows = (next_pow2(max(capacity_rows // 2, 1), 1)
                           if flush_rows is None else flush_rows)
        self.min_flush_gap = min_flush_gap
        self.degrade_after = degrade_after
        self.recover_after = recover_after
        self.degrade_sample_per_chain = degrade_sample_per_chain
        self.service_time_scale = service_time_scale
        self.drift = RollingDrift(alpha=drift_alpha)
        self.now = 0.0
        self._staged: List[_Staged] = []
        self._staged_rows = 0
        self._last_flush = 0.0
        self._seen_uids: set = set()
        self._uid_order: collections.deque = collections.deque(
            maxlen=dedup_window)
        self._next_push_uid = -1  # push() uids count down: no clash
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._sources: List[Callable[[float],
                                     Sequence[TelemetryEvent]]] = []
        # flush hooks: called under the lock right after scoring, and
        # BEFORE the results feed rolling drift / the results log —
        # a hook may mutate the results dict in place (the model
        # plane's rollback repair swaps bad-candidate scores for the
        # incumbent's before anything downstream sees them)
        self._flush_hooks: List[Callable[[Dict[str, object], str],
                                         None]] = []
        self._results: Dict[str, List] = {}
        self._closed = False
        self.degraded = False
        self._overload_in_window = 0
        self._clean_windows = 0
        # counters (all exposed via stats())
        self._events_seen = 0
        self._events_accepted = 0
        self._rows_staged_total = 0
        self._duplicates_dropped = 0
        self._blocked_events = 0
        self._forced_flushes = 0
        self._deadline_flushes = 0
        self._row_trigger_flushes = 0
        self._drain_flushes = 0
        self._shed_rows = 0
        self._degraded_flushes = 0
        self._degrade_unscored_rows = 0
        self._degrade_entries = 0
        self._recoveries = 0
        self._flush_failures = 0
        self._peak_staged_rows = 0
        self._flush_wall_s = 0.0
        self._run_wall_s = 0.0
        # --- telemetry plane ---------------------------------------
        # The daemon owns a tracer on its OWN clock (``self.now``):
        # virtual time under run(), wall time under serve() — flush
        # spans and ladder instants line up with the latencies the
        # daemon reports in either mode. Program-logic counters above
        # stay plain ints (they must survive obs.disable()); the
        # registry rows below are observability mirrors, delta-synced
        # at flush boundaries (``_sync_mirrors``) so intake itself
        # never pays per-event registry cost.
        self.site = instance_site("fleet.ingest")
        self.tracer = (tracer if tracer is not None
                       else obs_trace.Tracer(clock=lambda: self.now))
        reg = obs_metrics.registry()
        self._m_events = reg.counter("ingest.events_seen",
                                     daemon=self.site)
        self._m_accepted = reg.counter("ingest.events_accepted",
                                       daemon=self.site)
        self._m_rows = reg.counter("ingest.rows_staged",
                                   daemon=self.site)
        self._m_dups = reg.counter("ingest.duplicates_dropped",
                                   daemon=self.site)
        self._m_flushes = reg.counter("ingest.flushes",
                                      daemon=self.site)
        self._m_ladder = {
            step: reg.counter("ingest.ladder", step=step,
                              daemon=self.site)
            for step in ("block", "shed", "degrade", "recover")}
        # queue latency (arrival -> scoring flush) through the shared
        # streaming histogram: exact np.quantile semantics up to
        # ``max_latencies`` samples (the old deque window), O(1)
        # log-bucket memory beyond
        self._latency = reg.histogram("ingest.queue_latency_s",
                                      exact_limit=max_latencies,
                                      daemon=self.site)

    # ------------------------------------------------------------- intake
    def push(self, frame: BenchmarkFrame, *, now: Optional[float] = None,
             node: str = "", uid: Optional[int] = None) -> bool:
        """Push-mode intake of one telemetry frame; returns False when
        the row was dropped (duplicate) rather than staged. Thread-safe
        (the live-serving producer API)."""
        with self._lock:
            t = self.now if now is None else now
            if uid is None:
                uid = self._next_push_uid
                self._next_push_uid -= 1
            return self.offer(TelemetryEvent(uid=uid, node=node,
                                             arrival=t, frame=frame),
                              now=t)

    def attach_source(self, poll: Callable[[float],
                                           Sequence[TelemetryEvent]]
                      ) -> None:
        """Register a poll source: ``poll(now)`` returns the events
        that arrived since the last poll (drained by :meth:`serve`'s
        loop or an explicit :meth:`poll_sources`)."""
        self._sources.append(poll)

    def poll_sources(self, now: Optional[float] = None) -> int:
        """Drain every attached poll source once; returns the number
        of events offered."""
        with self._lock:
            t = self.now if now is None else now
            n = 0
            for poll in self._sources:
                for ev in poll(t):
                    self.offer(ev, now=max(t, ev.arrival))
                    n += 1
            return n

    def offer(self, event: TelemetryEvent, *,
              now: Optional[float] = None) -> bool:
        """Admit one event: dedup -> validate/quarantine -> stage,
        escalating the backpressure ladder when the ring is full.
        Returns True when (any part of) the event was staged."""
        with self._lock:
            if self._closed:
                raise RuntimeError("daemon is closed")
            if now is not None:
                self.now = max(self.now, now)
            self._events_seen += 1
            if event.uid in self._seen_uids:
                self._duplicates_dropped += 1
                return False
            self._remember_uid(event.uid)
            # validation/quarantine is the service's (shared policy +
            # counters); corrupt rows never enter the ring
            frame = self.service._admit(event.frame)
            if len(frame) == 0:
                return False
            n = len(frame)
            if self._staged_rows + n > self.capacity_rows:
                self._make_room(n)
            if self._staged_rows + n > self.capacity_rows:
                # ladder step 2: shed oldest-per-chain (incoming rows
                # participate — a flood bigger than the ring sheds too)
                frame = self._shed(frame)
                n = len(frame)
                if n == 0:
                    return False
            self._staged.append(_Staged(uid=event.uid, node=event.node,
                                        arrival=event.arrival,
                                        staged_at=self.now,
                                        frame=frame))
            self._staged_rows += n
            self._rows_staged_total += n
            self._events_accepted += 1
            self._peak_staged_rows = max(self._peak_staged_rows,
                                         self._staged_rows)
            return True

    def _sync_mirrors(self) -> None:
        """Fold the plain program-logic counters into their registry
        mirrors (delta since the last sync). Runs at flush boundaries
        only, so per-event intake pays zero registry cost — the <2%
        telemetry-overhead budget the reference's ``bench_fleet``
        asserts."""
        if not obs_metrics.enabled():
            return
        for mirror, total in (
                (self._m_events, self._events_seen),
                (self._m_accepted, self._events_accepted),
                (self._m_rows, self._rows_staged_total),
                (self._m_dups, self._duplicates_dropped)):
            delta = total - int(mirror.value)
            if delta:
                mirror.add(delta)

    def _remember_uid(self, uid: int) -> None:
        if (self._uid_order.maxlen is not None
                and len(self._uid_order) == self._uid_order.maxlen):
            self._seen_uids.discard(self._uid_order[0])
        self._uid_order.append(uid)
        self._seen_uids.add(uid)

    # -------------------------------------------------------- backpressure
    def _make_room(self, n: int) -> None:
        """Ladder step 1 (block): the producer waits for a flush —
        unless the consumer gap says the scorer is still busy."""
        if self.now - self._last_flush >= self.min_flush_gap:
            self._blocked_events += 1
            self._forced_flushes += 1
            self._m_ladder["block"].inc()
            self.tracer.instant("ladder.block", obs_trace.CAT_LADDER,
                                args={"staged_rows": self._staged_rows,
                                      "incoming": n},
                                ts=self.now)
            self._note_overload()
            self._flush(trigger="forced")

    def _shed(self, incoming: BenchmarkFrame) -> BenchmarkFrame:
        """Drop the oldest staged rows of every (node x benchmark
        type) chain down to the deepest uniform per-chain depth that
        fits ``incoming`` into the ring; the incoming frame itself is
        shed by the same rule if it alone exceeds capacity."""
        self._note_overload()
        # per-row chain keys: (node name, benchmark type name)
        keys: List[Tuple[str, str]] = []
        owners: List[int] = []
        ts: List[float] = []
        all_staged = self._staged + [
            _Staged(uid=0, node="", arrival=self.now,
                    staged_at=self.now, frame=incoming)]
        for i, s in enumerate(all_staged):
            f = s.frame
            node_of_row = (s.node if i < len(self._staged) else None)
            for j in range(len(f)):
                node = (node_of_row if node_of_row
                        else f.machines[f.machine_code[j]])
                keys.append((node, f.benchmark_types[f.type_code[j]]))
                owners.append(i)
                ts.append(float(f.t[j]))
        order = np.lexsort((np.arange(len(ts)), np.asarray(ts)))
        # newest-rank per chain: rank 0 = newest row of its chain
        rank: Dict[Tuple[str, str], int] = {}
        newest_rank = np.empty(len(ts), np.int64)
        for pos in order[::-1]:
            k = keys[pos]
            newest_rank[pos] = rank.get(k, 0)
            rank[k] = newest_rank[pos] + 1
        # deepest uniform per-chain depth that fits the ring
        keep_depth = 0
        for depth in range(1, max(rank.values(), default=0) + 1):
            if int((newest_rank < depth).sum()) <= self.capacity_rows:
                keep_depth = depth
            else:
                break
        keep = newest_rank < max(keep_depth, 1)
        if int(keep.sum()) > self.capacity_rows:
            # even one row per chain exceeds the ring: keep the
            # globally newest rows only
            newest_global = np.zeros(len(ts), bool)
            newest_global[order[-self.capacity_rows:]] = True
            keep &= newest_global
        n_shed = int((~keep).sum())
        self._shed_rows += n_shed
        self._m_ladder["shed"].inc()
        self.tracer.instant("ladder.shed", obs_trace.CAT_LADDER,
                            args={"rows": n_shed}, ts=self.now)
        owners_arr = np.asarray(owners)
        kept_staged: List[_Staged] = []
        rows_after = 0
        out_incoming = incoming.select(np.zeros(0, np.int64))
        for i, s in enumerate(all_staged):
            mask = keep[owners_arr == i]
            if mask.all():
                sub = s.frame
            else:
                sub = s.frame.select(np.nonzero(mask)[0])
            if i < len(self._staged):
                if len(sub):
                    kept_staged.append(
                        dataclasses.replace(s, frame=sub))
                    rows_after += len(sub)
            else:
                out_incoming = sub
        self._staged = kept_staged
        self._staged_rows = rows_after
        return out_incoming

    def _note_overload(self) -> None:
        self._overload_in_window += 1
        self._clean_windows = 0
        if (not self.degraded
                and self._overload_in_window >= self.degrade_after):
            self.degraded = True
            self._degrade_entries += 1
            self._m_ladder["degrade"].inc()
            self.tracer.instant(
                "ladder.degrade", obs_trace.CAT_LADDER,
                args={"overloads": self._overload_in_window},
                ts=self.now)

    # -------------------------------------------------------------- flush
    def _deadline(self) -> Optional[float]:
        if not self._staged:
            return None
        return min(s.staged_at for s in self._staged) \
            + self.flush_interval

    def advance(self, t: float) -> None:
        """Advance the clock to ``t``, firing every deadline flush
        that comes due on the way (the poll/epoch driver)."""
        with self._lock:
            while True:
                deadline = self._deadline()
                if deadline is None or deadline > t:
                    break
                self.now = max(self.now, deadline)
                self._deadline_flushes += 1
                self._end_window()
                self._flush(trigger="deadline")
            self.now = max(self.now, t)

    def _end_window(self) -> None:
        """A flush window closed: decay or clear the overload state
        (hysteresis so degraded mode doesn't flap)."""
        if self._overload_in_window == 0:
            self._clean_windows += 1
            if self.degraded and self._clean_windows >= self.recover_after:
                self.degraded = False
                self._recoveries += 1
                self._m_ladder["recover"].inc()
                self.tracer.instant(
                    "ladder.recover", obs_trace.CAT_LADDER,
                    args={"clean_windows": self._clean_windows},
                    ts=self.now)
        self._overload_in_window = 0

    def flush(self) -> Dict[str, object]:
        """Flush the staging ring through the service now (manual
        trigger); returns the per-node results of this flush."""
        with self._lock:
            return self._flush(trigger="manual")

    def add_flush_hook(self, fn: Callable[[Dict[str, object], str],
                                          None]) -> None:
        """Register a post-scoring hook ``fn(results, trigger)``, run
        under the daemon lock before the results reach rolling drift
        or the results log (so it may repair them in place). The model
        plane's canary/watch state machine attaches here — hooks run
        at every flush boundary, the only place parameter swaps
        happen."""
        self._flush_hooks.append(fn)

    def _flush(self, trigger: str) -> Dict[str, object]:
        staged, self._staged = self._staged, []
        self._staged_rows = 0
        if not staged:
            self._last_flush = self.now
            return {}
        t0 = time.perf_counter()
        start_now = self.now
        n_rows = sum(len(s.frame) for s in staged)
        was_degraded = self.degraded
        self._latency.observe_many(
            [self.now - s.arrival for s in staged])
        staged.sort(key=lambda s: float(s.frame.t.min()))
        try:
            if self.degraded:
                self._degraded_flushes += 1
                results = self._flush_degraded(staged)
            else:
                for s in staged:
                    # pre-validated at intake: don't pay validation
                    # twice
                    if len(s.frame):
                        self.service._pending.append(s.frame)
                results = self.service.flush()
        except Exception as e:  # noqa: BLE001 — pipeline must survive
            # the service already retried transient scorer failures
            # with backoff (``dispatch_retries``); a terminal failure
            # loses this flush's scores, not the pipeline: the rows
            # are already durable in the store (unscored context) and
            # the daemon keeps consuming the stream
            self._flush_failures += 1
            self.tracer.instant("ingest.flush_failed",
                                obs_trace.CAT_LADDER,
                                args={"trigger": trigger,
                                      "rows": n_rows,
                                      "error": type(e).__name__},
                                ts=self.now)
            results = {}
        for hook in self._flush_hooks:
            hook(results, trigger)
        dt = time.perf_counter() - t0
        self._flush_wall_s += dt
        self.now += dt * self.service_time_scale
        self._last_flush = self.now
        self._m_flushes.inc()
        self._sync_mirrors()
        # the span lives in the daemon's clock domain: under run() its
        # duration is the *virtual* service time this flush consumed
        self.tracer.complete("ingest.flush", obs_trace.CAT_HOST,
                             ts=start_now, dur=self.now - start_now,
                             args={"trigger": trigger, "rows": n_rows,
                                   "events": len(staged),
                                   "degraded": was_degraded})
        self.drift.update(self.service.store, results)
        for node, r in results.items():
            self._results.setdefault(node, []).append(r)
        return results

    def _flush_degraded(self, staged: Sequence[_Staged]):
        """Degraded flush: score only the newest
        ``degrade_sample_per_chain`` rows of every (node x type) chain
        in this batch; the remaining rows are appended to the store
        unscored (durable + future context, no scoring cost)."""
        frame = (concat_frames([s.frame for s in staged])
                 if len(staged) > 1 else staged[0].frame)
        key = (frame.machine_code.astype(np.int64)
               * max(len(frame.benchmark_types), 1)
               + frame.type_code)
        order = np.lexsort((np.arange(len(frame)), frame.t))
        rank: Dict[int, int] = {}
        newest_rank = np.empty(len(frame), np.int64)
        for pos in order[::-1]:
            k = int(key[pos])
            newest_rank[pos] = rank.get(k, 0)
            rank[k] = newest_rank[pos] + 1
        sample = newest_rank < self.degrade_sample_per_chain
        rest = np.nonzero(~sample)[0]
        if len(rest):
            self.service.seed_history(frame.select(rest))
            self._degrade_unscored_rows += len(rest)
        sampled = frame.select(np.nonzero(sample)[0])
        if len(sampled) == 0:
            return {}
        self.service._pending.append(sampled)
        return self.service.flush()

    # ---------------------------------------------------------- run loops
    def run(self, events: Sequence[TelemetryEvent], *,
            drain: bool = True) -> Dict[str, List]:
        """Virtual-time event loop: replay ``events`` (arrival order)
        against the measured-service-time clock. Deadline flushes fire
        at their due times between arrivals; the row trigger fires the
        moment staging reaches ``flush_rows``. Returns all per-node
        results accumulated so far."""
        wall0 = time.perf_counter()
        with self._lock:
            for ev in events:
                self.advance(ev.arrival)
                self.offer(ev, now=ev.arrival)
                if self._staged_rows >= self.flush_rows:
                    self._row_trigger_flushes += 1
                    self._end_window()
                    self._flush(trigger="rows")
            if drain and self._staged:
                self._drain_flushes += 1
                self._end_window()
                self._flush(trigger="drain")
        self._run_wall_s += time.perf_counter() - wall0
        return dict(self._results)

    def serve(self, poll_interval: float = 0.05) -> None:
        """Start the wall-clock daemon thread: polls attached sources
        and fires deadline/row-trigger flushes until :meth:`close`."""
        if self._thread is not None:
            raise RuntimeError("daemon thread already running")
        self._stop.clear()
        t_start = time.monotonic()

        def loop():
            while not self._stop.is_set():
                now = time.monotonic() - t_start
                with self._lock:
                    self.poll_sources(now)
                    if self._staged_rows >= self.flush_rows:
                        self._row_trigger_flushes += 1
                        self._end_window()
                        self._flush(trigger="rows")
                    else:
                        self.advance(now)
                self._stop.wait(poll_interval)

        self._thread = threading.Thread(target=loop,
                                        name="perona-ingest",
                                        daemon=True)
        self._thread.start()

    # ----------------------------------------------------------- shutdown
    def close(self, *, drain: bool = True,
              checkpoint: Optional[str] = None) -> Dict[str, object]:
        """Crash-safe shutdown: stop the serve thread (if running),
        then either drain staged rows through the scorer or checkpoint
        them (atomic .npz) for :func:`load_staging`. Safe to call
        twice."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10.0)
            self._thread = None
        with self._lock:
            if self._closed:
                return {}
            results = {}
            if drain and self._staged:
                self._drain_flushes += 1
                results = self._flush(trigger="drain")
            elif checkpoint is not None and self._staged:
                save_staging(checkpoint, self._staged)
                self._staged = []
                self._staged_rows = 0
            self._closed = True
            return results

    # -------------------------------------------------------------- stats
    def results(self) -> Dict[str, List]:
        """All per-node flush results observed so far."""
        return dict(self._results)

    def flagged_nodes(self, ewma_threshold: float = 0.5,
                      min_scored: int = 3) -> List[str]:
        """Nodes whose rolling anomaly EWMA currently exceeds the
        threshold (the daemon-side §III-D degradation flag)."""
        return sorted(degrading_nodes(self.drift.report(),
                                      ewma_threshold=ewma_threshold,
                                      min_scored=min_scored))

    def latency_quantiles(self, qs: Sequence[float] = (0.5, 0.99)
                          ) -> Dict[str, float]:
        """Queue-latency quantiles (seconds between event arrival and
        the flush that scored it), read from the shared streaming
        histogram: exact ``np.quantile`` over the samples while under
        ``max_latencies`` observations, log-bucket estimates beyond."""
        return self._latency.quantiles(qs)

    def stats(self) -> obs_metrics.StatsDict:
        out = {
            "events_seen": self._events_seen,
            "events_accepted": self._events_accepted,
            "rows_staged_total": self._rows_staged_total,
            "staged_rows": self._staged_rows,
            "capacity_rows": self.capacity_rows,
            "peak_staged_rows": self._peak_staged_rows,
            "duplicates_dropped": self._duplicates_dropped,
            "blocked_events": self._blocked_events,
            "forced_flushes": self._forced_flushes,
            "deadline_flushes": self._deadline_flushes,
            "row_trigger_flushes": self._row_trigger_flushes,
            "drain_flushes": self._drain_flushes,
            "shed_rows": self._shed_rows,
            "degraded": self.degraded,
            "degrade_entries": self._degrade_entries,
            "degraded_flushes": self._degraded_flushes,
            "degrade_unscored_rows": self._degrade_unscored_rows,
            "recoveries": self._recoveries,
            "flush_failures": self._flush_failures,
            "scorer_retries": getattr(self.service,
                                      "_scorer_retries", 0),
            "flush_wall_s": self._flush_wall_s,
            "run_wall_s": self._run_wall_s,
            "virtual_now": self.now,
        }
        out.update({f"latency_{k}": v
                    for k, v in self.latency_quantiles().items()})
        out["service"] = self.service.stats
        return out


# --------------------------------------------------------- staging ckpt
def save_staging(path: str, staged: Sequence[_Staged]) -> None:
    """Checkpoint staged (accepted but unflushed) rows to one
    atomically-written .npz: frame columns + per-row event identity
    (uid / node / arrival), so a restart re-offers exactly what was
    in flight."""
    frames = [s.frame for s in staged]
    frame = concat_frames(frames) if len(frames) > 1 else frames[0]
    uid = np.concatenate([np.full(len(s.frame), s.uid, np.int64)
                          for s in staged])
    arrival = np.concatenate(
        [np.full(len(s.frame), s.arrival, np.float64) for s in staged])
    nodes = sum(([s.node] * len(s.frame) for s in staged), [])
    atomic_savez(
        path,
        row_uid=uid, row_arrival=arrival,
        row_node=np.asarray(nodes),
        benchmark_types=np.asarray(frame.benchmark_types),
        machines=np.asarray(frame.machines),
        machine_types=np.asarray(frame.machine_types),
        metric_names=np.asarray(frame.metric_names),
        metric_units=np.asarray(frame.metric_units),
        node_metric_names=np.asarray(frame.node_metric_names),
        type_code=frame.type_code, machine_code=frame.machine_code,
        machine_type_code=frame.machine_type_code,
        t=frame.t, stressed=frame.stressed,
        metrics=frame.metrics, metrics_present=frame.metrics_present,
        node_metrics=frame.node_metrics,
        node_metrics_present=frame.node_metrics_present)


def load_staging(path: str) -> List[TelemetryEvent]:
    """Load a staging checkpoint back into events (grouped by uid, in
    arrival order) — offer them to a fresh daemon to resume exactly
    where the crashed one stopped."""
    with np.load(path, allow_pickle=False) as z:
        def names(key):
            return tuple(str(x) for x in z[key])

        frame = BenchmarkFrame(
            benchmark_types=names("benchmark_types"),
            machines=names("machines"),
            machine_types=names("machine_types"),
            metric_names=names("metric_names"),
            metric_units=names("metric_units"),
            node_metric_names=names("node_metric_names"),
            type_code=z["type_code"], machine_code=z["machine_code"],
            machine_type_code=z["machine_type_code"],
            t=z["t"], stressed=z["stressed"],
            metrics=z["metrics"],
            metrics_present=z["metrics_present"],
            node_metrics=z["node_metrics"],
            node_metrics_present=z["node_metrics_present"])
        uid = z["row_uid"]
        arrival = z["row_arrival"]
        node = [str(x) for x in z["row_node"]]
    events = []
    for u in dict.fromkeys(uid.tolist()):  # first-appearance order
        rows = np.nonzero(uid == u)[0]
        events.append(TelemetryEvent(
            uid=int(u), node=node[rows[0]],
            arrival=float(arrival[rows[0]]),
            frame=frame.select(rows)))
    events.sort(key=lambda e: (e.arrival, e.uid))
    return events
