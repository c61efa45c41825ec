"""Chrome trace-event export + schema validation (a copy of
``repro/obs/timeline.py``).

:func:`chrome_trace` turns a tracer's recorded spans into the Chrome
trace-event JSON format (the ``{"traceEvents": [...]}`` flavor), which
loads directly in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``: one process, one named track per originating
thread, complete ``X`` events for spans and ``i`` instants for
markers, span categories preserved in ``cat``.

Timestamps are microseconds relative to the earliest recorded event,
so virtual-clock timelines (the daemon's ``run()``) and wall-clock
timelines render identically. Events are emitted metadata-first and
time-sorted per thread, which makes per-thread ``ts`` monotonicity a
structural guarantee — :func:`validate_chrome_trace` (shared by the
tests and the CI smoke step) checks exactly that, plus phase shapes
(matched ``B``/``E`` or complete ``X``), and stable pid/tid naming
(every referenced track carries ``process_name`` / ``thread_name``
metadata).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.trace import (PH_COMPLETE, PH_INSTANT, SpanEvent,
                                   Tracer, tracer as _global_tracer)

PID = 1
_ALLOWED_PH = {"X", "B", "E", "i", "I", "M", "C"}


def chrome_trace(events: Optional[Sequence[SpanEvent]] = None, *,
                 tracer: Optional[Tracer] = None,
                 process_name: str = "perona") -> Dict[str, object]:
    """Lower recorded :class:`SpanEvent` s to a Chrome trace dict.

    ``events`` wins when given; otherwise ``tracer`` (default: the
    process-wide tracer) is snapshotted. Thread tracks are numbered in
    first-seen timestamp order — deterministic for a given recording.
    """
    if events is None:
        events = (tracer if tracer is not None
                  else _global_tracer()).events()
    events = sorted(events, key=lambda e: (e.ts, -e.dur))
    origin = events[0].ts if events else 0.0

    # stable tid naming: dense track ids in first-seen order
    track_of: Dict[int, int] = {}
    name_of: Dict[int, str] = {}
    for ev in events:
        if ev.tid not in track_of:
            track_of[ev.tid] = len(track_of)
            name_of[track_of[ev.tid]] = ev.thread
    out: List[Dict[str, object]] = [{
        "ph": "M", "pid": PID, "tid": 0, "name": "process_name",
        "args": {"name": process_name},
    }]
    for tid in sorted(name_of):
        out.append({"ph": "M", "pid": PID, "tid": tid,
                    "name": "thread_name",
                    "args": {"name": name_of[tid]}})
        out.append({"ph": "M", "pid": PID, "tid": tid,
                    "name": "thread_sort_index",
                    "args": {"sort_index": tid}})

    def us(t: float) -> float:
        return round((t - origin) * 1e6, 3)

    # per-track time order (already globally sorted by ts): monotonic
    # ts per tid by construction
    for ev in events:
        rec: Dict[str, object] = {
            "name": ev.name, "cat": ev.cat, "pid": PID,
            "tid": track_of[ev.tid], "ts": us(ev.ts),
        }
        if ev.ph == PH_COMPLETE:
            rec["ph"] = "X"
            rec["dur"] = round(ev.dur * 1e6, 3)
        elif ev.ph == PH_INSTANT:
            rec["ph"] = "i"
            rec["s"] = "t"
        else:
            rec["ph"] = ev.ph
        if ev.args:
            rec["args"] = dict(ev.args)
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str,
                       events: Optional[Sequence[SpanEvent]] = None, *,
                       tracer: Optional[Tracer] = None,
                       process_name: str = "perona"
                       ) -> Dict[str, object]:
    """Export a timeline artifact to ``path``; returns the trace dict."""
    obj = chrome_trace(events, tracer=tracer, process_name=process_name)
    with open(path, "w") as f:
        json.dump(obj, f)
        f.write("\n")
    return obj


def validate_chrome_trace(obj: object) -> Dict[str, int]:
    """Validate Chrome trace-event structure; raises ``ValueError``
    listing every violation, returns summary counts on success.

    Checks: top-level shape; required per-event fields; known phases;
    complete ``X`` events carry a non-negative ``dur``; ``B``/``E``
    begin/end events nest and match by name per (pid, tid); ``ts`` is
    monotonically non-decreasing per (pid, tid) in emission order; and
    every (pid, tid) referenced by a timed event has ``thread_name``
    metadata (and its pid a ``process_name``) — stable track naming.
    """
    errors: List[str] = []
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        raise ValueError(
            "not a Chrome trace: expected a dict with a "
            "'traceEvents' list")
    events = obj["traceEvents"]
    last_ts: Dict[tuple, float] = {}
    be_stack: Dict[tuple, List[str]] = {}
    named_threads = set()
    named_procs = set()
    used_tracks = set()
    n_spans = 0
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _ALLOWED_PH:
            errors.append(f"{where}: unknown phase {ph!r}")
            continue
        if "pid" not in ev or "tid" not in ev:
            errors.append(f"{where}: missing pid/tid")
            continue
        track = (ev["pid"], ev["tid"])
        if ph == "M":
            if ev.get("name") == "thread_name":
                named_threads.add(track)
            elif ev.get("name") == "process_name":
                named_procs.add(ev["pid"])
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing event name")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            errors.append(f"{where}: missing numeric ts")
            continue
        used_tracks.add(track)
        if ts < last_ts.get(track, float("-inf")):
            errors.append(
                f"{where}: ts {ts} goes backwards on pid/tid {track} "
                f"(previous {last_ts[track]})")
        last_ts[track] = ts
        if ph == "X":
            n_spans += 1
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(
                    f"{where}: complete event needs dur >= 0, "
                    f"got {dur!r}")
        elif ph == "B":
            be_stack.setdefault(track, []).append(ev.get("name", ""))
            n_spans += 1
        elif ph == "E":
            stack = be_stack.get(track, [])
            if not stack:
                errors.append(
                    f"{where}: E event with no open B on {track}")
            else:
                top = stack.pop()
                name = ev.get("name", top)
                if name and name != top:
                    errors.append(
                        f"{where}: E name {name!r} does not match "
                        f"open B {top!r} on {track}")
    for track, stack in be_stack.items():
        if stack:
            errors.append(
                f"unclosed B events on pid/tid {track}: {stack}")
    for track in sorted(used_tracks):
        if track not in named_threads:
            errors.append(
                f"pid/tid {track} has events but no thread_name "
                "metadata")
        if track[0] not in named_procs:
            errors.append(
                f"pid {track[0]} has events but no process_name "
                "metadata")
    if errors:
        raise ValueError("invalid Chrome trace:\n" +
                         "\n".join(f"  - {e}" for e in errors))
    return {"events": len(events), "spans": n_spans,
            "threads": len(used_tracks)}


def validate_chrome_trace_file(path: str) -> Dict[str, int]:
    """Load + validate a timeline artifact (the CI smoke helper)."""
    with open(path) as f:
        return validate_chrome_trace(json.load(f))
