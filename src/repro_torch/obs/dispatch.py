"""Dispatch accounting behind the metrics registry.

The port's counterpart of ``repro/obs/jaxstat.py``. The port runs its
scoring functions eagerly, so there is no trace to count; what a JAX
trace marks, the first call for a new input shape, is counted here as a
new *signature* (``(R, bucket)`` for the fleet scorer, ``(bucket,)`` for
the engine). Each :class:`DispatchSite` owns four labeled instruments:
``dispatch.signatures`` (distinct signatures run), ``dispatch.calls``,
``dispatch.first_s`` (wall seconds of first calls per signature) and
``dispatch.run_s`` (wall seconds of the later calls).

``count`` and ``trace_count`` read the signature counter, so every
``stats["traces"]`` key of the reference keeps its meaning: one per
distinct stacked shape.

:meth:`DispatchSite.dispatch` wraps one host-blocking call (it ends in
a device-to-host copy): it books the wall time as first-call or later
call, ticks the call counter and records a ``CAT_DEVICE`` span on the
current thread. A call that raises books nothing, and its signature
stays new. With the plane disabled (``obs.disable()``) only the set of
signatures is kept, as the reference's counters then stay at 0 too.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Dict, Hashable, Iterator, Optional

from repro_torch.obs import metrics, trace

_SITE_SEQ = itertools.count()


def instance_site(prefix: str) -> str:
    """Unique site label for per-instance accounting (``engine/3``), so
    instances of one class keep distinct registry rows."""
    return f"{prefix}/{next(_SITE_SEQ)}"


class DispatchSite:
    """Signature/call/wall-time accounting for one dispatch site."""

    def __init__(self, site: str,
                 registry: Optional[metrics.MetricsRegistry] = None,
                 tracer: Optional[trace.Tracer] = None):
        reg = registry if registry is not None else metrics.registry()
        self.site = site
        self._tracer = tracer
        self._seen: set = set()
        self._signatures = reg.counter("dispatch.signatures", site=site)
        self._calls = reg.counter("dispatch.calls", site=site)
        self._first_s = reg.counter("dispatch.first_s", site=site)
        self._run_s = reg.counter("dispatch.run_s", site=site)

    @property
    def count(self) -> int:
        """Distinct input signatures run so far."""
        return int(self._signatures.value)

    @property
    def trace_count(self) -> int:
        return self.count

    @property
    def dispatches(self) -> int:
        return int(self._calls.value)

    @property
    def first_seconds(self) -> float:
        return float(self._first_s.value)

    @property
    def run_seconds(self) -> float:
        return float(self._run_s.value)

    @contextlib.contextmanager
    def dispatch(self, signature: Hashable, name: Optional[str] = None,
                 args: Optional[Dict[str, object]] = None
                 ) -> Iterator[None]:
        """Account one host-blocking call with input ``signature``."""
        first = signature not in self._seen
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._seen.add(signature)
        if not metrics.enabled():
            return
        if first:
            self._signatures.inc()
        (self._first_s if first else self._run_s).add(dt)
        self._calls.inc()
        tr = self._tracer if self._tracer is not None else trace.tracer()
        span_args = dict(args) if args else {}
        span_args["first"] = first
        tr.complete(name if name is not None else self.site,
                    trace.CAT_DEVICE, t0, dt, args=span_args)

    def stats(self) -> metrics.StatsDict:
        return {
            "traces": self.count,
            "dispatches": self.dispatches,
            "first_s": self.first_seconds,
            "run_s": self.run_seconds,
        }
