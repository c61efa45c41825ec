"""Process-wide telemetry plane: metrics, spans, timelines, dispatch
accounting.

The port's part of ``repro.obs``:

- ``metrics``  — the labeled, thread-safe :class:`MetricsRegistry` of
  counters / gauges / streaming histograms, near-zero-cost when the
  plane is disabled (``obs.disable()``); a copy of the reference's;
- ``trace``    — span-based tracing with an injectable clock, so the
  ``IngestionDaemon``'s virtual-clock ``run()`` and wall-clock
  ``serve()`` both record honest spans; a copy of the reference's;
- ``timeline`` — export of recorded spans to Chrome trace-event JSON
  (loadable in Perfetto / ``chrome://tracing``) plus the schema
  validator; a copy of the reference's;
- ``dispatch`` — :class:`DispatchSite`, the counterpart of the
  reference's ``jaxstat.JitSite``: distinct input signatures (the first
  call per shape, where JAX traces), calls, and first-call and
  later-call wall seconds per site;
- ``regress``  — noise-aware perf-regression detection over benchmark
  history series, its attribution keyed on the ``dispatch.*``
  counters. Imported explicitly (``from repro_torch.obs import
  regress``) because it leans on ``repro_torch.fleet``, as the
  reference's does.
"""

from repro_torch.obs.dispatch import DispatchSite, instance_site
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, StatsDict, disable,
                                     disabled, enable, enabled, parse_key,
                                     registry)
from repro_torch.obs.trace import (CAT_DEVICE, CAT_HOST, CAT_LADDER,
                                   CAT_PLANE, SpanEvent, Tracer, span,
                                   tracer)
from repro_torch.obs.timeline import (chrome_trace, validate_chrome_trace,
                                      validate_chrome_trace_file,
                                      write_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsDict",
    "registry", "enable", "disable", "enabled", "disabled",
    "parse_key",
    "Tracer", "SpanEvent", "tracer", "span",
    "CAT_HOST", "CAT_DEVICE", "CAT_LADDER", "CAT_PLANE",
    "chrome_trace", "write_chrome_trace", "validate_chrome_trace",
    "validate_chrome_trace_file",
    "DispatchSite", "instance_site",
]
