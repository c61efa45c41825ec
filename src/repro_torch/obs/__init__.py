"""Process-wide telemetry plane: metrics, spans, dispatch accounting.

The port's part of ``repro.obs``:

- ``metrics``  — the labeled, thread-safe :class:`MetricsRegistry` of
  counters / gauges / streaming histograms, near-zero-cost when the
  plane is disabled (``obs.disable()``); a copy of the reference's;
- ``trace``    — span-based tracing with an injectable clock, so the
  ``IngestionDaemon``'s virtual-clock ``run()`` and wall-clock
  ``serve()`` both record honest spans; a copy of the reference's;
- ``dispatch`` — :class:`DispatchSite`, the counterpart of the
  reference's ``jaxstat.JitSite``: distinct input signatures (the first
  call per shape, where JAX traces), calls, and first-call and
  later-call wall seconds per site.

The Chrome-trace exporter (``timeline``) and the regression detector
(``regress``) are not ported yet.
"""

from repro_torch.obs.dispatch import DispatchSite, instance_site
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, StatsDict, disable,
                                     disabled, enable, enabled, parse_key,
                                     registry)
from repro_torch.obs.trace import (CAT_DEVICE, CAT_HOST, CAT_LADDER,
                                   CAT_PLANE, SpanEvent, Tracer, span,
                                   tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsDict",
    "registry", "enable", "disable", "enabled", "disabled",
    "parse_key",
    "Tracer", "SpanEvent", "tracer", "span",
    "CAT_HOST", "CAT_DEVICE", "CAT_LADDER", "CAT_PLANE",
    "DispatchSite", "instance_site",
]
