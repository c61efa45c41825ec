"""Noise-aware perf-regression detection over benchmark history.

The PyTorch counterpart of ``repro/obs/regress.py``, a copy but for the
attribution rules. :func:`evaluate_series` judges the newest value of
each metric against an EWMA baseline over its history, and
:func:`attribute_delta` explains confirmed regressions by diffing the
companion telemetry snapshots (``MetricsRegistry.snapshot_delta``): a
throughput drop co-occurring with a ``dispatch.signatures`` increase
is a *recompile regression* (the port's scoring functions run eagerly,
so a new input signature is where JAX would trace and compile anew),
one co-occurring with a quarantine-counter shift is a *behavior
change*, not just "slower".

Three defenses keep the gate honest on noisy runners:

- the baseline is the **same EWMA fold** fleet drift analytics use
  (:class:`repro_torch.fleet.drift.EwmaMean` — ``e_0 = x_0``,
  ``e_i = (1-a) e_{i-1} + a x_i``), so a slow multi-run decline moves
  the baseline with it and only *abrupt* drops clear the threshold;
- the effective threshold widens by a **noise floor** calibrated from
  the series itself (robust MAD-based relative scatter of the
  historical values, scaled) and by any **A/A null measurement** a
  benchmark ships (two identical code paths measured against each
  other — the observed same-code gap of that very machine);
- every metric carries a **direction policy** (higher-is-better req/s
  vs lower-is-better p99; counters and config echoes are
  informational), from an explicit ``POLICIES`` table first, name
  heuristics second.

The reference's attribution rules key on its JIT counters; here they
key on the port's dispatch accounting (``obs/dispatch.py``):
``jax.traces`` -> ``dispatch.signatures``, ``jax.dispatches`` ->
``dispatch.calls``, ``jax.compile_s`` -> ``dispatch.first_s``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fleet.drift import EwmaMean
from repro_torch.obs import metrics

# ------------------------------------------------------------ policies

DIR_HIGHER = "higher"   # bigger is better (throughput, speedups)
DIR_LOWER = "lower"     # smaller is better (latency, wall clock)
DIR_INFO = "info"       # tracked, never gated (counts, config echoes)

#: substring -> direction, first match wins (checked in order; explicit
#: per-module POLICIES tables override all of this)
_HIGHER_TOKENS = ("req_per_s", "requests_per_s", "searches_per_s",
                  "rows_per_s", "per_sec", "throughput", "speedup",
                  "parity", "f1", "accuracy")
_LOWER_TOKENS = ("latency", "p50", "p99", "wall_s", "compile_s",
                 "overhead_pct", "us_per_call", "spec_s", "tables_s")
_INFO_TOKENS = ("noise_pct", "events", "rounds", "rows", "devices",
                "lanes", "traces", "dispatches", "flushes", "count",
                "capacity", "window", "error")


@dataclasses.dataclass(frozen=True)
class MetricPolicy:
    """How one metric is gated: direction, the minimum relative change
    that counts (percent), and how much history a verdict needs."""

    direction: str
    rel_threshold_pct: float = 5.0
    min_history: int = 3


def default_policy(name: str,
                   overrides: Optional[Mapping[str, MetricPolicy]]
                   = None) -> MetricPolicy:
    """Policy for a metric name: explicit override table first (the
    bench module's ``POLICIES``), then name heuristics, then
    informational."""
    if overrides is not None:
        p = overrides.get(name)
        if p is not None:
            return p
    low = name.lower()
    for tok in _INFO_TOKENS:
        if low.endswith(tok):
            return MetricPolicy(DIR_INFO)
    for tok in _HIGHER_TOKENS:
        if tok in low:
            return MetricPolicy(DIR_HIGHER)
    for tok in _LOWER_TOKENS:
        if tok in low:
            return MetricPolicy(DIR_LOWER)
    return MetricPolicy(DIR_INFO)


def policy_table(raw: Mapping[str, object]) -> Dict[str, MetricPolicy]:
    """Normalize a bench module's plain ``POLICIES`` dict — values are
    ``direction`` strings or ``(direction, rel_threshold_pct)`` tuples
    (kept plain so bench modules import nothing at module scope)."""
    out: Dict[str, MetricPolicy] = {}
    for name, spec in raw.items():
        if isinstance(spec, MetricPolicy):
            out[name] = spec
        elif isinstance(spec, str):
            out[name] = MetricPolicy(spec)
        else:
            direction, thr = spec
            out[name] = MetricPolicy(direction,
                                     rel_threshold_pct=float(thr))
    return out


# ---------------------------------------------------------- noise floor

def series_noise_pct(values: Sequence[float],
                     scale: float = 3.0) -> float:
    """Relative noise of a baseline series, in percent: the MAD-based
    robust standard deviation (``1.4826 * MAD``) over the median
    magnitude, scaled to a ~3-sigma band. A/A-identical series measure
    exactly 0; the 20%-regression acceptance case stays far outside
    any plausible floor."""
    v = np.asarray(values, np.float64)
    v = v[np.isfinite(v)]
    if len(v) < 2:
        return 0.0
    med = np.median(v)
    if med == 0.0:
        return 0.0
    mad = np.median(np.abs(v - med))
    return float(scale * 1.4826 * mad / abs(med) * 100.0)


def noise_floor_pct(values: Sequence[float],
                    aa_noise_pct: float = 0.0,
                    scale: float = 3.0) -> float:
    """Effective noise floor for one series: its own robust scatter
    widened by the run's A/A null measurement (when the benchmark
    ships one)."""
    return max(series_noise_pct(values, scale=scale),
               float(aa_noise_pct))


# ------------------------------------------------------------ findings

VERDICT_REGRESSION = "regression"
VERDICT_IMPROVEMENT = "improvement"
VERDICT_OK = "ok"
VERDICT_NO_BASELINE = "no-baseline"
VERDICT_INFO = "info"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One metric's verdict for one evaluated run."""

    module: str
    metric: str
    value: float
    baseline: float          # EWMA over the baseline series (nan if none)
    n_baseline: int
    delta_pct: float         # signed (value - baseline)/|baseline| * 100
    threshold_pct: float     # effective gate threshold after widening
    noise_pct: float         # the floor that widened it
    direction: str
    verdict: str
    attribution: Tuple[str, ...] = ()

    @property
    def regressed(self) -> bool:
        return self.verdict == VERDICT_REGRESSION

    @property
    def label(self) -> str:
        """``module.metric``, without doubling the module prefix the
        bench rows already carry."""
        if self.metric.startswith(self.module + "."):
            return self.metric
        return f"{self.module}.{self.metric}"

    def describe(self) -> str:
        if self.verdict in (VERDICT_INFO, VERDICT_NO_BASELINE):
            return (f"{self.label}: {self.verdict} "
                    f"(value {self.value:g}, "
                    f"history {self.n_baseline})")
        line = (f"{self.label}: {self.verdict} "
                f"{self.delta_pct:+.2f}% vs EWMA baseline "
                f"{self.baseline:g} (n={self.n_baseline}, "
                f"threshold ±{self.threshold_pct:.2f}%, "
                f"direction {self.direction})")
        if self.attribution:
            line += " — " + "; ".join(self.attribution)
        return line


def evaluate_series(module: str, metric: str,
                    baseline_values: Sequence[float], value: float,
                    policy: Optional[MetricPolicy] = None, *,
                    overrides: Optional[Mapping[str, MetricPolicy]]
                    = None,
                    alpha: float = 0.3,
                    aa_noise_pct: float = 0.0) -> Finding:
    """Judge the newest ``value`` of one metric against the EWMA fold
    of its ``baseline_values`` (chronological, oldest first). The
    effective threshold is the policy's relative threshold widened to
    the calibrated noise floor, so a gate over A/A reruns never flags
    and a gate over a noisy series needs a genuinely abrupt change."""
    if policy is None:
        policy = default_policy(metric, overrides)
    vals = np.asarray(baseline_values, np.float64)
    vals = vals[np.isfinite(vals)]
    if policy.direction == DIR_INFO or not np.isfinite(value):
        return Finding(module, metric, float(value), float("nan"),
                       len(vals), 0.0, 0.0, 0.0, DIR_INFO,
                       VERDICT_INFO)
    if len(vals) < policy.min_history:
        return Finding(module, metric, float(value), float("nan"),
                       len(vals), 0.0, 0.0, 0.0, policy.direction,
                       VERDICT_NO_BASELINE)
    baseline = ewma_baseline(vals, alpha)
    noise = noise_floor_pct(vals, aa_noise_pct)
    threshold = max(policy.rel_threshold_pct, noise)
    denom = abs(baseline) if baseline != 0.0 else 1.0
    delta_pct = (float(value) - baseline) / denom * 100.0
    worse = (delta_pct < -threshold if policy.direction == DIR_HIGHER
             else delta_pct > threshold)
    better = (delta_pct > threshold if policy.direction == DIR_HIGHER
              else delta_pct < -threshold)
    verdict = (VERDICT_REGRESSION if worse
               else VERDICT_IMPROVEMENT if better else VERDICT_OK)
    return Finding(module, metric, float(value), baseline,
                   len(vals), delta_pct, threshold, noise,
                   policy.direction, verdict)


def ewma_baseline(values: Sequence[float], alpha: float = 0.3) -> float:
    """The baseline fold — exactly :class:`EwmaMean` (fleet drift's
    semantics): recent runs dominate, one ancient outlier cannot
    poison the comparison."""
    return float(EwmaMean(alpha).fold(
        np.asarray(values, np.float64)).ewma)


# --------------------------------------------------------- attribution

#: counter-name prefix -> human label for the attribution pass, probed
#: in order; the first rule whose summed positive delta fires names
#: the regression class
_ATTRIBUTION_RULES: Tuple[Tuple[str, str], ...] = (
    ("dispatch.signatures",
     "recompile regression: dispatch.signatures {delta:+d}"),
    ("fleet.quarantined",
     "behavior change: quarantined rows {delta:+d}"),
    ("ingest.ladder",
     "behavior change: backpressure ladder steps {delta:+d}"),
    ("ingest.duplicates_dropped",
     "behavior change: duplicates dropped {delta:+d}"),
    ("dispatch.calls", "behavior change: dispatches {delta:+d}"),
)


def _summed_delta(delta: Mapping[str, Mapping[str, object]],
                  prefix: str) -> float:
    """Net counter delta summed over every labeled instance of a
    metric family (site renumbering between processes cancels out in
    the sum)."""
    total = 0.0
    for key, ent in delta.items():
        name, _ = metrics.parse_key(key)
        if name.startswith(prefix) and ent["kind"] == "counter":
            total += float(ent["delta"] or 0)
    return total


def attribute_delta(delta: Mapping[str, Mapping[str, object]]
                    ) -> Tuple[str, ...]:
    """Classify a telemetry-snapshot diff (the output of
    ``MetricsRegistry.snapshot_delta`` between the baseline run's
    snapshot and the evaluated run's) into regression classes. Both
    snapshots come from runs of the *same* workload, so any net
    positive shift in a diagnostic counter family is a real change of
    behavior, not traffic growth. Empty tuple = nothing diagnostic
    moved (an unattributed slowdown)."""
    labels = []
    for prefix, template in _ATTRIBUTION_RULES:
        d = _summed_delta(delta, prefix)
        if d > 0:
            labels.append(template.format(delta=int(d)))
    compile_d = _summed_delta(delta, "dispatch.first_s")
    if compile_d > 0.01 and any("dispatch.signatures" in x
                                for x in labels):
        labels[0] += f" ({compile_d:+.2f}s compile wall)"
    return tuple(labels)


def attribute_snapshots(before: Mapping[str, object],
                        after: Mapping[str, object]) -> Tuple[str, ...]:
    """Convenience: diff two raw snapshots with the process registry's
    type information and classify."""
    return attribute_delta(
        metrics.registry().snapshot_delta(dict(before), dict(after)))
