"""Batched Bayesian-optimization replay engine (paper §IV-D at scale).

The sequential reference tuners live in ``repro_torch.tuning``
(CherryPick / Arrow, one numpy GP search at a time). This package
replays *many* configuration searches as lanes of batched float64
tensor ops on a device:

- :mod:`repro_torch.optimizer.gp` — batched masked RBF GP (fit +
  predict over a leading lane axis, pinned against ``tuning/gp.py``);
- :mod:`repro_torch.optimizer.acquire` — expected improvement and the
  §IV-D Perona acquisition weighting as tensor ops;
- :mod:`repro_torch.optimizer.replay` — full BO search loops, every
  lane advanced a round at a time with no host read until the fetch;
  the lane axis optionally split over several devices, bit-identical
  to one device;
- :mod:`repro_torch.optimizer.scenarios` — the §IV-D scenario matrix
  (workload x seed x tuner variant x fleet condition) over the scout
  simulator, including degraded-node fleets from ``fleet.drift``, plus
  ``replay_pipelined``: fixed-size lane blocks whose host-side table
  construction overlaps the previous block's device rounds. The seeded
  path (``lane_spec`` / ``replay_seeded``) ships only the compact
  deterministic grid + per-lane ids and re-derives every stochastic
  table cell on the device from counter-based ``fold_in`` keys —
  bit-identical to the host tables.
"""

from repro_torch.optimizer.replay import (REPLAY_TRACES, BatchReplayResult,
                                          PendingReplay, ReplayConfig,
                                          SeededLaneSpec, replay,
                                          replay_async, replay_seeded,
                                          replay_seeded_async,
                                          traces_from_result,
                                          traces_from_spec)
from repro_torch.optimizer.scenarios import (HEALTHY,
                                             DeferredFleetCondition,
                                             FleetCondition, Scenario,
                                             build_scenarios,
                                             condition_from_drift,
                                             degrade_scores,
                                             drifted_condition, lane_spec,
                                             lane_tables, reference_search,
                                             replay_pipelined,
                                             replay_scenarios,
                                             resolve_condition,
                                             simulate_degraded_fleet)

__all__ = [
    "REPLAY_TRACES", "BatchReplayResult", "PendingReplay",
    "ReplayConfig", "SeededLaneSpec", "replay", "replay_async",
    "replay_seeded", "replay_seeded_async", "traces_from_result",
    "traces_from_spec",
    "HEALTHY", "DeferredFleetCondition", "FleetCondition", "Scenario",
    "build_scenarios", "condition_from_drift", "degrade_scores",
    "drifted_condition", "lane_spec", "lane_tables",
    "reference_search", "replay_pipelined", "replay_scenarios",
    "resolve_condition", "simulate_degraded_fleet",
]
