"""Fleet-scale fingerprint service (paper §III-C at fleet traffic), the
port of ``repro.fleet``:

- ``store``   — append-only columnar :class:`FingerprintStore` with
  per-(node x benchmark type) time-windowed views and atomic .npz
  durability (numpy, copied);
- ``shard``   — :class:`ShardedScorer`, a stacked request batch scored
  as one flat graph on the card through the engine's score function;
- ``service`` — :class:`FleetScoringService`, micro-batched request
  queue dispatching one stacked call per shape bucket, with NaN/Inf
  and unknown-type quarantine at intake;
- ``drift``   — store-backed per-node / per-aspect EWMA degradation
  analytics (numpy, copied);
- ``ingest``  — :class:`IngestionDaemon`, the streaming front-end:
  bounded ring staging, deadline/pow2 flush triggers, the backpressure
  ladder and crash-safe shutdown;
- ``faults``  — deterministic seeded fault injection over telemetry
  streams (numpy, copied);
- ``modelplane`` — :class:`ModelRegistry` (versioned parameter
  checkpoints, the reference's registry format) and :class:`ModelPlane`
  (canary, hot promote, watch with rollback and row repair, drift
  retrain) on the service and the daemon.
"""

from repro_torch.fleet.drift import (EwmaMean, NodeDrift, RollingDrift,
                                     degradation_factors, degrading_nodes,
                                     drift_report, ewma_series)
from repro_torch.fleet.faults import (FaultLog, FaultPlan, TelemetryEvent,
                                      corrupt_frame, fleet_telemetry,
                                      inject_faults)
from repro_torch.fleet.ingest import (IngestionDaemon, load_staging,
                                      save_staging)
from repro_torch.fleet.modelplane import ModelPlane, ModelRegistry
from repro_torch.fleet.service import FleetResult, FleetScoringService
from repro_torch.fleet.shard import ShardedScorer
from repro_torch.fleet.store import FingerprintStore, atomic_savez

__all__ = [
    "FingerprintStore", "ShardedScorer", "FleetScoringService",
    "EwmaMean", "FleetResult", "NodeDrift", "RollingDrift", "drift_report",
    "degradation_factors", "degrading_nodes", "ewma_series",
    "IngestionDaemon", "save_staging", "load_staging",
    "TelemetryEvent", "FaultPlan", "FaultLog", "fleet_telemetry",
    "inject_faults", "corrupt_frame", "atomic_savez",
    "ModelPlane", "ModelRegistry",
]
