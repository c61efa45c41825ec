"""Serving layer: batched fingerprint scoring on the card."""

from repro_torch.serving.engine import FingerprintEngine, ScoreResult

__all__ = ["FingerprintEngine", "ScoreResult"]
