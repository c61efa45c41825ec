"""Checkpointing: atomic async saves and restart, in the reference's
``step_<n>.npz`` format (``repro.checkpointing``). Elastic resharding
(``reshard``) waits for the mesh tooling (ROADMAP queue 1 item 7)."""

from repro_torch.checkpointing.manager import CheckpointManager

__all__ = ["CheckpointManager"]
