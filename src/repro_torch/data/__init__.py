"""Data pipelines of the port (``repro.data``)."""

from repro_torch.data.tokens import TokenPipeline

__all__ = ["TokenPipeline"]
