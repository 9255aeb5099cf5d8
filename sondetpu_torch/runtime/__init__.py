"""Per-block pipeline, host decode session and metrics (counterpart:
``sondetpu/runtime``, with the same exports)."""

from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig

__all__ = ["Pipeline", "PipelineConfig"]
