"""Per-block pipeline, host decode session and metrics (counterpart:
``sondetpu/runtime``)."""
