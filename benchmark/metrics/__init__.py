"""One reader per per-layer metric, found by the metric's name.

Each ``<metric>.py`` holds ``read(record) -> float | None``: the metric
from the traced run's record (``harness.trace.record_of``), or None where
the record holds nothing to read, in which case the harness leaves the
metric out of the result line.
"""
