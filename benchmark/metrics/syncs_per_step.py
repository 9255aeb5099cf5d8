"""Synchronizing CUDA runtime calls a block that the host made inside the
entry (``sondetpu.step`` or ``sondetpu.fleet.step``): the calls of
``harness.spans.SYNC_CALLS`` in the traced window, attributed to the
program's spans by the trace's clock (``harness.spans``)."""

from benchmark.harness.spans import SYNC_CALLS, entry_calls, has_program_spans


def read(record):
    if not has_program_spans(record):
        return None
    return len(entry_calls(record, SYNC_CALLS)) / record["blocks"]
