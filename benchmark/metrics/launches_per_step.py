"""Kernel launch calls a block that the host made inside the entry (the
calls of ``harness.spans.LAUNCH_CALLS`` inside ``sondetpu.step`` or
``sondetpu.fleet.step``)."""

from benchmark.harness.spans import (LAUNCH_CALLS, entry_calls,
                                     has_program_spans)


def read(record):
    if not has_program_spans(record):
        return None
    return len(entry_calls(record, LAUNCH_CALLS)) / record["blocks"]
