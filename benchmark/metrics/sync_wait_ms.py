"""Host milliseconds a block inside the synchronizing calls that the entry
made (those ``syncs_per_step`` counts). Read under the profiler, which
slows the host's launches, so a lower bound of the untraced wait."""

from benchmark.harness.spans import SYNC_CALLS, entry_calls, has_program_spans


def read(record):
    if not has_program_spans(record):
        return None
    return (sum(r[3] for r in entry_calls(record, SYNC_CALLS))
            / record["blocks"] / 1e3)
