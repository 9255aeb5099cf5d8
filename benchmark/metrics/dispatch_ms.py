"""Host milliseconds inside the entry call (``Pipeline.step`` or
``FleetSession.step``) a block: the mean of the window's spans around the
entry call, over the blocks after the profiler stopped (inside the traced
part the profiler's own cost per operation would dominate it)."""


def read(record):
    spans = record.get("dispatch_s")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
