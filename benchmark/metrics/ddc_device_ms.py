"""Device milliseconds a block of the operations launched inside the
program's ``sondetpu.ddc`` spans: the per-channel downconversion that
``fine_offsets`` or ``afc`` put before the front end. None where no step
runs it."""

from benchmark.harness.spans import has_program_spans, stage_device_ms


def read(record):
    if not has_program_spans(record):
        return None
    return stage_device_ms(record, "sondetpu.ddc")
