"""Device milliseconds a block of the operations launched inside the
program's ``sondetpu.corr`` spans: the syncword correlation of every
group (K2 on the fused front end's route, the plain correlation on the
others), by the correlation ids of their launch calls."""

from benchmark.harness.spans import has_program_spans, stage_device_ms


def read(record):
    if not has_program_spans(record):
        return None
    return stage_device_ms(record, "sondetpu.corr")
