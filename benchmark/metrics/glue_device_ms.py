"""Device milliseconds a block of the kernels that PyTorch launches for
the program's eager operators (the pipeline and fleet glue: the dequant,
timing, sampling, chip ring, peak pick, gathers, packing, concatenation),
from the profiler's device trace."""

from benchmark.metrics.common import TORCH_KERNEL_MARKS, kernels, per_block_ms


def read(record):
    ev = kernels(record, *TORCH_KERNEL_MARKS)
    if not ev:
        return None
    return per_block_ms(record, ev)
