"""Helpers the metric readers share."""

from __future__ import annotations

# PyTorch's own kernels: the eager operators of at::native and the CUB
# algorithms that PyTorch carries (sort, scan, select)
TORCH_KERNEL_MARKS = ("at::", "cub::", "at_cuda_detail")


def kernels(record, *marks):
    """(name, ts, dur) of the kernels whose name holds one of ``marks``."""
    return [(n, ts, d) for cat, n, ts, d in record["device"]
            if cat == "kernel" and any(m in n for m in marks)]


def per_block_ms(record, events) -> float:
    return sum(d for _, _, d in events) / record["blocks"] / 1e3
