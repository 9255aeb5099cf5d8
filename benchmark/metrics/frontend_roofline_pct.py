"""K1's share of its roofline: the frozen bound of the fused front end's
work at the cell's shapes (``frozen.roofline.frontend_s``) over the
device time a block of its kernel (``frontend_kernel`` or
``frontend_walk_kernel``), in percent. Only for one-family cells, where
one K1 launch a block covers every channel."""

from benchmark.frozen.roofline import frontend_s
from benchmark.metrics.common import kernels
from benchmark.reference.step import Family


def read(record):
    p = record["config"].get("pipeline")
    if p is None:
        return None
    ev = kernels(record, "frontend_kernel", "frontend_walk_kernel")
    if not ev:
        return None
    fam = Family(p["sonde"], p["fs"], p["block_len"], p.get("ntaps", 41))
    in_bytes = 2 if p["compute_dtype"] == "bf16" else 4
    bound = frontend_s(int(p["channels"]), int(p["block_len"]), fam.decim,
                       int(p.get("ntaps", 41)), in_bytes)
    t = sum(d for _, _, d in ev) / record["blocks"] / 1e6
    return 100.0 * bound / t
