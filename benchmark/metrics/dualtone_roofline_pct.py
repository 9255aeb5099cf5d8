"""K7's share of its roofline: the frozen bound of the dual-tone front
end's kernel work at the cell's shapes (``frozen.roofline_dualtone.
dualtone_s``: the channel filter unless the family's gate skips it, the
mix, the boxcar, the metric) over the device time a block of its kernel
(``dualtone_kernel``), in percent. Only for ``pipeline`` cells of a
dual-tone family, where one K7 launch a block covers every channel."""

from benchmark.frozen.roofline_dualtone import dualtone_s
from benchmark.metrics.common import kernels
from benchmark.reference.step import Family
import benchmark.frozen.sondes.ims100  # noqa: F401  (registers ims100)


def family(record):
    """The cell's ``Family`` where it is a ``pipeline`` cell of a dual-tone
    family of the frozen registry; None otherwise."""
    p = record["config"].get("pipeline")
    if p is None:
        return None
    try:
        fam = Family(p["sonde"], p["fs"], p["block_len"], p.get("ntaps", 41))
    except KeyError:
        return None
    return fam if fam.dualtone else None


def bound(record, fam, fn=dualtone_s):
    p = record["config"]["pipeline"]
    return fn(int(p["channels"]), fam.block_len, fam.ntaps,
              max(2, int(round(fam.sps))), fam.skip_chanfilt,
              2 if p["compute_dtype"] == "bf16" else 4)


def read(record):
    fam = family(record)
    if fam is None:
        return None
    ev = kernels(record, "dualtone_kernel")
    if not ev:
        return None
    t = sum(d for _, _, d in ev) / record["blocks"] / 1e6
    return 100.0 * bound(record, fam) / t
