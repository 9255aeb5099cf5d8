"""The front end's frozen bound over the card's busy time a block, in
percent: the least time the card could take for the front end's work at
the cell's shapes (``frozen.roofline.frontend_s``, float32 planes: the
count K1's ``frontend_roofline_pct`` uses) over the union of the device
operations' intervals in the traced window, a block. Whatever implements
the front end, the numerator stays: on the plain-op route, where eager
tap passes do the front end's work, it reads how far the whole step lies
from that bound. Only for ``pipeline`` cells with device events."""

from benchmark.frozen.roofline import frontend_s
from benchmark.harness.trace import busy_us
from benchmark.reference.step import Family


def read(record):
    p = record["config"].get("pipeline")
    if p is None or not record["device"]:
        return None
    busy = busy_us(record) / record["blocks"] / 1e6
    if busy <= 0:
        return None
    ntaps = int(p.get("ntaps", 41))
    fam = Family(p["sonde"], p["fs"], p["block_len"], ntaps)
    bound = frontend_s(int(p["channels"]), int(p["block_len"]), fam.decim,
                       ntaps, 4)
    return 100.0 * bound / busy
