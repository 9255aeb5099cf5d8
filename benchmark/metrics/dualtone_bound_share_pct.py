"""The dual-tone front end's frozen bound over the card's busy time a
block, in percent: the least time the card could take for K7's work and
the midpoint DC's least work at the cell's shapes
(``frozen.roofline_dualtone.dualtone_frontend_s``) over the union of the
device operations' intervals in the traced window, a block. Whatever
implements the front end, a midpoint fused into K7 included, the
numerator stays, and the busy time holds the whole step. Only for
``pipeline`` cells of a dual-tone family with device events."""

from benchmark.frozen.roofline_dualtone import dualtone_frontend_s
from benchmark.harness.trace import busy_us
from benchmark.metrics.dualtone_roofline_pct import bound, family


def read(record):
    fam = family(record)
    if fam is None or not record["device"]:
        return None
    busy = busy_us(record) / record["blocks"] / 1e6
    if busy <= 0:
        return None
    return 100.0 * bound(record, fam, dualtone_frontend_s) / busy
