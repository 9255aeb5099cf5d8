"""Frozen roofline counts of the dual-tone front end (K7 and the midpoint
DC), on ``roofline.py``'s rates and rule: the least time is the larger of
the bytes over device memory's rate and the single-rounded operations over
the arithmetic rate. These counts are the benchmark's yardstick and are
not edited.
"""

from __future__ import annotations

from benchmark.frozen.roofline import bound_s

# per position: the +/-dev mix of both planes into four (8 products, 4
# sums), the metric (P+ and P-: 4 products, 2 sums; their difference,
# their sum, eps and the division: 4; 10 in all) and its share of the DC (1)
MIX_OPS = 12
METRIC_OPS = 11
# the midpoint's least work a position: one read and compare of every
# metric value by a selection, and the DC's subtraction
MIDPOINT_OPS = 2


def dualtone_ops(ntaps: int, nb: int, skip_chanfilt: bool) -> int:
    """Operations a position of K7: the channel filter of both planes
    (2 x T products and sums) unless it is skipped, the mix, the nb-tap
    boxcar of four planes and its scale (4 (nb + 1)), the metric and its
    DC share: 271 for ims100's 41 taps and nb 20, 47 for m10's skipped
    filter and nb 5."""
    return ((0 if skip_chanfilt else 4 * ntaps) + MIX_OPS + 4 * (nb + 1)
            + METRIC_OPS)


def dualtone_bytes(channels: int, n: int, in_bytes: int = 4,
                   halo: int = 256) -> int:
    """K7's bytes: both planes [channels, n] and both tails [channels,
    halo] read in the planes' dtype, the tails written, the two float32
    mixer tables [n] read, the float32 metric [channels, n] written."""
    return (2 * channels * n * in_bytes + 2 * 2 * channels * halo * in_bytes
            + 2 * 4 * n + 4 * channels * n)


def dualtone_s(channels: int, n: int, ntaps: int, nb: int,
               skip_chanfilt: bool, in_bytes: int = 4) -> float:
    """K7, the fused dual-tone front end, on planes [channels, n]: 3.18 ms
    (operations) for ims100's channel-filter body at 2048 x 192000."""
    return bound_s(dualtone_bytes(channels, n, in_bytes),
                   channels * n * dualtone_ops(ntaps, nb, skip_chanfilt))


def dualtone_frontend_s(channels: int, n: int, ntaps: int, nb: int,
                        skip_chanfilt: bool, in_bytes: int = 4) -> float:
    """The dual-tone front end with the midpoint DC, whatever implements
    it: K7's work, then the midpoint's least (``MIDPOINT_OPS`` a position;
    one more float32 read of the metric for the selection, the
    subtraction's bytes riding the next stage's read): 3.20 ms for ims100
    at 2048 x 192000."""
    return bound_s(dualtone_bytes(channels, n, in_bytes) + 4 * channels * n,
                   channels * n * (dualtone_ops(ntaps, nb, skip_chanfilt)
                                   + MIDPOINT_OPS))
