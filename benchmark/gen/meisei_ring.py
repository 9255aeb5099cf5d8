"""Traffic of one Meisei sonde per channel, every channel on its centre.

``channel_ring``'s traffic, for the ``ims100`` family
(``frozen/sondes/ims100.py``), which ``signals`` has no truths for: ``T``
truths drawn from the seed, each an iMS-100 or an RS-11G by a seeded draw
(RS-11G serials printed with an "R"), each modulated once into a circular
signal of ``period_s`` seconds, its even and odd half-frames alternating
from sample 0; then, as ``channel_ring`` makes them, a seeded circular
shift and noise std per channel, the ring of blocks on the device and the
cs16 quantization. The mix has no ``tuning``.
"""

from __future__ import annotations

import contextlib

import numpy as np

from benchmark.frozen.sondes.ims100 import (BAUD, FRAME_BYTES,
                                            IMS100Modulator, IMS100Truth)
from benchmark.gen import channel_ring
from benchmark.gen.signals import Ring


def draw_truth(rng: np.random.Generator) -> dict:
    """A Meisei truth: its model, its serial as printed, a position."""
    rs11g = bool(rng.integers(2))
    serial = ("R" if rs11g else "") + str(int(rng.integers(10 ** 6, 10 ** 7)))
    return {"family": "ims100", "rs11g": rs11g, "serial": serial,
            "lat": float(np.round(rng.uniform(-60.0, 60.0), 4)),
            "lon": float(np.round(rng.uniform(-170.0, 170.0), 4)),
            "alt": float(np.round(rng.uniform(500.0, 30000.0), 1))}


def circular_baseband(truth: dict, period: int, fs: float) -> np.ndarray:
    """complex64 [period]: the truth's half-frames back to back from
    sample 0, the frame counter counting from 0."""
    k = int(np.ceil(period / (fs / BAUD) / (8 * FRAME_BYTES))) + 1
    iq = IMS100Modulator().modulate(
        [IMS100Truth(serial=truth["serial"], frame_no=i, lat=truth["lat"],
                     lon=truth["lon"], alt=truth["alt"],
                     rs11g=truth["rs11g"]) for i in range(k)], fs=fs)
    if iq.shape[0] < period:
        raise ValueError(f"ims100: {iq.shape[0]} samples for a period of "
                         f"{period}")
    return iq[:period]


@contextlib.contextmanager
def _meisei_truths():
    """``channel_ring.make`` draws and modulates its truths through these
    two names of its module."""
    orig = channel_ring.draw_truth, channel_ring.circular_baseband
    channel_ring.draw_truth = lambda family, rng: draw_truth(rng)
    channel_ring.circular_baseband = circular_baseband
    try:
        yield
    finally:
        channel_ring.draw_truth, channel_ring.circular_baseband = orig


def make(torch, config: dict, traffic: dict, seed: int, device) -> Ring:
    if config["pipeline"]["sonde"] != "ims100" or traffic.get("tuning"):
        raise ValueError("meisei_ring makes ims100 traffic on the channel "
                         "centres only")
    with _meisei_truths():
        ring = channel_ring.make(torch, config, traffic, seed, device)
    truths = {id(t): t for t in ring.truths.values()}.values()
    ring.info["rs11g"] = sum(t["rs11g"] for t in truths)
    return ring
