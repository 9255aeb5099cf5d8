"""Seeded truths and their baseband signals, by the frozen modulators.

A truth is what a sonde sends: its serial and its position. ``draw_truth``
draws one for a family from a NumPy generator, and ``circular_baseband``
modulates a family's frames back to back from sample 0 into a signal of
``period`` samples at ``fs``, which the generators read circularly: the
stream wraps once a period, at a point where a frame is cut (a dropout of
one frame a period at most).
"""

from __future__ import annotations

import numpy as np

from benchmark.frozen.sondes.dfm import DFMModulator, DFMTruth
from benchmark.frozen.sondes.m10 import M10Modulator, M10Truth
from benchmark.frozen.sondes.rs41 import RS41Modulator, RS41Truth

# blocks a generator stages on the device; a traffic mix's period is a
# whole number of rings
RING_BLOCKS = 4

# on-air chips per frame and chip rate of each family
_FRAME = {"rs41": (2560, 4800.0), "m10": (1648, 9600.0), "dfm": (560, 2500.0)}


def draw_truth(family: str, rng: np.random.Generator) -> dict:
    """A serial in the family's printed form and a position."""
    if family == "rs41":
        serial = "%s%07d" % ("PRSTUVW"[rng.integers(7)], rng.integers(10 ** 7))
    elif family == "m10":
        serial = "%X%02d-%d-%05d" % (rng.integers(1, 16), rng.integers(16),
                                     rng.integers(1, 10), rng.integers(10 ** 5))
    elif family == "dfm":
        serial = str(int(rng.integers(10 ** 6, 10 ** 7)))
    else:
        raise ValueError(f"no truths for family {family!r}")
    return {"family": family, "serial": serial,
            "lat": float(np.round(rng.uniform(-60.0, 60.0), 4)),
            "lon": float(np.round(rng.uniform(-170.0, 170.0), 4)),
            "alt": float(np.round(rng.uniform(500.0, 30000.0), 1))}


def circular_baseband(truth: dict, period: int, fs: float) -> np.ndarray:
    """complex64 [period]: the truth's frames back to back from sample 0."""
    family = truth["family"]
    chips, rate = _FRAME[family]
    k = int(np.ceil(period / (fs / rate) / chips)) + 1
    pos = dict(lat=truth["lat"], lon=truth["lon"], alt=truth["alt"])
    if family == "rs41":
        iq = RS41Modulator().modulate(
            [RS41Truth(serial=truth["serial"], frame_no=i, **pos)
             for i in range(k)], fs=fs)
    elif family == "m10":
        iq = M10Modulator().modulate(
            [M10Truth(serial=truth["serial"], frame_no=8 + i, **pos)
             for i in range(k)], fs=fs)
    else:
        iq = DFMModulator().modulate(
            [DFMTruth(serial_num=int(truth["serial"]), frame_no=2 + i, **pos)
             for i in range(k)], fs=fs)
    if iq.shape[0] < period:
        raise ValueError(f"{family}: {iq.shape[0]} samples for a period of "
                         f"{period}")
    return iq[:period]


def numpy_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) & (2 ** 64 - 1))


def torch_generator(torch, seed: int, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2 ** 63 - 1))
    return g


class Ring:
    """The inputs of a stream that cycles through ``blocks``: each entry is
    the tuple of tensors that one call of the entry takes; ``truths`` maps
    a row (channel or PFB bin) to the truth it carries."""

    def __init__(self, blocks, truths: dict, info: dict):
        self.blocks = blocks
        self.truths = truths
        self.info = info

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for b in self.blocks for t in b)
