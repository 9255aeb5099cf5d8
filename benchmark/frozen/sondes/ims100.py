"""Meisei iMS-100 / RS-11G protocol: GFSK + shortened BCH + even/odd halves
(counterpart: ``sondetpu_torch/sondes/ims100.py``), frozen for the
benchmark.

A copy of the port's spec, frame assembly and modulator, with nothing of
the program imported. It registers the ims100 family in the frozen
registry when imported (``benchmark/frozen/sondes/__init__.py`` registers
rs41, m10 and dfm; the modules that read ims100 import this one).

On-air structure (per-field provenance in PROTOCOLS.md "ims100"):

  physical: 2400 Bd GFSK NRZ, deviation 2400 Hz, 20 kHz channel.
  subframe (576 bits = 72 bytes):
    bits  0- 23  sync 0xFB6230
    bits 24-575  12 blocks of 46 bits, each a shortened BCH(63,51) t=2
                 codeword (34 data bits + 12 parity bits) carrying two
                 big-endian 16-bit words: w[0..23].
  Subframes alternate EVEN (position) / ODD (PTU, serial) halves keyed by
  the frame counter's parity:

    w0        u16  frame counter (parity selects the half)
    w1        u16  type word: iMS-100 or RS-11G
    EVEN: w2|w3 ms of the UTC day, w4|w5 date YYMMDD, w6|w7 latitude and
          w8|w9 longitude (NMEA x 1e4, sign in bit 31), w10|w11 altitude
          (cm, i32), w12 ground speed (0.01 kt), w13 heading (0.01 deg)
    ODD:  w2 temperature (cK), w3 RH (c%), w4|w5 serial (decimal; RS-11G
          ids are printed with an "R" prefix)
"""

from __future__ import annotations

from typing import List

import numpy as np

from benchmark.frozen.fec.bch import bch_46_34_encode
from benchmark.frozen.sondes import geo
from benchmark.frozen.sondes.base import ProtocolSpec, register_sonde
from benchmark.frozen.sondes.modulate import gfsk_modulate
from benchmark.frozen.sync.coding import np_bits_to_bytes, np_bytes_to_bits

BAUD = 2400.0
FRAME_BYTES = 72
SYNCWORD = bytes([0xFB, 0x62, 0x30])
N_BLOCKS = 12
DATA_BITS = 34                # 51 - 17 zero bits
BLOCK_BITS = 46               # 63 - 17 zero bits
N_WORDS = 2 * N_BLOCKS        # two 16-bit words per block

KNOTS2MS = 0.514444           # transmitted speed unit is centi-knots

# subframe type words
TYPE_IMS100 = 0x0165
TYPE_RS11G = 0x0247

SPEC = ProtocolSpec(
    name="ims100",
    display_name="iMS100/RS-11G",
    bandwidth=2e4,
    baud=BAUD,
    modulation="gfsk",
    syncword=SYNCWORD,
    lsb_first=False,
    frame_bytes=FRAME_BYTES,
    line_code="nrz",
    deviation=2400.0,
    extra={"dc_mode": "midpoint", "fsk_dualtone": True},
)


def words_to_block_bits(words: np.ndarray) -> np.ndarray:
    """[24] u16 words -> [12, 46] shortened-codeword bit matrix."""
    w = np.asarray(words, np.uint64).reshape(N_BLOCKS, 2)
    data = np.zeros((N_BLOCKS, DATA_BITS), np.uint8)
    for k in range(16):
        data[:, k] = (w[:, 0] >> (15 - k)) & 1
        data[:, 16 + k] = (w[:, 1] >> (15 - k)) & 1
    return bch_46_34_encode(data)


def deg_to_nmea(deg: float) -> int:
    """Decimal degrees -> NMEA (d)ddmm.mmmm x 1e4, sign in bit 31."""
    sign = 0x80000000 if deg < 0 else 0
    deg = abs(deg)
    d = int(deg)
    minutes = (deg - d) * 60.0
    return sign | (d * 1000000 + int(round(minutes * 1e4)))


class IMS100Truth:
    def __init__(self, serial="2136051", frame_no=1, lat=35.7, lon=139.7,
                 alt=18000.0, speed=20.0, heading=45.0, climb=4.0,
                 temp=-60.0, rh=8.0, time_utc=1.7e9, rs11g=False):
        self.serial, self.frame_no = serial, frame_no
        self.lat, self.lon, self.alt = lat, lon, alt
        self.speed, self.heading, self.climb = speed, heading, climb
        self.temp, self.rh, self.time_utc = temp, rh, time_utc
        self.rs11g = rs11g


class IMS100Modulator:
    spec = SPEC

    def build_frame(self, t: IMS100Truth, half: int) -> np.ndarray:
        w = np.zeros(N_WORDS, dtype=np.uint32)
        fn = (t.frame_no & ~1) | (half & 1)
        w[0] = fn & 0xFFFF
        w[1] = TYPE_RS11G if t.rs11g else TYPE_IMS100
        if half % 2 == 0:
            y, mo, d, sod = geo.utc_to_ymd_sod(t.time_utc)
            ms = int(round(sod * 1000.0))
            w[2], w[3] = ms >> 16, ms & 0xFFFF
            date = (y % 100) * 10000 + mo * 100 + d
            w[4], w[5] = date >> 16, date & 0xFFFF
            lat = deg_to_nmea(t.lat)
            lon = deg_to_nmea(t.lon)
            w[6], w[7] = lat >> 16, lat & 0xFFFF
            w[8], w[9] = lon >> 16, lon & 0xFFFF
            alt = int(round(t.alt * 100)) & 0xFFFFFFFF
            w[10], w[11] = alt >> 16, alt & 0xFFFF
            w[12] = int(round(t.speed / KNOTS2MS * 100)) & 0xFFFF
            w[13] = int(round(t.heading * 100)) % 36000
        else:
            w[2] = int(round((t.temp + 273.15) * 100)) & 0xFFFF
            w[3] = int(round(t.rh * 100)) & 0xFFFF
            sn = int(t.serial.lstrip("R"))
            w[4], w[5] = sn >> 16, sn & 0xFFFF
        blk = words_to_block_bits(w)                       # [12, 46]
        bits = np.zeros(FRAME_BYTES * 8, dtype=np.uint8)
        bits[0:24] = np_bytes_to_bits(np.frombuffer(SYNCWORD, np.uint8))
        bits[24:24 + N_BLOCKS * BLOCK_BITS] = blk.reshape(-1)
        return np_bits_to_bytes(bits)

    def modulate(self, truths: List[IMS100Truth], fs: float = 48000.0,
                 bt: float = 0.5) -> np.ndarray:
        """Alternating even/odd half-frames."""
        frames = [self.build_frame(t, half=k % 2)
                  for k, t in enumerate(truths)]
        bits = np_bytes_to_bits(np.stack(frames)).reshape(-1)
        return gfsk_modulate(bits, fs / BAUD, SPEC.dev / fs, bt=bt)


register_sonde("ims100", SPEC, IMS100Modulator)
