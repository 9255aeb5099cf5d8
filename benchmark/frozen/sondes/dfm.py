"""GRAW DFM06/09/17 protocol: 2500 cps Manchester + interleaved Hamming(8,4)
(counterpart: ``sondetpu/sondes/dfm.py``).

A jax-free copy of the original, which is reached only through
``sondetpu.sondes``, whose package import pulls in every family and
jax. It registers the dfm family in the port's registry.

Re-creates sondedump's DFM decoder capability (SURVEY.md S2; reference API
decoder.hpp:8; 2500 Bd + Hamming + multi-subframe per BASELINE.json:9;
channel bandwidth 15 kHz per main.hpp:46; GPS+T only, no RH, README.md:12;
covers DFM06/09/17, README.md:12).

REAL on-air layout (public protocol as established by the open-source
decoder ecosystem; per-field provenance audit in PROTOCOLS.md "dfm"):

  physical: 2FSK, 2500 Manchester chips/s -> 1250 bit/s data. DFM06 and
    DFM09/17 transmit mutually inverted polarity: the device correlator
    matches |corr| (SPEC.extra['abs_corr']) and the parser accepts the
    complemented sync, flipping the whole frame.
  frame (280 bits, ~4.46 frames/s):
    bits   0- 15   sync 0x45CF
    bits  16- 71   CONF block:  7 Hamming(8,4) codewords, bit-interleaved
    bits  72-175   DAT1 block: 13 codewords, bit-interleaved
    bits 176-279   DAT2 block: 13 codewords, bit-interleaved
  interleave (per block of L codewords): transmitted bit t carries bit
    (t div L) of codeword (t mod L) — all first bits of every codeword go
    first, then all second bits, ...
  CONF (7 decoded nibbles): [channel u4][value u24].
    Channels 0..4: analog measurements, value is float24
    (exp u4 | mantissa u20; f = mant / 2^exp): ch0 NTC counts, ch3 base
    reference, ch4 220 kOhm reference. T from
    R = 220e3 * (m0-m3)/(m4-m3), Steinhart-Hart (EPCOS B57540G0502 5k).
    Channels >= 5: config/serial. The HIGHEST channel seen identifies the
    subtype (0x6 DFM06, 0xA DFM09, 0xB DFM17, 0xC DFM09P, 0xD DFM17) and
    carries the serial: DFM06 as 6 BCD digits; newer types as two
    alternating 16-bit chunks indexed by the value's low nibble.
  DAT (13 decoded nibbles = 48 data bits MSB-first + channel u4 in the
    LAST nibble):
    ch0: frame counter u8 @ bits 24-31
    ch1: millisecond-of-minute u16 @ bits 32-47
    ch2: lat i32 1e-7 deg @ 0-31, horizontal speed u16 cm/s @ 32-47
    ch3: lon i32 1e-7 deg @ 0-31, heading u16 centi-deg @ 32-47
    ch4: alt u32 cm @ 0-31, climb i16 cm/s @ 32-47
    ch8: date: year u12 @0 | month u4 @12 | day u5 @16 | hour u5 @21 |
         minute u6 @26
  UTC time = date(ch8) + msec-of-minute(ch1). No RH sensor (README.md:12).

Frozen for the benchmark: the spec, the frame assembly and the modulator;
the decoder is left out.
"""

from __future__ import annotations

import time as _time
from typing import List

import numpy as np

from benchmark.frozen.fec.hamming import hamming84_encode
from benchmark.frozen.sondes.base import ProtocolSpec, register_sonde
from benchmark.frozen.sondes.modulate import gfsk_modulate
from benchmark.frozen.sync.coding import np_bytes_to_bits

CHIP_RATE = 2500.0            # on-air Manchester chip rate (BASELINE.json:9)
FRAME_BITS = 280
FRAME_BYTES = 35
SYNCWORD = bytes([0x45, 0xCF])
SYNC_INVERTED = bytes([0xBA, 0x30])   # DFM06 vs DFM09/17 polarity flip
CONF_BITS = slice(16, 72)     # 7 codewords x 8 bits, interleaved
DAT1_BITS = slice(72, 176)    # 13 codewords
DAT2_BITS = slice(176, 280)

SPEC = ProtocolSpec(
    name="dfm",
    display_name="DFM06/09/17",
    bandwidth=1.5e4,          # main.hpp:46
    baud=CHIP_RATE,
    modulation="gfsk",
    syncword=SYNCWORD,
    lsb_first=False,
    frame_bytes=FRAME_BYTES,
    line_code="manchester",
    deviation=2500.0,
    extra={"abs_corr": True},     # DFM06 / DFM09 polarity ambiguity
)

# subtype from the serial-bearing (highest) config channel (PROTOCOLS.md)
DFM_TYPES = {0x6: "DFM06", 0x7: "PS-15", 0xA: "DFM09", 0xB: "DFM17",
             0xC: "DFM09P", 0xD: "DFM17"}

# EPCOS B57540G0502 5k NTC Steinhart-Hart (1/T = p0+p1*L+p2*L^2+p3*L^3,
# L = ln R); reference resistor 220 kOhm
_P = (1.09698417e-03, 2.39564629e-04, 2.48821437e-06, 5.84354921e-08)
_RF = 220e3

_W8 = np.array([128, 64, 32, 16, 8, 4, 2, 1], dtype=np.int64)


def fl24_encode(f: float) -> int:
    """Inverse of fl24 with the largest exponent that keeps 20 bits."""
    p = 0
    while p < 15 and f * (1 << (p + 1)) < (1 << 20):
        p += 1
    mant = min(int(round(f * (1 << p))), (1 << 20) - 1)
    return (p << 20) | mant


def ntc_resistance(temp_c: float) -> float:
    """Inverse of ntc_temp's Steinhart-Hart (for the modulator)."""
    target = 1.0 / (temp_c + 273.15)
    roots = np.roots([_P[3], _P[2], _P[1], _P[0] - target])
    real = [r.real for r in roots if abs(r.imag) < 1e-9 and 0.0 < r.real < 20.0]
    return float(np.exp(min(real, key=lambda x: abs(x - 10.0))))


def _interleave(codewords: np.ndarray) -> np.ndarray:
    """Codeword bytes [n_cw] -> interleaved on-air bits [8*n_cw]."""
    bits = np_bytes_to_bits(np.asarray(codewords, np.uint8))  # [n_cw*8]
    return bits.reshape(-1, 8).T.reshape(-1)


def _b2v(bits: np.ndarray, i: int, n: int, signed: bool = False) -> int:
    """MSB-first bits[i:i+n] -> integer."""
    v = 0
    for b in bits[i:i + n]:
        v = (v << 1) | int(b)
    if signed and v >= 1 << (n - 1):
        v -= 1 << n
    return v


def _v2b(bits: np.ndarray, i: int, n: int, val: int) -> None:
    """Write integer MSB-first into bits[i:i+n]."""
    val &= (1 << n) - 1
    for k in range(n):
        bits[i + k] = (val >> (n - 1 - k)) & 1


class DFMTruth:
    def __init__(self, serial_num=1234567, subtype=0xA, frame_no=1, lat=47.0,
                 lon=8.5, alt=8000.0, speed=12.0, heading=270.0, climb=3.5,
                 temp=-20.0, time_utc=1.7e9):
        self.serial_num, self.subtype, self.frame_no = serial_num, subtype, frame_no
        self.lat, self.lon, self.alt = lat, lon, alt
        self.speed, self.heading, self.climb = speed, heading, climb
        self.temp, self.time_utc = temp, time_utc


class DFMModulator:
    spec = SPEC

    M3_BASE, M4_REF = 1024.0, 221024.0   # refs: R = 220e3*(m0-m3)/(m4-m3)

    # CONF channel rotation: PTU triple interleaved with the two serial
    # chunks on the subtype's serial channel; DAT pairs cycle the GPS set
    CONF_CYCLE = (0, 3, "sn0", 4, 0, 3, "sn1", 4)
    DAT_CYCLE = ((0, 1), (2, 3), (4, 8))

    def build_frame(self, truth: DFMTruth, k: int) -> np.ndarray:
        """Frame ``k`` of the cycle for this truth (on-air byte image)."""
        bits = np.zeros(FRAME_BITS, np.uint8)
        bits[0:16] = np_bytes_to_bits(np.frombuffer(SYNCWORD, np.uint8))

        sel = self.CONF_CYCLE[k % len(self.CONF_CYCLE)]
        if sel in ("sn0", "sn1"):
            chan = truth.subtype
            if truth.subtype == 0x6:
                # DFM06: the serial is 6 BCD digits in one transmission
                val = int("%06d" % (truth.serial_num % 1000000), 16)
            elif sel == "sn0":
                val = (((truth.serial_num >> 16) & 0xFFFF) << 4) | 0
            else:
                val = ((truth.serial_num & 0xFFFF) << 4) | 1
        elif sel == 0:
            chan = 0
            r = ntc_resistance(truth.temp)
            m0 = self.M3_BASE + r * (self.M4_REF - self.M3_BASE) / _RF
            val = fl24_encode(m0)
        else:
            chan = sel
            val = fl24_encode(self.M3_BASE if sel == 3 else self.M4_REF)
        nib = [chan] + [(val >> s) & 0xF for s in (20, 16, 12, 8, 4, 0)]
        bits[CONF_BITS] = _interleave(hamming84_encode(np.array(nib, np.uint8)))

        for sl, sub in zip((DAT1_BITS, DAT2_BITS),
                           self.DAT_CYCLE[k % len(self.DAT_CYCLE)]):
            dbits = self._subframe(sub, truth)
            nibs = [_b2v(dbits, 4 * i, 4) for i in range(13)]
            bits[sl] = _interleave(hamming84_encode(np.array(nibs, np.uint8)))

        out = np.zeros(FRAME_BYTES, np.uint8)
        for i in range(FRAME_BYTES):
            out[i] = _b2v(bits, 8 * i, 8)
        return out

    def _subframe(self, idx: int, t: DFMTruth) -> np.ndarray:
        d = np.zeros(52, np.uint8)
        if idx == 0:
            _v2b(d, 24, 8, t.frame_no & 0xFF)
        elif idx == 1:
            _v2b(d, 32, 16, int(round((t.time_utc % 60.0) * 1000)))
        elif idx == 2:
            _v2b(d, 0, 32, int(round(t.lat * 1e7)))
            _v2b(d, 32, 16, int(round(t.speed * 100)))
        elif idx == 3:
            _v2b(d, 0, 32, int(round(t.lon * 1e7)))
            _v2b(d, 32, 16, int(round(t.heading * 100)) % 36000)
        elif idx == 4:
            _v2b(d, 0, 32, int(round(t.alt * 100)))
            _v2b(d, 32, 16, int(round(t.climb * 100)))
        elif idx == 8:
            tm = _time.gmtime(t.time_utc - (t.time_utc % 60.0))
            _v2b(d, 0, 12, tm.tm_year)
            _v2b(d, 12, 4, tm.tm_mon)
            _v2b(d, 16, 5, tm.tm_mday)
            _v2b(d, 21, 5, tm.tm_hour)
            _v2b(d, 26, 6, tm.tm_min)
        _v2b(d, 48, 4, idx)
        return d

    def frames_to_chips(self, frames: np.ndarray, invert: bool = False
                        ) -> np.ndarray:
        bits = np_bytes_to_bits(np.atleast_2d(frames), lsb_first=False)
        if invert:
            bits = 1 - bits                # DFM06-polarity transmission
        chips = np.empty(bits.shape[:-1] + (bits.shape[-1] * 2,), np.uint8)
        chips[..., 0::2] = bits
        chips[..., 1::2] = 1 - bits
        return chips.reshape(-1)

    def modulate(self, truths: List[DFMTruth], fs: float = 48000.0,
                 bt: float = 0.5, invert: bool = False) -> np.ndarray:
        """Back-to-back frames cycling CONF channels and DAT subframes;
        ``invert`` transmits the opposite (DFM06-style) polarity."""
        frames = [self.build_frame(t, k) for k, t in enumerate(truths)]
        chips = self.frames_to_chips(np.stack(frames), invert=invert)
        return gfsk_modulate(chips, fs / CHIP_RATE, SPEC.dev / fs, bt=bt)


register_sonde("dfm", SPEC, DFMModulator)
