"""Meteomodem M10/M20 protocol: 9600 cps biphase-mark + rolling checksum
(counterpart: ``sondetpu/sondes/m10.py``).

A jax-free copy of the original, which is reached only through
``sondetpu.sondes``, whose package import pulls in every family and
jax. It registers the m10 family in the port's registry.

Re-creates sondedump's M10 decoder capability (SURVEY.md S3; reference API
decoder.hpp:11; 9600 Bd GFSK + Manchester/biphase deframe + checksum verify
per BASELINE.json:8; 50 kHz channel bandwidth per main.hpp:48; M10 has RH,
M20 does not, README.md:11,13).

REAL on-air layout (public protocol; per-field provenance in PROTOCOLS.md
"m10"). The gather window is [2 preamble-tail bytes 0xAA 0xAA][frame]:

  M10 frame (101 bytes, all multi-byte fields BIG-endian):
    0x00  u8   0x64  (= 100, bytes following the length byte)
    0x01  2B   0x9F 0x20 frame type (Trimble GPS variant)
    0x04  3 x i16  vE, vN, vU  cm/s
    0x0A  u32  GPS time of week, ms
    0x0E  i32  latitude,  1e-6 deg
    0x12  i32  longitude, 1e-6 deg
    0x16  i32  altitude,  mm
    0x20  u16  GPS week
    0x32  u24  RH reference-capacitance counts   [public-partial]
    0x35  u24  RH sensor-capacitance counts      [public-partial]
    0x49  u16  NTC ADC counts (Shibaura PB5-41E thermistor; PROTOCOLS.md)
    0x5D  5B   serial number bytes -> printed id "XNN-T-NNNNN"
    0x63  u16  rolling checksum over bytes 0x00..0x62
  RH is derived from the capacitance ratio r = C/C_ref as
  RH = (r - 0.8955) / 0.002 % (capacitive-sensor model first published by
  DF9DQ and carried by the open M10 decoders; offsets/constants
  public-partial — reconstructed, unverified against recorded IQ).

  M20 frame (70 bytes, big-endian; public layout of the open decoder
  ecosystem, per-field provenance in PROTOCOLS.md "m10"):
    0x00  u8   0x45  (= 69, bytes following the length byte)
    0x01  u8   0x20  frame type
    0x02  u16  NTC ADC counts (position reconstructed, low confidence)
    0x08  u24  altitude, cm
    0x0F  u24  GPS time of week, s
    0x12  3B   serial number bytes
    0x15  u8   frame counter
    0x16  u16  inner block checksum over 0x02..0x15 (same rolling alg)
    0x18  i16  vE cm/s;  0x1A  i16  vN cm/s
    0x1C  i32  latitude,  1e-6 deg
    0x20  i32  longitude, 1e-6 deg
    0x24  i16  vU cm/s
    0x26  u16  GPS week
    0x44  u16  rolling checksum over bytes 0x00..0x43
  No RH sensor (README.md:13). When the outer checksum fails but the inner
  block checksum passes, the 0x02..0x15 block (alt/time/serial/counter) is
  still accepted — the blocked layout exists exactly so receivers can
  salvage the inner packet.

Both subtypes decode on the same "m10" channel — the gather window is 103
bytes and frames dispatch on the length/type bytes (mirroring the
reference's single M10/M20 entry, main.hpp:48).

Frozen for the benchmark: the spec, the frame assembly and the modulator;
the decoder is left out.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from benchmark.frozen.sondes import geo
from benchmark.frozen.sondes.base import ProtocolSpec, register_sonde
from benchmark.frozen.sondes.modulate import gfsk_modulate
from benchmark.frozen.sync.coding import np_bytes_to_bits

CHIP_RATE = 9600.0
M10_LEN = 101                 # 0x64 + 1
M20_LEN = 70                  # 0x45 + 1
FRAME_BYTES = 2 + M10_LEN     # window: preamble tail + longest frame
SYNCWORD = bytes([0xAA, 0xAA, 0x64, 0x9F, 0x20])

SPEC = ProtocolSpec(
    name="m10",
    display_name="M10/M20",
    bandwidth=5e4,            # main.hpp:48
    baud=CHIP_RATE,
    modulation="gfsk",
    syncword=SYNCWORD,
    lsb_first=False,
    frame_bytes=FRAME_BYTES,
    line_code="biphase_m",
    deviation=12000.0,
    extra={"abs_corr": True,     # biphase-M polarity ambiguity
           # dev 12 kHz >> baud: the FM discriminator clicks below ~8 dB
           # SNR; the dual-tone noncoherent front end has no threshold
           # (runtime/pipeline.py _dualtone)
           "fsk_dualtone": True,
           # M20 subtype shares the channel but has its own length/type
           "alt_syncword": bytes([0xAA, 0xAA, 0x45, 0x20]),
           # soft-decision assist: device ranks the 8 weakest decoded
           # bits per frame for the host's Chase checksum repair — once
           # over the full M10 window and once over the M20 subframe span
           # so short M20 frames get in-frame candidates (PROTOCOLS.md)
           "chase_m": 12,
           "chase_spans": ((0, (2 + M10_LEN) * 8), (0, (2 + M20_LEN) * 8))},
)

# Shibaura PB5-41E NTC Steinhart-Hart (1/T = p0+p1*L+p2*L^2+p3*L^3, L=lnR)
_P = (1.07303516e-3, 2.41296733e-4, 2.26744154e-6, 6.52855181e-8)
_RS = 12.1e3                  # series resistor of the ADC divider

# M10 capacitive RH model (DF9DQ-derived, public-partial; PROTOCOLS.md):
# RH% = (C/C_ref - _RH_C0) / _RH_C1
_RH_C0, _RH_C1 = 0.8955, 0.002


def m10_rh_counts(rh: float, ref_counts: int = 1 << 20) -> Tuple[int, int]:
    """Inverse of m10_rh (for the modulator)."""
    return int(round(ref_counts * (_RH_C0 + _RH_C1 * rh))), ref_counts


def m10_checksum(data: np.ndarray) -> int:
    """The M10/M20 rolling 16-bit checksum (public algorithm).

    Per-byte update: the byte is rotated and self-XORed, the low state byte
    feeds back through a parity-tap permutation, the high state byte shifts
    down (PROTOCOLS.md m10)."""
    c = 0
    for x in np.asarray(data, dtype=np.uint8):
        b = int(x)
        c1 = c & 0xFF
        b = ((b >> 1) | ((b & 1) << 7))
        b ^= (b >> 2) & 0xFF
        t6 = (c & 1) ^ ((c >> 2) & 1) ^ ((c >> 4) & 1)
        t7 = ((c >> 1) & 1) ^ ((c >> 3) & 1) ^ ((c >> 5) & 1)
        t = (c & 0x3F) | (t6 << 6) | (t7 << 7)
        s = (c >> 7) & 0xFF
        s ^= (s >> 2) & 0xFF
        c0 = b ^ t ^ s
        c = ((c1 << 8) | (c0 & 0xFF)) & 0xFFFF
    return c


_SYND_CACHE: dict = {}
_SYND_POS_CACHE: dict = {}


def ntc_adc(temp_c: float) -> int:
    """Inverse of ntc_temp (for the modulator)."""
    target = 1.0 / (temp_c + 273.15)
    roots = np.roots([_P[3], _P[2], _P[1], _P[0] - target])
    real = [x.real for x in roots if abs(x.imag) < 1e-9 and 0.0 < x.real < 20.0]
    r = float(np.exp(min(real, key=lambda x: abs(x - 9.5))))
    return int(round(4096.0 * r / (_RS + r)))


class M10Truth:
    def __init__(self, serial="910-2-12345", frame_no=1, lat=52.2, lon=21.0,
                 alt=15000.0, ve=-4.0, vn=9.0, vu=5.0, temp=-55.0, rh=12.0,
                 time_utc=1.7e9, m20=False):
        self.serial, self.frame_no = serial, frame_no
        self.lat, self.lon, self.alt = lat, lon, alt
        self.ve, self.vn, self.vu = ve, vn, vu
        self.temp, self.rh, self.time_utc = temp, rh, time_utc
        self.m20 = m20

    @property
    def time_eff(self):
        """Frames are distinguished by GPS time (M10 has no frame counter)."""
        return self.time_utc + float(self.frame_no)


def _serial_bytes(serial: str) -> np.ndarray:
    """Inverse of m10_serial for the modulator ("XNN-T-NNNNN")."""
    a, t, num = serial.split("-")
    b = np.zeros(5, np.uint8)
    b[0] = (int(a[0], 16) << 4) | int(a[1:])
    b[1] = int(t) & 0xF
    n = int(num)
    b[2], b[3], b[4] = (n >> 16) & 0xFF, (n >> 8) & 0xFF, n & 0xFF
    return b


def _m20_serial_bytes(serial: str) -> np.ndarray:
    """Inverse of m20_serial ("XNN-NNNNN" with X a hex digit and NN <= 15;
    tolerates the 3-part M10 form by dropping the middle group). Rejects
    out-of-range groups rather than silently corrupting the round trip."""
    parts = serial.split("-")
    a, num = parts[0], int(parts[-1]) & 0xFFFF
    grp = int(a[1:])
    if not 0 <= grp <= 15:
        raise ValueError(f"M20 serial group {grp} exceeds the 4-bit field "
                         f"of the printed form ({serial!r})")
    b = np.zeros(3, np.uint8)
    b[0] = (int(a[0], 16) << 4) | grp
    b[1], b[2] = (num >> 8) & 0xFF, num & 0xFF
    return b


class M10Modulator:
    spec = SPEC

    def build_frame(self, t: M10Truth) -> np.ndarray:
        """On-air window image: [0xAA 0xAA][frame], zero-padded to the
        gather width so back-to-back frames keep fixed chip spacing."""
        w = np.zeros(FRAME_BYTES, dtype=np.uint8)
        w[0:2] = (0xAA, 0xAA)
        f = w[2:]
        week, tow = geo.utc_to_gps_time(t.time_eff)
        if t.m20:
            f[0], f[1] = 0x45, 0x20
            f[0x02:0x04] = np.frombuffer(struct.pack(
                ">H", ntc_adc(t.temp)), np.uint8)
            f[0x08:0x0B] = np.frombuffer(int(round(t.alt * 100)).to_bytes(
                3, "big"), np.uint8)
            f[0x0F:0x12] = np.frombuffer(int(round(tow)).to_bytes(
                3, "big"), np.uint8)
            f[0x12:0x15] = _m20_serial_bytes(t.serial)
            f[0x15] = t.frame_no & 0xFF
            f[0x16:0x18] = np.frombuffer(struct.pack(
                ">H", m10_checksum(f[0x02:0x16])), np.uint8)
            f[0x18:0x1C] = np.frombuffer(struct.pack(
                ">hh", int(round(t.ve * 100)), int(round(t.vn * 100))), np.uint8)
            f[0x1C:0x24] = np.frombuffer(struct.pack(
                ">ii", int(round(t.lat * 1e6)), int(round(t.lon * 1e6))), np.uint8)
            f[0x24:0x26] = np.frombuffer(struct.pack(
                ">h", int(round(t.vu * 100))), np.uint8)
            f[0x26:0x28] = np.frombuffer(struct.pack(">H", int(week)), np.uint8)
            f[0x44:0x46] = np.frombuffer(struct.pack(
                ">H", m10_checksum(f[0:0x44])), np.uint8)
            return w
        f[0], f[1], f[2] = 0x64, 0x9F, 0x20
        f[0x04:0x0A] = np.frombuffer(struct.pack(
            ">hhh", int(round(t.ve * 100)), int(round(t.vn * 100)),
            int(round(t.vu * 100))), np.uint8)
        f[0x0A:0x0E] = np.frombuffer(struct.pack(
            ">I", int(round(tow * 1000))), np.uint8)
        f[0x0E:0x1A] = np.frombuffer(struct.pack(
            ">iii", int(round(t.lat * 1e6)), int(round(t.lon * 1e6)),
            int(round(t.alt * 1000))), np.uint8)
        f[0x20:0x22] = np.frombuffer(struct.pack(">H", int(week)), np.uint8)
        rh_cnt, rh_ref = m10_rh_counts(t.rh)
        f[0x32:0x35] = np.frombuffer(rh_ref.to_bytes(3, "big"), np.uint8)
        f[0x35:0x38] = np.frombuffer(rh_cnt.to_bytes(3, "big"), np.uint8)
        f[0x49:0x4B] = np.frombuffer(struct.pack(
            ">H", ntc_adc(t.temp)), np.uint8)
        f[0x5D:0x62] = _serial_bytes(t.serial)
        f[0x63:0x65] = np.frombuffer(struct.pack(
            ">H", m10_checksum(f[0:0x63])), np.uint8)
        return w

    def frames_to_chips(self, frames: np.ndarray) -> np.ndarray:
        """Biphase-mark encode (continuous level across the whole stream)."""
        bits = np_bytes_to_bits(np.atleast_2d(frames), lsb_first=False).reshape(-1)
        chips = np.empty(bits.size * 2, dtype=np.uint8)
        level = 0
        for k, b in enumerate(bits):
            level ^= 1
            chips[2 * k] = level
            if b:
                level ^= 1
            chips[2 * k + 1] = level
        return chips

    def modulate(self, truths: List[M10Truth], fs: float = 48000.0,
                 bt: float = 0.7) -> np.ndarray:
        frames = np.stack([self.build_frame(t) for t in truths])
        chips = self.frames_to_chips(frames)
        return gfsk_modulate(chips, fs / CHIP_RATE, SPEC.dev / fs, bt=bt)


register_sonde("m10", SPEC, M10Modulator)
