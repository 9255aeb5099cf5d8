"""Vaisala RS41-SG protocol: frame codec, parser, calibration, modulator
(counterpart: ``sondetpu/sondes/rs41.py``).

A jax-free copy of the original, which imports jax through
``sondetpu.sondes`` and ``sondetpu.sync.coding``. It registers the rs41 and
rs41x families in the port's registry.

Re-creates sondedump's RS41 decoder capability (SURVEY.md S1; reference API
consumed at decoder.hpp:13,22; 4800 Bd GFSK + RS(255,231) per
BASELINE.json:7; channel bandwidth 10 kHz per main.hpp:45).

Physical layer (publicly documented; re-verify against recorded IQ per
SURVEY.md §7 "protocol ground truth"):
- 4800 Bd GFSK, bits LSB-first within bytes, frames transmitted
  back-to-back; 320-byte standard frame.
- Whole frame whitened by XOR with a repeating 64-byte PRN mask; the
  scrambled-domain frame starts with the well-known 64-bit syncword
  0x10 B6 CA 11 22 96 12 F8.
- Bytes 8..55 carry two interleaved Reed-Solomon RS(255,231) codewords
  (field poly 0x11D, fcr 0): codeword i protects frame[0x38 + 2k + i].

Frame layout (offsets marked [inferred] follow public decoder conventions
where documented and this framework's own definition elsewhere; the
modulator and parser are exactly consistent, which is what the golden-IQ
acceptance tests verify):
  0x000  8B  syncword (scrambled domain)
  0x008 48B  RS parity (2 x 24)
  0x038  1B  frame type (0x0F = standard)
  0x039  blocks, each [type u8][len u8][data][crc16-CCITT over data, LE]:
    0x79 STATUS len 0x28: frame_no u16le@0, serial char[8]@2, battery
         decivolts u8@10, flags u8@11, burstkill seconds u16le@18
         (0xFFFF = inactive) [inferred], calib page u8@23, calib
         fragment 16B@24
    0x7A MEAS   len 0x2A: 8 x u24le ADC: temp_main, temp_ref1, temp_ref2,
         hum_main, hum_ref1, hum_ref2, tsens_hum, spare
    0x7C GPSINFO len 0x1E: week u16le@0, itow_ms u32le@2, 12 x (sv,cno)
    0x7D GPSRAW len 0x59: opaque raw measurements
    0x7B GPSPOS len 0x15: ecef x,y,z i32le cm, vx,vy,vz i16le cm/s,
         numSV u8, sAcc u8, pDOP u8
    0x7E XDATA  len 0x11: ASCII auxiliary data (ozone: "xx.xx mPa")
Calibration blob: 51 pages x 16 bytes accumulated from STATUS fragments
(reference semantics decoder.hpp:85-86: calib_percent = pages/51*100);
temperature polynomial t0,t1,t2 f32le at blob[0x20:0x2C] (page 2), humidity
h0,h1,h2 at blob[0x30:0x3C] (page 3); physical value = p0 + p1*r + p2*r^2
with r = (main - ref1) / (ref2 - ref1).

Frozen for the benchmark: the spec, the frame assembly and the modulator;
the decoder is left out.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from benchmark.frozen.fec.crc import crc16_ccitt
from benchmark.frozen.fec.rs import ReedSolomon
from benchmark.frozen.sondes import geo
from benchmark.frozen.sondes.base import ProtocolSpec, register_sonde
from benchmark.frozen.sondes.modulate import gfsk_modulate
from benchmark.frozen.sync.coding import np_bytes_to_bits

# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------

BAUD = 4800.0
FRAME_BYTES = 320          # standard frame (frame type byte 0x0F)
FRAME_BYTES_EXT = 518      # extended frame with long XDATA (type 0xF0)
DATA_START = 0x38
FRAME_TYPE_STD, FRAME_TYPE_EXT = 0x0F, 0xF0
SYNCWORD = bytes([0x10, 0xB6, 0xCA, 0x11, 0x22, 0x96, 0x12, 0xF8])

# 64-byte whitening PRN (public RS41 constant)
WHITENING_MASK = np.array([
    0x96, 0x83, 0x3E, 0x51, 0xB1, 0x49, 0x08, 0x98,
    0x32, 0x05, 0x59, 0x0E, 0xF9, 0x44, 0xC6, 0x26,
    0x21, 0x60, 0xC2, 0xEA, 0x79, 0x5D, 0x6D, 0xA1,
    0x54, 0x69, 0x47, 0x0C, 0xDC, 0xE8, 0x5C, 0xF1,
    0xF7, 0x76, 0x82, 0x7F, 0x07, 0x99, 0xA2, 0x2C,
    0x93, 0x7C, 0x30, 0x63, 0xF5, 0x10, 0x2E, 0x61,
    0xD0, 0xBC, 0xB4, 0xB6, 0x06, 0xAA, 0xF4, 0x23,
    0x78, 0x6E, 0x3B, 0xAE, 0xBF, 0x7B, 0x4C, 0xC1,
], dtype=np.uint8)

RS_CODEC = ReedSolomon(nroots=24, fcr=0, prim_poly=0x11D)


def _n_rs_data(frame_len: int) -> int:
    """RS data symbols per interleaved codeword: 132 for the 320-byte frame
    (shortened) and 231 for the 518-byte extended frame (full-length)."""
    return (frame_len - DATA_START) // 2

CALIB_PAGES = 51
CALIB_BYTES = CALIB_PAGES * 16
RF1, RF2 = 750.0, 1100.0   # T reference resistors, Ohm (public constants)
_CAL_TEMP_OFF = 0x20       # 3 x f32le
_CAL_HUM_OFF = 0x30        # 3 x f32le
_CAL_TEMP_PAGE = _CAL_TEMP_OFF // 16
_CAL_HUM_PAGE = _CAL_HUM_OFF // 16

BLK_STATUS, BLK_MEAS, BLK_GPSINFO, BLK_GPSRAW, BLK_GPSPOS, BLK_XDATA, BLK_PAD = (
    0x79, 0x7A, 0x7C, 0x7D, 0x7B, 0x7E, 0x76)
_BLOCK_PLAN = [  # (type, data_len) in transmit order; offsets derived
    (BLK_STATUS, 0x28), (BLK_MEAS, 0x2A), (BLK_GPSINFO, 0x1E),
    (BLK_GPSRAW, 0x59), (BLK_GPSPOS, 0x15), (BLK_XDATA, 0x11),
]
# extended frame: identical through GPSPOS, then one long XDATA block that
# fills the remaining 518 - 0x12B - 4 = 215 bytes
_BLOCK_PLAN_EXT = _BLOCK_PLAN[:-1] + [(BLK_XDATA, 0xD7)]

SPEC = ProtocolSpec(
    name="rs41",
    display_name="RS41",
    bandwidth=1e4,            # main.hpp:45
    baud=BAUD,
    modulation="gfsk",
    syncword=SYNCWORD,
    lsb_first=True,
    frame_bytes=FRAME_BYTES,
    line_code="nrz",
    deviation=2400.0,
    # the device pipeline packs bits to bytes, de-whitens, and RS-syndrome
    # classifies frames on-device ("rs" feeds fec/syndrome.py's GF(2) matmul)
    extra={"whitening": WHITENING_MASK,
           "rs": {"data_start": DATA_START, "parity_start": 8, "nroots": 24,
                  "interleave": 2, "fcr": 0, "prim": 0x11D}},
)
# wire_columns is derived below from the block plan and attached post-hoc
# (the dict inside the frozen spec is shared by reference)


def _block_offsets(plan, frame_len):
    offs = []
    pos = DATA_START + 1
    for typ, dlen in plan:
        offs.append((typ, pos, dlen))
        pos += 2 + dlen + 2
    assert pos == frame_len, pos
    return offs


_BLOCK_OFFSETS = _block_offsets(_BLOCK_PLAN, FRAME_BYTES)
_BLOCK_OFFSETS_EXT = _block_offsets(_BLOCK_PLAN_EXT, FRAME_BYTES_EXT)

# Bytes of the data region the parser actually reads per block type (data
# offsets relative to block start). None = whole data field. The device
# reads back only these "wire columns" for RS-clean frames (the RS code
# covers every byte from 0x38 on, so a zero syndrome implies the block CRCs
# would pass — the CRC bytes need not cross the wire); suspect frames are
# fetched in full for host FEC. ~2.6x less device->host traffic per frame.
_WIRE_USED = {
    BLK_STATUS: 0x28,    # frame_no, serial, battery, flags, burstkill,
                         # calib page index + 16B fragment: keep all 40
    BLK_MEAS: 24,        # 8 x u24le ADC counts
    BLK_GPSINFO: 6,      # week u16 + itow
    BLK_GPSRAW: 0,       # opaque — header only
    BLK_GPSPOS: 21,      # ecef pos/vel + numSV/sAcc/pDOP
    BLK_XDATA: None,     # whole ASCII payload
}


def _wire_columns(offsets) -> np.ndarray:
    cols = [DATA_START]                      # frame-type byte
    for typ, pos, dlen in offsets:
        used = _WIRE_USED.get(typ, None)
        used = dlen if used is None else min(used, dlen)
        cols.extend(range(pos, pos + 2 + used))   # [type, len] header + data
    return np.asarray(cols, dtype=np.int32)


WIRE_COLUMNS = _wire_columns(_BLOCK_OFFSETS)
WIRE_COLUMNS_EXT = _wire_columns(_BLOCK_OFFSETS_EXT)
SPEC.extra["wire_columns"] = WIRE_COLUMNS


# ---------------------------------------------------------------------------
# Frame codec (shared by parser and modulator)
# ---------------------------------------------------------------------------

def scramble(frame: np.ndarray) -> np.ndarray:
    """XOR with the repeating whitening mask (involution)."""
    frame = np.asarray(frame, dtype=np.uint8)
    reps = -(-frame.shape[-1] // 64)
    mask = np.tile(WHITENING_MASK, reps)[: frame.shape[-1]]
    return frame ^ mask


def rs_encode_frame(frame: np.ndarray) -> np.ndarray:
    """Fill bytes 8..55 with the two interleaved RS(255,231) parities.

    Works for both frame lengths: 320-byte frames use the shortened code
    (132 data symbols), 518-byte extended frames the full-length code."""
    frame = frame.copy()
    nrs = _n_rs_data(frame.shape[-1])
    for i in range(2):
        data = frame[DATA_START + i::2][:nrs]
        cw = RS_CODEC.encode(data[None, :].astype(np.int32))[0]
        frame[8 + 24 * i: 8 + 24 * (i + 1)] = cw[nrs:]
    return frame


# ---------------------------------------------------------------------------
# Modulator (golden-IQ synthesis)
# ---------------------------------------------------------------------------

@dataclass
class RS41Truth:
    """Known telemetry for fixture generation."""

    serial: str = "S1234567"
    frame_no: int = 100
    lat: float = 45.0
    lon: float = 9.0
    alt: float = 12000.0
    ve: float = 5.0       # east, m/s
    vn: float = 8.0       # north
    vu: float = 4.5       # climb
    temp: float = -42.5
    rh: float = 35.0
    time_utc: float = 1.7e9
    burstkill: int = -1
    o3_mpa: Optional[float] = None
    battery_v: float = 2.9
    xdata_extra: str = ""    # extra XDATA payload (extended frames)


class RS41Modulator:
    spec = SPEC

    def __init__(self, calib_seed: int = 1234):
        rng = np.random.default_rng(calib_seed)
        blob = rng.integers(0, 256, size=CALIB_BYTES, dtype=np.uint8)
        # temperature poly in the RESISTANCE domain (decoder maps counts
        # -> Ohm through the RF1/RF2 reference pair): linear map placing
        # RF1..RF2 Ohm onto -100..+50 C
        t1 = 150.0 / (1100.0 - 750.0)
        blob[_CAL_TEMP_OFF:_CAL_TEMP_OFF + 12] = np.frombuffer(
            np.array([-100.0 - 750.0 * t1, t1, 0.0],
                     dtype="<f4").tobytes(), dtype=np.uint8)
        blob[_CAL_HUM_OFF:_CAL_HUM_OFF + 12] = np.frombuffer(
            np.array([0.0, 100.0, 0.0], dtype="<f4").tobytes(), dtype=np.uint8)
        self.calib_blob = blob

    # -- frame building ----------------------------------------------------

    def build_frame(self, truth: RS41Truth, extended: bool = False) -> np.ndarray:
        """Build one descrambled frame (syncword + parity included): 320
        bytes standard, 518 bytes extended (long XDATA, type 0xF0)."""
        flen = FRAME_BYTES_EXT if extended else FRAME_BYTES
        f = np.zeros(flen, dtype=np.uint8)
        f[0:8] = scramble(np.frombuffer(SYNCWORD, dtype=np.uint8))  # descrambled-domain header
        f[DATA_START] = FRAME_TYPE_EXT if extended else FRAME_TYPE_STD
        for typ, pos, dlen in (_BLOCK_OFFSETS_EXT if extended else _BLOCK_OFFSETS):
            data = self._block_data(typ, dlen, truth)
            f[pos] = typ
            f[pos + 1] = dlen
            f[pos + 2: pos + 2 + dlen] = data
            f[pos + 2 + dlen: pos + 4 + dlen] = np.frombuffer(
                struct.pack("<H", crc16_ccitt(data.tobytes())), dtype=np.uint8)
        return rs_encode_frame(f)

    def _block_data(self, typ: int, dlen: int, truth: RS41Truth) -> np.ndarray:
        d = np.zeros(dlen, dtype=np.uint8)
        if typ == BLK_STATUS:
            d[0:2] = np.frombuffer(struct.pack("<H", truth.frame_no & 0xFFFF), np.uint8)
            d[2:10] = np.frombuffer(truth.serial.encode("ascii")[:8].ljust(8), np.uint8)
            d[10] = int(truth.battery_v * 10)
            bk = 0xFFFF if truth.burstkill < 0 else truth.burstkill
            d[18:20] = np.frombuffer(struct.pack("<H", bk), np.uint8)
            page = truth.frame_no % CALIB_PAGES
            d[23] = page
            d[24:40] = self.calib_blob[page * 16:(page + 1) * 16]
        elif typ == BLK_MEAS:
            tco = np.frombuffer(self.calib_blob[_CAL_TEMP_OFF:_CAL_TEMP_OFF + 12], "<f4")
            hco = np.frombuffer(self.calib_blob[_CAL_HUM_OFF:_CAL_HUM_OFF + 12], "<f4")
            ref1, ref2 = 131072, 393216
            g = (ref2 - ref1) / (1100.0 - 750.0)     # counts per Ohm
            r_ohm = (truth.temp - tco[0]) / tco[1]   # target resistance
            r_h = (truth.rh - hco[0]) / hco[1]
            counts = [int(round(ref1 + (r_ohm - 750.0) * g)), ref1, ref2,
                      int(ref1 + r_h * (ref2 - ref1)), ref1, ref2,
                      200000, 0]
            for i, cval in enumerate(counts):
                d[3 * i: 3 * i + 3] = np.frombuffer(
                    int(cval).to_bytes(3, "little"), np.uint8)
        elif typ == BLK_GPSINFO:
            week, tow = geo.utc_to_gps_time(truth.time_utc)
            d[0:2] = np.frombuffer(struct.pack("<H", int(week)), np.uint8)
            d[2:6] = np.frombuffer(struct.pack("<I", int(round(tow * 1000))), np.uint8)
            for i in range(12):
                d[6 + 2 * i] = i + 1
                d[7 + 2 * i] = 45
        elif typ == BLK_GPSPOS:
            x, y, z = geo.geodetic_to_ecef(truth.lat, truth.lon, truth.alt)
            vx, vy, vz = geo.enu_to_ecef_velocity(
                truth.ve, truth.vn, truth.vu, truth.lat, truth.lon)
            d[0:12] = np.frombuffer(struct.pack(
                "<iii", int(round(x * 100)), int(round(y * 100)), int(round(z * 100))), np.uint8)
            d[12:18] = np.frombuffer(struct.pack(
                "<hhh", int(round(vx * 100)), int(round(vy * 100)), int(round(vz * 100))), np.uint8)
            d[18], d[19], d[20] = 9, 10, 15
        elif typ == BLK_XDATA:
            txt = b""
            if truth.o3_mpa is not None:
                txt = f"{truth.o3_mpa:.2f} mPa".encode("ascii")
            if truth.xdata_extra:
                txt += b" " + truth.xdata_extra.encode("ascii")
            txt = txt[:dlen]
            d[:len(txt)] = np.frombuffer(txt, np.uint8)
        return d

    # -- waveform ----------------------------------------------------------

    def frames_to_bits(self, frames: np.ndarray) -> np.ndarray:
        """Descrambled frames [n, 320] -> on-air bit stream (LSB-first)."""
        on_air = scramble(np.atleast_2d(frames))
        return np_bytes_to_bits(on_air, lsb_first=True).reshape(-1)

    def modulate(self, truths: List[RS41Truth], fs: float = 48000.0,
                 bt: float = 0.5) -> np.ndarray:
        """Synthesize back-to-back frames as complex IQ at rate fs."""
        frames = np.stack([self.build_frame(t) for t in truths])
        bits = self.frames_to_bits(frames)
        return gfsk_modulate(bits, fs / BAUD, SPEC.dev / fs, bt=bt)


# RS41 with extended (518-byte, type 0xF0) frames — ozone/XDATA sondes. Same
# physical layer; the pipeline gathers 518-byte frames so both lengths parse
# (a standard frame's first 320 bytes sit inside the longer gather).
SPEC_EXT = ProtocolSpec(
    name="rs41x",
    display_name="RS41 (extended)",
    bandwidth=1e4,
    baud=BAUD,
    modulation="gfsk",
    syncword=SYNCWORD,
    lsb_first=True,
    frame_bytes=FRAME_BYTES_EXT,
    line_code="nrz",
    deviation=2400.0,
    extra={"whitening": WHITENING_MASK,
           "rs": {"data_start": DATA_START, "parity_start": 8, "nroots": 24,
                  "interleave": 2, "fcr": 0, "prim": 0x11D},
           "wire_columns": WIRE_COLUMNS_EXT},
)


class RS41XModulator(RS41Modulator):
    spec = SPEC_EXT

    def modulate(self, truths: List[RS41Truth], fs: float = 48000.0,
                 bt: float = 0.5) -> np.ndarray:
        frames = np.stack([self.build_frame(t, extended=True) for t in truths])
        bits = self.frames_to_bits(frames)
        return gfsk_modulate(bits, fs / BAUD, SPEC_EXT.dev / fs, bt=bt)


register_sonde("rs41", SPEC, RS41Modulator)
register_sonde("rs41x", SPEC_EXT, RS41XModulator)
