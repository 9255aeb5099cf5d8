"""Meteolabor SRS-C50 protocol: AFSK 2-tone, typed single-parameter telegrams
(counterpart: ``sondetpu/sondes/c50.py``).

A jax-free copy of the original, which is reached only through
``sondetpu.sondes``, whose package import pulls in every family and
jax. It registers the c50 family in the port's registry.

Re-creates sondedump's SRS-C50 decoder capability (SURVEY.md S6; reference
API decoder.hpp:7; AFSK/FSK 2-tone; 20 kHz channel per main.hpp:50; GPS+T
per README.md:17). Shares the AFSK front end with iMet-4 (S5 machinery,
SURVEY.md S6 "[inferred]").

The C34/C50 family's distinctive PUBLIC structure is that telemetry does
not travel as one monolithic frame: the sonde emits a stream of short
TYPED TELEGRAMS, each carrying a single quantity (a "channel"/value pair)
protected by its own check — receivers accumulate the channels into a full
picture. This module models exactly that; the byte-level constants (sync
byte, type codes, CRC placement) are framework-defined — the public record
reachable from this environment does not pin them (PROTOCOLS.md "c50",
README family table).

As implemented: 2400 Bd AFSK over FM, mark 2400 Hz / space 4800 Hz
[public-partial tone plan — one-octave tone pair per the open DFT-based
C34/C50 decoders; re-verify on recorded IQ per SURVEY.md §7]. Telegram
(9 bytes, data big-endian):

  0x00  2B   preamble 0xAA + sync 0xA5
  0x02  u8   type (see TYPE_* below)
  0x03  u32  value (two's complement where signed)
  0x07  u16  CRC16-CCITT over bytes 0x02..0x06

Types: 0x01 temperature cK; 0x03 UTC ms-of-day; 0x04 lat 1e-6 deg;
0x05 lon 1e-6 deg; 0x06 alt cm; 0x07 date YYMMDD; 0x08 serial number.
Time needs the date + time-of-day pair; the decoder latches the last date
per channel (C50 reports GPS+T only — no RH, README.md:17)."""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from sondetpu_torch.fec.crc import crc16_ccitt
from sondetpu_torch.sondes import geo
from sondetpu_torch.sondes.base import ProtocolSpec, SondeDecoderBase, register_sonde
from sondetpu_torch.sondes.modulate import afsk_modulate
from sondetpu_torch.sync.coding import np_bytes_to_bits
from sondetpu_torch.telemetry import Fields, TelemetryFragment

BAUD = 2400.0
F_MARK, F_SPACE = 2400.0, 4800.0
FRAME_BYTES = 9
SYNCWORD = bytes([0xAA, 0xA5])

TYPE_TEMP = 0x01
TYPE_TOD = 0x03
TYPE_LAT = 0x04
TYPE_LON = 0x05
TYPE_ALT = 0x06
TYPE_DATE = 0x07
TYPE_SERIAL = 0x08

SPEC = ProtocolSpec(
    name="c50",
    display_name="SRS-C50",
    bandwidth=2e4,            # main.hpp:50
    baud=BAUD,
    modulation="afsk",
    syncword=SYNCWORD,
    lsb_first=False,
    frame_bytes=FRAME_BYTES,
    line_code="nrz",
    deviation=3000.0,
    afsk_mark=F_MARK,
    afsk_space=F_SPACE,
)


class C50Decoder(SondeDecoderBase):
    spec = SPEC
    # a lat/lon/alt component older than this many position telegrams may
    # not pair into a fix (~4 full telegram cycles of slack)
    MAX_COMPONENT_AGE = 12

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._date: Dict[int, Tuple[int, int, int]] = {}   # ch -> (y, m, d)
        # ch -> component -> (value, telegram index)
        self._pos: Dict[int, Dict[str, Tuple[float, int]]] = {}
        self._tix: Dict[int, int] = {}                     # ch -> telegram no.

    def reset_channel(self, channel: int) -> None:
        self._date.pop(channel, None)
        self._pos.pop(channel, None)
        self._tix.pop(channel, None)

    def decode_byte_frames(self, frames: np.ndarray, channels
                           ) -> List[Tuple[int, TelemetryFragment]]:
        frames = np.atleast_2d(np.asarray(frames, dtype=np.uint8))
        out = []
        for fi in range(frames.shape[0]):
            f = frames[fi]
            ch = int(np.asarray(channels)[fi])
            if f[0:2].tobytes() != SYNCWORD:
                continue
            want, = struct.unpack(">H", f[0x07:0x09].tobytes())
            if crc16_ccitt(f[0x02:0x07].tobytes()) != want:
                continue
            typ = int(f[0x02])
            val, = struct.unpack(">I", f[0x03:0x07].tobytes())
            frag = self._apply(typ, val, ch)
            if frag is not None and frag.fields:
                out.append((ch, frag))
        return out

    def _apply(self, typ: int, val: int, ch: int) -> TelemetryFragment:
        """One telegram -> one partial fragment (the bitmask merge protocol
        reassembles them, decoder.hpp:63-110)."""
        frag = TelemetryFragment()
        ival = struct.unpack(">i", struct.pack(">I", val))[0]
        if typ == TYPE_TEMP:
            frag.temp = val / 100.0 - 273.15
            frag.rh = float("nan")        # C50 reports GPS+T only
            frag.pressure = 0.0
            frag.calib_percent = 100.0
            frag.fields |= Fields.PTU
        elif typ == TYPE_DATE:
            yy, mm, dd = val // 10000, (val // 100) % 100, val % 100
            if 1 <= mm <= 12 and 1 <= dd <= 31:
                self._date[ch] = (2000 + yy, mm, dd)
        elif typ == TYPE_TOD:
            date = self._date.get(ch)
            if date is not None and val < 86400000:
                frag.time = float(geo.ymd_sod_to_utc(*date, val / 1000.0))
                frag.fields |= Fields.TIME
                frag.seq = (val // 1000) & 0xFFFF   # no frame counter on air
                frag.fields |= Fields.SEQ
        elif typ in (TYPE_LAT, TYPE_LON, TYPE_ALT):
            # single-parameter telegrams: accumulate the fix per channel and
            # emit a full POS fragment once lat/lon/alt have all arrived.
            # Each component is stamped with a per-channel telegram counter
            # and expires after MAX_COMPONENT_AGE telegrams: without the
            # bound, a lat whose successors keep failing CRC could pair
            # with lon/alt minutes fresher — a position offset by the whole
            # intervening flight drift in one axis.
            tix = self._tix.get(ch, 0) + 1
            self._tix[ch] = tix
            pos = self._pos.setdefault(ch, {})
            for k in [k for k, (_, t0) in pos.items()
                      if tix - t0 > self.MAX_COMPONENT_AGE]:
                del pos[k]
            if typ == TYPE_LAT:
                pos["lat"] = (ival * 1e-6, tix)
            elif typ == TYPE_LON:
                pos["lon"] = (ival * 1e-6, tix)
            else:
                pos["alt"] = (ival / 100.0, tix)
            if len(pos) == 3 and not (pos["lat"][0] == 0
                                      and pos["lon"][0] == 0):
                frag.lat, frag.lon, frag.alt = (pos["lat"][0], pos["lon"][0],
                                                pos["alt"][0])
                frag.fields |= Fields.POS
                # one fix per complete lat/lon/alt TRIPLE: clearing prevents
                # a later lone component from pairing with stale ones
                self._pos[ch] = {}
        elif typ == TYPE_SERIAL:
            frag.serial = f"C50-{val:05d}"
            frag.fields |= Fields.SERIAL
        return frag


class C50Truth:
    def __init__(self, serial_num=12345, frame_no=1, lat=46.8, lon=8.2,
                 alt=6000.0, temp=-15.0, time_utc=1.7e9):
        self.serial_num, self.frame_no = serial_num, frame_no
        self.lat, self.lon, self.alt = lat, lon, alt
        self.temp, self.time_utc = temp, time_utc


class C50Modulator:
    spec = SPEC

    def build_telegram(self, typ: int, val: int) -> np.ndarray:
        f = np.zeros(FRAME_BYTES, dtype=np.uint8)
        f[0:2] = np.frombuffer(SYNCWORD, np.uint8)
        f[0x02] = typ
        f[0x03:0x07] = np.frombuffer(struct.pack(">I", val & 0xFFFFFFFF), np.uint8)
        f[0x07:0x09] = np.frombuffer(struct.pack(
            ">H", crc16_ccitt(f[0x02:0x07].tobytes())), np.uint8)
        return f

    def build_frame(self, t: C50Truth) -> np.ndarray:
        """One truth -> the telegram burst carrying its full state."""
        y, mo, d, sod = geo.utc_to_ymd_sod(t.time_utc + t.frame_no)
        tel = [
            (TYPE_DATE, (y % 100) * 10000 + mo * 100 + d),
            (TYPE_TOD, int(round(sod * 1000.0))),
            (TYPE_LAT, int(round(t.lat * 1e6)) & 0xFFFFFFFF),
            (TYPE_LON, int(round(t.lon * 1e6)) & 0xFFFFFFFF),
            (TYPE_ALT, int(round(t.alt * 100)) & 0xFFFFFFFF),
            (TYPE_TEMP, int(round((t.temp + 273.15) * 100))),
            (TYPE_SERIAL, t.serial_num),
        ]
        return np.concatenate([self.build_telegram(ty, v) for ty, v in tel])

    def modulate(self, truths: List[C50Truth], fs: float = 48000.0) -> np.ndarray:
        frames = np.concatenate([self.build_frame(t) for t in truths])
        bits = np_bytes_to_bits(frames[None]).reshape(-1)
        return afsk_modulate(bits, fs / BAUD, F_MARK, F_SPACE, fs,
                             deviation_norm=SPEC.dev / fs)


register_sonde("c50", SPEC, C50Decoder, C50Modulator)
