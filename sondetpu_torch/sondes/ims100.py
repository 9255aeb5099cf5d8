"""Meisei iMS-100 / RS-11G protocol: GFSK + shortened BCH + even/odd halves
(counterpart: ``sondetpu/sondes/ims100.py``).

A jax-free copy of the original, which is reached only through
``sondetpu.sondes``, whose package import pulls in every family and
jax. It registers the ims100 family in the port's registry.

Re-creates sondedump's Meisei decoder capability (SURVEY.md S4; reference
API decoder.hpp:10; BCH FEC per BASELINE.json:10; 20 kHz shared channel
entry "iMS100/RS-11G" per main.hpp:38,47; GPS+T+RH per README.md:14-15).

On-air structure (sync word, code, block layout, word orientation and the
GPS scalings are the public parts; the exact word positions are
reconstructed — per-field provenance audit in PROTOCOLS.md "ims100"):

  physical: 2400 Bd GFSK NRZ.
  subframe (576 bits = 72 bytes, ~4.2/s):
    bits  0- 23  sync 0xFB6230
    bits 24-575  12 blocks of 46 bits, each a SHORTENED BCH(63,51) t=2
                 codeword (the first 17 message bits are an implicit zero
                 prefix, not transmitted): 34 data bits + 12 parity bits.
  payload: each block's 34 data bits carry TWO big-endian 16-bit words
  (+2 spare bits) -> 24 words w[0..23] per subframe.  Subframes alternate
  EVEN (position) / ODD (PTU/serial) halves keyed by the frame counter's
  parity (the protocol's interleaved even/odd structure, SURVEY.md S4):

    w0        u16  frame counter (parity selects the half)
    w1        u16  subframe type word; distinguishes iMS-100 from RS-11G
                   (same framing/decoder for both — the reference binds ONE
                   sondedump decoder to the combined entry, main.hpp:38,47;
                   the type VALUES here are framework-defined)
    EVEN: w2|w3   u32  milliseconds of UTC day
          w4|w5   u32  date, decimal YYMMDD
          w6|w7   u32  latitude,  NMEA ddmm.mmmm x 1e4
          w8|w9   u32  longitude, NMEA dddmm.mmmm x 1e4 (+2^31 = south/west
                       via sign bit)
          w10|w11 i32  altitude, cm
          w12     u16  ground speed, 0.01 kt
          w13     u16  heading, 0.01 deg
    ODD:  w2      u16  temperature, cK   [framework — real Meisei PTU is
          w3      u16  RH, c%             raw counts + transmitted per-sonde
                                          calibration, not publicly mapped]
          w4|w5   u32  serial, decimal (printed as-is; RS-11G ids get an
                       "R" prefix)

  Climb is not transmitted; it is derived host-side from successive
  altitude fixes (dAlt/dt), as the upstream ecosystem does for families
  without velocity words.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from sondetpu_torch.fec.bch import BCH_63_51
from sondetpu_torch.sondes import geo
from sondetpu_torch.sondes.base import ProtocolSpec, SondeDecoderBase, register_sonde
from sondetpu_torch.sondes.modulate import gfsk_modulate
from sondetpu_torch.sync.coding import np_bits_to_bytes, np_bytes_to_bits
from sondetpu_torch.telemetry import Fields, TelemetryFragment

BAUD = 2400.0
FRAME_BYTES = 72
SYNCWORD = bytes([0xFB, 0x62, 0x30])
N_BLOCKS = 12
SHORT = 17                    # zero bits removed from each (63,51) codeword
DATA_BITS = 34                # 51 - SHORT
BLOCK_BITS = 46               # 63 - SHORT
N_WORDS = 2 * N_BLOCKS        # two 16-bit words per block

KNOTS2MS = 0.514444           # transmitted speed unit is centi-knots

# subframe type words (framework-defined VALUES; the type-word dispatch
# structure models sondedump's single decoder serving both models)
TYPE_IMS100 = 0x0165
TYPE_RS11G = 0x0247

SPEC = ProtocolSpec(
    name="ims100",
    display_name="iMS100/RS-11G",
    bandwidth=2e4,            # main.hpp:47
    baud=BAUD,
    modulation="gfsk",
    syncword=SYNCWORD,
    lsb_first=False,
    frame_bytes=FRAME_BYTES,
    line_code="nrz",
    deviation=2400.0,
    extra={"dc_mode": "midpoint",    # unwhitened NRZ: data-dc-immune slicer
           # orthogonal tones (spacing 2*dev = 2*baud): the dual-tone
           # noncoherent front end beats the discriminator below ~4 dB
           # (2 dB FER 0.0 with it vs 0.53 without; FER artifact)
           "fsk_dualtone": True},
)


def bch_46_34_encode(msg_bits: np.ndarray) -> np.ndarray:
    """[batch, 34] data bits -> [batch, 46] shortened codewords."""
    msg = np.atleast_2d(np.asarray(msg_bits, np.uint8))
    full = np.zeros((msg.shape[0], 51), np.uint8)
    full[:, SHORT:] = msg                  # implicit zero prefix
    return BCH_63_51.encode(full)[:, SHORT:]


def bch_46_34_decode(recv_bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[batch, 46] received -> ([batch, 34] data, [batch] ok)."""
    recv = np.atleast_2d(np.asarray(recv_bits, np.uint8))
    full = np.zeros((recv.shape[0], 63), np.uint8)
    full[:, SHORT:] = recv
    corrected, _, ok = BCH_63_51.decode(full)
    # a "correction" inside the zero prefix means the codeword was bad
    ok = ok & ~corrected[:, :SHORT].any(axis=1)
    return corrected[:, SHORT:51], ok


def words_to_block_bits(words: np.ndarray) -> np.ndarray:
    """[24] u16 words -> [12, 46] shortened-codeword bit matrix."""
    w = np.asarray(words, np.uint64).reshape(N_BLOCKS, 2)
    data = np.zeros((N_BLOCKS, DATA_BITS), np.uint8)
    for k in range(16):
        data[:, k] = (w[:, 0] >> (15 - k)) & 1
        data[:, 16 + k] = (w[:, 1] >> (15 - k)) & 1
    return bch_46_34_encode(data)


def block_bits_to_words(blk_bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[12, 46] received block bits -> (words [24] u16, ok [12] per block).

    Bad blocks zero their words; the parser accepts a half-frame when the
    blocks covering ITS fields decoded (per-block erasure tolerance — a
    frame with a corrupt tail block still yields telemetry)."""
    data, ok = bch_46_34_decode(blk_bits)
    data = np.where(ok[:, None], data, 0).astype(np.uint64)
    weights = (1 << np.arange(15, -1, -1)).astype(np.uint64)
    w_hi = (data[:, :16] * weights).sum(axis=1)
    w_lo = (data[:, 16:32] * weights).sum(axis=1)
    return np.stack([w_hi, w_lo], axis=1).reshape(-1).astype(np.uint32), ok


def nmea_to_deg(val: int) -> float:
    """NMEA (d)ddmm.mmmm x 1e4 (sign in bit 31) -> decimal degrees."""
    sign = -1.0 if val & 0x80000000 else 1.0
    v = (val & 0x7FFFFFFF) / 1e6          # ddmm.mmmm -> dd.mmmmmm
    deg = int(v)
    return sign * (deg + (v - deg) * 100.0 / 60.0)


def deg_to_nmea(deg: float) -> int:
    """Inverse of nmea_to_deg (for the modulator)."""
    sign = 0x80000000 if deg < 0 else 0
    deg = abs(deg)
    d = int(deg)
    minutes = (deg - d) * 60.0
    return sign | (d * 1000000 + int(round(minutes * 1e4)))


# blocks whose words cover each half's fields
_EVEN_BLOCKS = slice(0, 7)    # w0..w13 -> blocks 0-6
_ODD_BLOCKS = slice(0, 3)     # w0..w5  -> blocks 0-2


class IMS100Decoder(SondeDecoderBase):
    spec = SPEC

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._subtype: Dict[int, str] = {}
        self._last_fix: Dict[int, Tuple[float, float]] = {}  # ch -> (t, alt)
        self._last_climb: Dict[int, float] = {}

    def reset_channel(self, channel: int) -> None:
        self._subtype.pop(channel, None)
        self._last_fix.pop(channel, None)
        self._last_climb.pop(channel, None)

    def subtype(self, channel: int) -> Optional[str]:
        """Model detected on the channel ("iMS-100" / "RS-11G"), mirroring
        the reference's combined entry (main.hpp:47)."""
        return self._subtype.get(channel)

    def decode_byte_frames(self, frames: np.ndarray, channels
                           ) -> List[Tuple[int, TelemetryFragment]]:
        frames = np.atleast_2d(np.asarray(frames, dtype=np.uint8))
        out = []
        for fi in range(frames.shape[0]):
            f = frames[fi]
            ch = int(np.asarray(channels)[fi])
            if f[:3].tobytes() != SYNCWORD:
                continue
            bits = np_bytes_to_bits(f)[24:24 + N_BLOCKS * BLOCK_BITS]
            words, ok = block_bits_to_words(bits.reshape(N_BLOCKS, BLOCK_BITS))
            if not ok[0]:                  # counter + type word block
                continue
            half = int(words[0]) & 1
            need = _EVEN_BLOCKS if half == 0 else _ODD_BLOCKS
            if not ok[need].all():
                continue
            frag = self._parse_words(words, ch)
            if frag is not None and frag.fields:
                out.append((ch, frag))
        return out

    def _parse_words(self, w: np.ndarray, ch: int) -> Optional[TelemetryFragment]:
        frag = TelemetryFragment()
        frag.seq = int(w[0])
        frag.fields |= Fields.SEQ
        subtype = {TYPE_IMS100: "iMS-100", TYPE_RS11G: "RS-11G"}.get(int(w[1]))
        if subtype is not None:
            self._subtype[ch] = subtype
        if frag.seq & 1 == 0:
            ms_of_day = (int(w[2]) << 16) | int(w[3])
            date = (int(w[4]) << 16) | int(w[5])
            if ms_of_day < 86400000 and date > 0:
                yy, mm, dd = date // 10000, (date // 100) % 100, date % 100
                frag.time = float(geo.ymd_sod_to_utc(
                    2000 + yy, mm, dd, ms_of_day / 1000.0))
                frag.fields |= Fields.TIME
            lat = nmea_to_deg((int(w[6]) << 16) | int(w[7]))
            lon = nmea_to_deg((int(w[8]) << 16) | int(w[9]))
            v = (int(w[10]) << 16) | int(w[11])
            alt_cm = (v & 0x7FFFFFFF) - (v & 0x80000000)   # sign-extend i32
            if not (lat == 0 and lon == 0):
                frag.lat, frag.lon, frag.alt = lat, lon, alt_cm / 100.0
                frag.speed = int(w[12]) / 100.0 * KNOTS2MS
                frag.heading = int(w[13]) / 100.0
                # climb derived from successive fixes (not transmitted);
                # when this frame cannot derive it (first fix, no time),
                # carry the last derived value rather than fabricating 0.0
                prev = self._last_fix.get(ch)
                t_now = frag.time if frag.fields & Fields.TIME else None
                if prev is not None and t_now is not None and t_now > prev[0]:
                    self._last_climb[ch] = (frag.alt - prev[1]) / (t_now - prev[0])
                frag.climb = self._last_climb.get(ch, float("nan"))
                if t_now is not None:
                    self._last_fix[ch] = (t_now, frag.alt)
                frag.fields |= Fields.POS | Fields.SPEED
        else:
            frag.temp = int(w[2]) / 100.0 - 273.15
            frag.rh = int(w[3]) / 100.0       # iMS-100/RS-11G carry RH
            frag.pressure = 0.0
            frag.calib_percent = 100.0
            frag.fields |= Fields.PTU
            serial_num = (int(w[4]) << 16) | int(w[5])
            if serial_num:
                prefix = "R" if self._subtype.get(ch) == "RS-11G" else ""
                frag.serial = prefix + str(serial_num)
                frag.fields |= Fields.SERIAL
        return frag


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
        # frame counter parity selects the half
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
        """Alternating even/odd half-frames (interleaved structure, S4)."""
        frames = []
        for k, t in enumerate(truths):
            frames.append(self.build_frame(t, half=k % 2))
        bits = np_bytes_to_bits(np.stack(frames)).reshape(-1)
        return gfsk_modulate(bits, fs / BAUD, SPEC.dev / fs, bt=bt)


register_sonde("ims100", SPEC, IMS100Decoder, IMS100Modulator)
