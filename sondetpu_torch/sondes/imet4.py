"""InterMet iMet-1/4 protocol: Bell-202 AFSK async packets + CRC16 + XDATA
(counterpart: ``sondetpu/sondes/imet4.py``).

A jax-free copy of the original, which is reached only through
``sondetpu.sondes``, whose package import pulls in every family and
jax. It registers the imet4 family in the port's registry.

Re-creates sondedump's iMet-4 decoder capability (SURVEY.md S5; reference
API decoder.hpp:9; AFSK per BASELINE.json:10; 20 kHz channel per
main.hpp:49; GPS+T+RH+XDATA ozone per README.md:16).

REAL on-air layout (public protocol; provenance audit in PROTOCOLS.md
"imet4"):

  physical: Bell-202 AFSK over FM — 1200 Bd, mark 1200 Hz / space 2200 Hz;
    bytes are ASYNC SERIAL 8N1: start bit (0/space), 8 data bits LSB-first,
    stop bit (1/mark); idle = mark. The device pipeline demodulates with
    the dual-tone quadrature discriminator front end
    (runtime/pipeline.py _afsk_frontend) and correlates the 20-bit UART
    images of the three packet headers (SOH + type) as sync templates.
  packets (all little-endian, each CRC16-CCITT-FALSE over the bytes from
  the type byte through the payload, CRC stored LE):
    PTU   (14B): 0x01 0x01 | pkt u16 | P u24 (hPa*100) | T i16 (0.01 C)
                 | RH u16 (0.01 %) | batt u8 (0.1 V) | crc u16
    GPS   (18B): 0x01 0x02 | lat f32 | lon f32 | alt u16 (m, +5000 offset)
                 | nsat u8 | hh u8 | mm u8 | ss u8 | crc u16
    XDATA (var): 0x01 0x03 | len u8 | ASCII payload | crc u16
  XDATA ozone: ECC ozonesonde daisy-chain string "05" + instrument no. +
    cell current (4 hex, nA) + pump temperature (4 hex, 0.01 K); O3 partial
    pressure = 4.307e-3 * I_uA * Tp_K * t_pump with a nominal 28 s/100 ml
    pump time (transmitted nowhere, assumed — PROTOCOLS.md).

The gather window is 64 on-air bytes (640 bits) aligned at a packet SOH;
the host parser UART-decodes the window and dispatches on the type byte,
so PTU, GPS, and XDATA packets each arrive as their own telemetry
fragment — the reference's field-bitmask merge protocol (decoder.hpp:64-99)
reassembles them, exactly as it does for sondedump's iMet decoder. iMet
packets carry no velocity (no DATA_SPEED, decoder.hpp:74-79) and no date
(time is UTC seconds-of-day).
"""

from __future__ import annotations

import struct
import time as _time
from typing import List, Optional, Tuple

import numpy as np

from sondetpu_torch.fec.crc import crc16_ccitt
from sondetpu_torch.sondes.base import ProtocolSpec, SondeDecoderBase, register_sonde
from sondetpu_torch.sondes.modulate import afsk_modulate
from sondetpu_torch.sync.coding import np_bytes_to_bits
from sondetpu_torch.telemetry import Fields, TelemetryFragment

BAUD = 1200.0
F_MARK, F_SPACE = 1200.0, 2200.0      # Bell-202
SOH = 0x01
PKT_PTU, PKT_GPS, PKT_XDATA = 0x01, 0x02, 0x03
WINDOW_BYTES = 80                     # gather window: 640 bits = 64 UART bytes
MIN_PACKET_BITS = 140                 # PTU: 14 bytes x 10 bits

# ECC ozonesonde conversion (PROTOCOLS.md imet4): P_O3[mPa] =
# 4.307e-3 * I_cell[uA] * T_pump[K] * t_pump[s], nominal pump time assumed
O3_K, O3_TPUMP = 4.307e-3, 28.0


def uart_bits(data: bytes) -> np.ndarray:
    """Async 8N1 encode: [start=0, b0..b7 LSB-first, stop=1] per byte."""
    out = np.empty(len(data) * 10, np.uint8)
    for i, b in enumerate(data):
        out[10 * i] = 0
        for k in range(8):
            out[10 * i + 1 + k] = (b >> k) & 1
        out[10 * i + 9] = 1
    return out


def uart_decode(bits: np.ndarray) -> np.ndarray:
    """Bits -> bytes; stops at the first framing error (idle mark)."""
    n = bits.size // 10
    out = []
    for i in range(n):
        w = bits[10 * i: 10 * i + 10]
        if w[0] != 0 or w[9] != 1:
            break
        b = 0
        for k in range(8):
            b |= int(w[1 + k]) << k
        out.append(b)
    return np.asarray(out, np.uint8)


SPEC = ProtocolSpec(
    name="imet4",
    display_name="iMet-4",
    bandwidth=2e4,            # main.hpp:49
    baud=BAUD,
    modulation="afsk",
    syncword=bytes([SOH, PKT_PTU]),   # informational; sync_bits rules
    lsb_first=False,   # device byte packing order (UART order handled host-side)
    frame_bytes=WINDOW_BYTES,
    line_code="nrz",
    deviation=3000.0,
    afsk_mark=F_MARK,
    afsk_space=F_SPACE,
    extra={
        # UART images of the packet headers are the sync templates
        "sync_bits": uart_bits(bytes([SOH, PKT_PTU])),
        "alt_sync_bits": (uart_bits(bytes([SOH, PKT_GPS])),
                          uart_bits(bytes([SOH, PKT_XDATA]))),
        "min_frame_chips": MIN_PACKET_BITS,
    },
)


def parse_xdata_ozone(xdata: str) -> Optional[float]:
    """ECC ozonesonde XDATA ("05" + instr + current + pump temp) -> mPa."""
    if len(xdata) < 12 or xdata[0:2] != "05":
        return None
    try:
        i_na = int(xdata[4:8], 16)            # cell current, nA
        tp_ck = int(xdata[8:12], 16)          # pump temperature, 0.01 K
    except ValueError:
        return None
    return O3_K * (i_na / 1000.0) * (tp_ck / 100.0) * O3_TPUMP


class IMET4Decoder(SondeDecoderBase):
    spec = SPEC

    # iMet transmits hh:mm:ss with no date; the date base defaults to the
    # receiver wall clock (live streams). For OFFLINE REPLAY set ref_epoch
    # (epoch seconds near the capture time — e.g. the IQ file's mtime, as
    # the CLI does) so recorded captures stamp the capture day, not the
    # decode day.
    ref_epoch: Optional[float] = None

    def reset_channel(self, channel: int) -> None:
        pass

    def decode_byte_frames(self, frames: np.ndarray, channels
                           ) -> List[Tuple[int, TelemetryFragment]]:
        frames = np.atleast_2d(np.asarray(frames, dtype=np.uint8))
        out = []
        for fi in range(frames.shape[0]):
            ch = int(np.asarray(channels)[fi])
            # window bits -> async bytes (stops at the inter-packet idle)
            bits = np_bytes_to_bits(frames[fi], lsb_first=False)
            pkt = uart_decode(bits)
            frag = self._parse_packet(pkt)
            if frag is not None and frag.fields:
                out.append((ch, frag))
        return out

    def _parse_packet(self, p: np.ndarray) -> Optional[TelemetryFragment]:
        if p.size < 4 or p[0] != SOH:
            return None
        if p[1] == PKT_PTU and p.size >= 14:
            return self._check(p, 14, self._parse_ptu)
        if p[1] == PKT_GPS and p.size >= 18:
            return self._check(p, 18, self._parse_gps)
        if p[1] == PKT_XDATA and p.size >= 6:
            n = int(p[2])
            if p.size >= 5 + n:
                return self._check(p, 5 + n, self._parse_xdata)
        return None

    @staticmethod
    def _check(p: np.ndarray, length: int, parser) -> Optional[TelemetryFragment]:
        want, = struct.unpack("<H", p[length - 2:length].tobytes())
        if crc16_ccitt(p[1:length - 2]) != want:
            return None
        return parser(p[:length])

    @staticmethod
    def _parse_ptu(p: np.ndarray) -> TelemetryFragment:
        frag = TelemetryFragment()
        frag.seq, = struct.unpack("<H", p[2:4].tobytes())
        frag.fields |= Fields.SEQ
        p_raw = int(p[4]) | (int(p[5]) << 8) | (int(p[6]) << 16)
        t_raw, rh_raw = struct.unpack("<hH", p[7:11].tobytes())
        frag.pressure = p_raw / 100.0         # real pressure sensor
        frag.temp = t_raw / 100.0
        frag.rh = rh_raw / 100.0
        frag.calib_percent = 100.0
        frag.fields |= Fields.PTU
        return frag

    def _parse_gps(self, p: np.ndarray) -> TelemetryFragment:
        frag = TelemetryFragment()
        lat, lon = struct.unpack("<ff", p[2:10].tobytes())
        alt_raw, = struct.unpack("<H", p[10:12].tobytes())
        hh, mm, ss = int(p[13]), int(p[14]), int(p[15])
        if not (lat == 0 and lon == 0):
            frag.lat, frag.lon = float(lat), float(lon)
            frag.alt = float(alt_raw) - 5000.0
            frag.fields |= Fields.POS
        # iMet transmits only hh:mm:ss — no date. Telemetry time is epoch
        # seconds like every other family (the GPX/JSONL sinks expect it):
        # the date comes from the receiver clock, as the decoder ecosystem
        # conventionally does; near-midnight wraps pick the closer day.
        sod = hh * 3600.0 + mm * 60.0 + ss
        now = self.ref_epoch if self.ref_epoch is not None else _time.time()
        midnight = now - (now % 86400.0)
        epoch = midnight + sod
        if epoch - now > 43200.0:
            epoch -= 86400.0
        elif now - epoch > 43200.0:
            epoch += 86400.0
        frag.time = epoch
        frag.fields |= Fields.TIME
        # iMet serial is not transmitted; the conventional station id is
        # derived host-side (frequency+time hash in the ecosystem). Use a
        # stable placeholder per protocol.
        return frag

    @staticmethod
    def _parse_xdata(p: np.ndarray) -> TelemetryFragment:
        frag = TelemetryFragment()
        n = int(p[2])
        xdata = p[3:3 + n].tobytes().decode("ascii", errors="replace")
        o3 = parse_xdata_ozone(xdata)
        if o3 is not None:
            frag.o3_mpa = o3
            frag.fields |= Fields.OZONE
        return frag


class IMET4Truth:
    def __init__(self, serial="IMET4001", frame_no=1, lat=40.0, lon=-105.0,
                 alt=22000.0, temp=-58.0, rh=5.0, pressure=40.0,
                 o3_mpa=3.2, time_utc=1.7e9):
        self.serial, self.frame_no = serial, frame_no
        self.lat, self.lon, self.alt = lat, lon, alt
        self.temp, self.rh, self.pressure = temp, rh, pressure
        self.o3_mpa, self.time_utc = o3_mpa, time_utc


class IMET4Modulator:
    spec = SPEC

    IDLE_BITS = 10            # inter-packet mark idle

    def _crc_tail(self, body: bytes) -> bytes:
        return body + struct.pack("<H", crc16_ccitt(body[1:]))

    def build_ptu(self, t: IMET4Truth) -> bytes:
        body = bytes([SOH, PKT_PTU]) + struct.pack(
            "<H", t.frame_no & 0xFFFF)
        p_raw = int(round(t.pressure * 100))
        body += bytes([p_raw & 0xFF, (p_raw >> 8) & 0xFF, (p_raw >> 16) & 0xFF])
        body += struct.pack("<hH", int(round(t.temp * 100)),
                            int(round(t.rh * 100)))
        body += bytes([36])               # battery 3.6 V
        return self._crc_tail(body)

    def build_gps(self, t: IMET4Truth) -> bytes:
        sod = t.time_utc % 86400.0
        hh, rem = divmod(int(sod), 3600)
        mm, ss = divmod(rem, 60)
        body = bytes([SOH, PKT_GPS]) + struct.pack(
            "<ffHB", np.float32(t.lat), np.float32(t.lon),
            int(round(t.alt + 5000.0)), 9) + bytes([hh, mm, ss])
        return self._crc_tail(body)

    def build_xdata(self, t: IMET4Truth) -> bytes:
        tp_k = 300.0
        i_ua = (t.o3_mpa or 0.0) / (O3_K * tp_k * O3_TPUMP)
        x = "0501%04X%04X" % (int(round(i_ua * 1000)) & 0xFFFF,
                              int(round(tp_k * 100)) & 0xFFFF)
        body = bytes([SOH, PKT_XDATA, len(x)]) + x.encode("ascii")
        return self._crc_tail(body)

    def packets_to_bits(self, packets: List[bytes]) -> np.ndarray:
        parts = []
        for p in packets:
            parts.append(uart_bits(p))
            parts.append(np.ones(self.IDLE_BITS, np.uint8))   # mark idle
        return np.concatenate(parts)

    def modulate(self, truths: List[IMET4Truth], fs: float = 48000.0) -> np.ndarray:
        """Per truth: PTU + GPS + XDATA packets, mark-idle separated (the
        real iMet packet cadence)."""
        packets: List[bytes] = []
        for t in truths:
            packets += [self.build_ptu(t), self.build_gps(t)]
            if t.o3_mpa:
                packets.append(self.build_xdata(t))
        bits = self.packets_to_bits(packets)
        return afsk_modulate(bits, fs / BAUD, F_MARK, F_SPACE, fs,
                             deviation_norm=SPEC.dev / fs)


register_sonde("imet4", SPEC, IMET4Decoder, IMET4Modulator)
