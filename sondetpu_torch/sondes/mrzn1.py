"""Meteo-Radiy MRZ-N1 protocol: FSK NRZ, GPS+T frames with CRC
(counterpart: ``sondetpu/sondes/mrzn1.py``).

A jax-free copy of the original, which is reached only through
``sondetpu.sondes``, whose package import pulls in every family and
jax. It registers the mrzn1 family in the port's registry.

Re-creates sondedump's MRZ-N1 decoder capability (SURVEY.md S7; reference
API decoder.hpp:12; 20 kHz channel per main.hpp:51; GPS+T per
README.md:18). Shares the S0 GFSK/NRZ machinery with RS41/M10.

As implemented: 2400 Bd FSK (unfiltered NRZ), 32-byte frames with
CRC16-CCITT [framework definition; re-verify on recorded IQ, SURVEY.md §7]:

  frame (32B): 0x00 3B sync 0xAA 0x23 0xC1; 0x03 u16 frame_no;
    0x05 u32 utc epoch s; 0x09 i32 lat 1e-6; 0x0D i32 lon 1e-6;
    0x11 i32 alt cm; 0x15 3 x i16 vE,vN,vU cm/s; 0x1B u16 temp cK;
    0x1D u8 serial_lo; 0x1E u16 crc over 0x03..0x1D.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from sondetpu_torch.fec.crc import crc16_ccitt
from sondetpu_torch.sondes import geo
from sondetpu_torch.sondes.base import ProtocolSpec, SondeDecoderBase, register_sonde
from sondetpu_torch.sondes.modulate import gfsk_modulate
from sondetpu_torch.sync.coding import np_bytes_to_bits
from sondetpu_torch.telemetry import Fields, TelemetryFragment

BAUD = 2400.0
FRAME_BYTES = 32
SYNCWORD = bytes([0xAA, 0x23, 0xC1])

SPEC = ProtocolSpec(
    name="mrzn1",
    display_name="MRZ-N1",
    bandwidth=2e4,            # main.hpp:51
    baud=BAUD,
    modulation="fsk",
    syncword=SYNCWORD,
    lsb_first=False,
    frame_bytes=FRAME_BYTES,
    line_code="nrz",
    deviation=2400.0,
    extra={"dc_mode": "midpoint",    # unwhitened NRZ: data-dc-immune slicer
           # orthogonal tones (spacing 2*dev = 2*baud): the dual-tone
           # noncoherent front end beats the discriminator below ~4 dB
           # (2 dB FER 0.0 with it vs 0.73 without; FER artifact)
           "fsk_dualtone": True},
)


class MRZN1Decoder(SondeDecoderBase):
    spec = SPEC

    def reset_channel(self, channel: int) -> None:
        pass

    def decode_byte_frames(self, frames: np.ndarray, channels
                           ) -> List[Tuple[int, TelemetryFragment]]:
        frames = np.atleast_2d(np.asarray(frames, dtype=np.uint8))
        out = []
        for fi in range(frames.shape[0]):
            f = frames[fi]
            ch = int(np.asarray(channels)[fi])
            if f[0:3].tobytes() != SYNCWORD:
                continue
            want, = struct.unpack("<H", f[0x1E:0x20].tobytes())
            if crc16_ccitt(f[0x03:0x1E].tobytes()) != want:
                continue
            frag = TelemetryFragment()
            frag.seq, = struct.unpack("<H", f[0x03:0x05].tobytes())
            frag.fields |= Fields.SEQ
            frag.time = float(struct.unpack("<I", f[0x05:0x09].tobytes())[0])
            frag.fields |= Fields.TIME
            lat, lon, alt_cm = struct.unpack("<iii", f[0x09:0x15].tobytes())
            ve, vn, vu = struct.unpack("<hhh", f[0x15:0x1B].tobytes())
            if not (lat == 0 and lon == 0):
                frag.lat, frag.lon, frag.alt = lat * 1e-6, lon * 1e-6, alt_cm / 100.0
                spd, hdg, climb = geo.speed_heading_climb(
                    ve / 100.0, vn / 100.0, vu / 100.0)
                frag.speed, frag.heading, frag.climb = float(spd), float(hdg), float(climb)
                frag.fields |= Fields.POS | Fields.SPEED
            t_raw, = struct.unpack("<H", f[0x1B:0x1D].tobytes())
            frag.temp = t_raw / 100.0 - 273.15
            frag.rh = float("nan")            # MRZ-N1 reports GPS+T only
            frag.pressure = 0.0
            frag.calib_percent = 100.0
            frag.fields |= Fields.PTU
            frag.serial = f"MRZ-{int(f[0x1D]):03d}"
            frag.fields |= Fields.SERIAL
            out.append((ch, frag))
        return out


class MRZN1Truth:
    def __init__(self, serial_lo=42, frame_no=1, lat=55.8, lon=37.6,
                 alt=9000.0, ve=6.0, vn=-2.0, vu=4.2, temp=-35.0,
                 time_utc=1.7e9):
        self.serial_lo, self.frame_no = serial_lo, frame_no
        self.lat, self.lon, self.alt = lat, lon, alt
        self.ve, self.vn, self.vu = ve, vn, vu
        self.temp, self.time_utc = temp, time_utc


class MRZN1Modulator:
    spec = SPEC

    def build_frame(self, t: MRZN1Truth) -> np.ndarray:
        f = np.zeros(FRAME_BYTES, dtype=np.uint8)
        f[0:3] = np.frombuffer(SYNCWORD, np.uint8)
        f[0x03:0x05] = np.frombuffer(struct.pack("<H", t.frame_no & 0xFFFF), np.uint8)
        f[0x05:0x09] = np.frombuffer(struct.pack("<I", int(t.time_utc)), np.uint8)
        f[0x09:0x15] = np.frombuffer(struct.pack(
            "<iii", int(round(t.lat * 1e6)), int(round(t.lon * 1e6)),
            int(round(t.alt * 100))), np.uint8)
        f[0x15:0x1B] = np.frombuffer(struct.pack(
            "<hhh", int(round(t.ve * 100)), int(round(t.vn * 100)),
            int(round(t.vu * 100))), np.uint8)
        f[0x1B:0x1D] = np.frombuffer(struct.pack(
            "<H", int(round((t.temp + 273.15) * 100))), np.uint8)
        f[0x1D] = t.serial_lo & 0xFF
        f[0x1E:0x20] = np.frombuffer(struct.pack(
            "<H", crc16_ccitt(f[0x03:0x1E].tobytes())), np.uint8)
        return f

    def modulate(self, truths: List[MRZN1Truth], fs: float = 48000.0) -> np.ndarray:
        frames = np.stack([self.build_frame(t) for t in truths])
        bits = np_bytes_to_bits(frames).reshape(-1)
        # unfiltered FSK (bt >= 4 disables the Gaussian filter)
        return gfsk_modulate(bits, fs / BAUD, SPEC.dev / fs, bt=8.0)


register_sonde("mrzn1", SPEC, MRZN1Decoder, MRZN1Modulator)
