"""CRC16 and simple checksums (frame integrity for all sonde families; a
copy of ``sondetpu/fec/crc.py``, NumPy only).

Table-driven, vectorized over a batch of equal-length messages so thousands
of frames per second verify in a few NumPy ops (reference: per-subframe
CRC16 verification inside sondedump, SURVEY.md S1/S3/S5).
"""

from __future__ import annotations

import numpy as np


def _make_table(poly: int) -> np.ndarray:
    table = np.zeros(256, dtype=np.uint16)
    for b in range(256):
        r = b << 8
        for _ in range(8):
            r = ((r << 1) ^ poly) & 0xFFFF if (r & 0x8000) else (r << 1) & 0xFFFF
        table[b] = r
    return table


_CCITT_TABLE = _make_table(0x1021)


def crc16_ccitt(data: bytes | np.ndarray, init: int = 0xFFFF) -> int:
    """CRC16-CCITT-FALSE (poly 0x1021, init 0xFFFF) of one message."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.asarray(data, dtype=np.uint8)
    crc = np.uint16(init)
    for b in arr:
        crc = np.uint16(((crc << 8) & 0xFFFF) ^ _CCITT_TABLE[(crc >> 8) ^ b])
    return int(crc)


def crc16_ccitt_batch(data: np.ndarray, init: int = 0xFFFF) -> np.ndarray:
    """CRC16-CCITT of a batch of messages: data [batch, n] -> crc [batch]."""
    data = np.atleast_2d(np.asarray(data, dtype=np.uint8))
    crc = np.full(data.shape[0], init, dtype=np.uint16)
    for i in range(data.shape[1]):
        crc = ((crc << 8) & 0xFFFF) ^ _CCITT_TABLE[(crc >> 8) ^ data[:, i]]
    return crc
