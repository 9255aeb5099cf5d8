"""Hamming(8,4) codec for the DFM family (SURVEY.md S2; a copy of
``sondetpu/fec/hamming.py``).

GRAW DFM06/09/17 protect each 4-bit data nibble with an (8,4) extended-
Hamming-class code (BASELINE.json:9 "Hamming FEC"). The code here is the
REAL on-air DFM code as established by the public decoder ecosystem
(PROTOCOLS.md "dfm"): systematic, codeword bits

    [m0 m1 m2 m3 p0 p1 p2 p3]        (m0 = MSB of the nibble)
    p0 = m1^m2^m3   p1 = m0^m2^m3   p2 = m0^m1^m3   p3 = m0^m1^m2

with minimum distance 4: single-bit errors correct, double-bit errors are
detected (fail). Decode is a pure 256-entry syndrome lookup table — applied
as one NumPy gather over all received codewords of all channels at once
("vectorized Hamming syndrome LUT", SURVEY.md S2). Codewords are carried as
bytes with the first transmitted bit in the MSB.
"""

from __future__ import annotations

import numpy as np


def _encode_nibble(d: int) -> int:
    m0, m1, m2, m3 = (d >> 3) & 1, (d >> 2) & 1, (d >> 1) & 1, d & 1
    p0 = m1 ^ m2 ^ m3
    p1 = m0 ^ m2 ^ m3
    p2 = m0 ^ m1 ^ m3
    p3 = m0 ^ m1 ^ m2
    return (m0 << 7) | (m1 << 6) | (m2 << 5) | (m3 << 4) \
        | (p0 << 3) | (p1 << 2) | (p2 << 1) | p3


_ENC = np.array([_encode_nibble(d) for d in range(16)], dtype=np.uint8)

# syndrome decode table: for each received byte, (nibble, ok)
_DEC = np.zeros(256, dtype=np.uint8)
_OK = np.zeros(256, dtype=bool)
for _d in range(16):
    cw = int(_ENC[_d])
    _DEC[cw] = _d
    _OK[cw] = True
    for _b in range(8):            # all single-bit corruptions correct back
        e = cw ^ (1 << _b)
        _DEC[e] = _d
        _OK[e] = True
# everything else (incl. all double-bit errors, distance >= 2 from every
# codeword at d_min = 4) stays _OK = False: detected, not miscorrected.


def hamming84_encode(nibbles: np.ndarray) -> np.ndarray:
    """nibbles [...] 0..15 -> codeword bytes (first tx bit in the MSB)."""
    return _ENC[np.asarray(nibbles, dtype=np.uint8) & 0x0F]


def hamming84_decode(codewords: np.ndarray):
    """codewords [...] uint8 -> (nibbles [...], ok [...] bool)."""
    cw = np.asarray(codewords, dtype=np.uint8)
    return _DEC[cw], _OK[cw]
