"""Host FEC and the device-side RS syndrome check (counterparts:
``sondetpu/fec/{gf256,crc,rs,hamming,bch,native,syndrome}.py``).

``gf256``, ``crc``, ``rs``, ``hamming`` and ``bch`` are copies of the
originals; ``native`` builds the port's copy of the C++ FEC
(``csrc/sondefec.cpp``) at first use; ``syndrome`` carries the syndrome
matrices and the plain torch form of the RS flag. The package exports the
original's names; importing it builds nothing (the native FEC builds at
its first use)."""

from sondetpu_torch.fec.crc import crc16_ccitt, crc16_ccitt_batch
from sondetpu_torch.fec.gf256 import GF256
from sondetpu_torch.fec.rs import ReedSolomon, RS255_231
from sondetpu_torch.fec.hamming import hamming84_encode, hamming84_decode
from sondetpu_torch.fec.bch import BCH, BCH_63_51

__all__ = [
    "crc16_ccitt", "crc16_ccitt_batch", "GF256",
    "ReedSolomon", "RS255_231",
    "hamming84_encode", "hamming84_decode",
    "BCH", "BCH_63_51",
]
