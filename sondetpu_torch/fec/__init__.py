"""Host FEC and the device-side RS syndrome check (counterparts:
``sondetpu/fec/{gf256,crc,rs,hamming,bch,native,syndrome}.py``).

``gf256``, ``crc``, ``rs``, ``hamming`` and ``bch`` are copies of the
originals; ``native`` builds the port's copy of the C++ FEC
(``csrc/sondefec.cpp``) at first use; ``syndrome`` carries the syndrome
matrices and the plain torch form of the RS flag."""
