"""Bit packing for the host side (counterpart: ``sondetpu/sync/coding.py``).

Jax-free copy of ``np_bits_to_bytes`` and ``np_bytes_to_bits``: the
original module imports jax at the top, so the port carries the two NumPy
helpers it needs.
"""

from __future__ import annotations

import numpy as np


def np_bits_to_bytes(bits: np.ndarray, lsb_first: bool = False) -> np.ndarray:
    b = np.asarray(bits, dtype=np.uint8).reshape(*bits.shape[:-1], -1, 8)
    w = np.array([1, 2, 4, 8, 16, 32, 64, 128] if lsb_first
                 else [128, 64, 32, 16, 8, 4, 2, 1], dtype=np.uint32)
    return (b * w).sum(axis=-1).astype(np.uint8)


def np_bytes_to_bits(data: np.ndarray, lsb_first: bool = False) -> np.ndarray:
    data = np.asarray(data, dtype=np.uint8)
    shifts = np.arange(8) if lsb_first else np.arange(7, -1, -1)
    bits = (data[..., None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], -1).astype(np.uint8)
