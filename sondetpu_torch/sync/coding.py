"""Line decoding and bit packing (counterpart: ``sondetpu/sync/coding.py``).

``manchester_decode`` and ``biphase_m_decode`` are the torch form of the
originals, on uint8 tensors with any leading batch dims. The NumPy
helpers ``np_bits_to_bytes`` and ``np_bytes_to_bits`` are jax-free copies:
the original module imports jax at the top.
"""

from __future__ import annotations

import numpy as np
import torch


def manchester_decode(chips: torch.Tensor, invert: bool = False
                      ) -> torch.Tensor:
    """IEEE Manchester: chip pair (1,0) -> 1, (0,1) -> 0 (swapped if
    ``invert``). chips [..., 2*n] uint8 -> bits [..., n] uint8."""
    a = chips[..., 0::2]
    b = chips[..., 1::2]
    if invert:
        return ((1 - a) & b).to(torch.uint8)
    return (a & (1 - b)).to(torch.uint8)


def biphase_m_decode(chips: torch.Tensor) -> torch.Tensor:
    """Biphase-Mark: a transition mid-cell encodes 1, none encodes 0.
    chips [..., 2*n] uint8 -> bits [..., n] uint8."""
    return (chips[..., 0::2] ^ chips[..., 1::2]).to(torch.uint8)


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
