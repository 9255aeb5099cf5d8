"""Line decoding and bit packing (counterpart: ``sondetpu/sync/coding.py``).

``manchester_decode``, ``biphase_m_decode``, ``nrzs_decode``,
``bits_to_bytes``, ``bytes_to_bits`` and ``descramble_xor`` are the torch
form of the originals, on uint8 tensors with any leading batch dims, exact
(integer operations only). The NumPy helpers ``np_bits_to_bytes`` and
``np_bytes_to_bits`` are jax-free copies: the original module imports jax
at the top.
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


def nrzs_decode(bits: torch.Tensor, prev: torch.Tensor | None = None
                ) -> torch.Tensor:
    """NRZ-S differential decode: output 0 on transition, 1 on no
    transition. bits [..., n]; prev [...] the previous bit carry (0 when
    None)."""
    if bits.dtype == torch.bool:
        bits = bits.to(torch.uint8)
    if prev is None:
        prev = torch.zeros(bits.shape[:-1], dtype=bits.dtype,
                           device=bits.device)
    shifted = torch.cat([prev.to(bits.dtype)[..., None], bits[..., :-1]],
                        dim=-1)
    return (1 - (bits ^ shifted)).to(torch.uint8)


_MSB_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def bits_to_bytes(bits: torch.Tensor, lsb_first: bool = False
                  ) -> torch.Tensor:
    """Pack [..., 8*n] bits into [..., n] bytes."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8).to(torch.uint8)
    w = torch.tensor(_MSB_WEIGHTS[::-1] if lsb_first else _MSB_WEIGHTS,
                     dtype=torch.int32, device=bits.device)
    return (b.to(torch.int32) * w).sum(dim=-1).to(torch.uint8)


def bytes_to_bits(data, lsb_first: bool = False) -> torch.Tensor:
    """Unpack [..., n] bytes into [..., 8*n] bits."""
    data = torch.as_tensor(data).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    if not lsb_first:
        shifts = shifts.flip(0)
    bits = (data[..., None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8).to(torch.uint8)


def descramble_xor(frame: torch.Tensor, mask) -> torch.Tensor:
    """XOR-descramble bytes with a repeating mask (RS41 whitening).
    frame [..., n] uint8; mask [m] uint8 repeated cyclically from the frame
    start, tiled on the host and moved to the frame's device once."""
    n = frame.shape[-1]
    m = np.asarray(mask, dtype=np.uint8)
    full = np.tile(m, -(-n // m.size))[:n]
    return torch.bitwise_xor(frame, torch.from_numpy(full).to(frame.device))


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
