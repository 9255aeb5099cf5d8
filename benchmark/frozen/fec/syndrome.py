"""Reed-Solomon syndrome check as a GF(2) product (counterpart:
``sondetpu/fec/syndrome.py``).

``syndrome_matrix`` and ``frame_syndrome_matrix`` are NumPy copies of the
originals (the original module imports jax); ``rs_clean_flags`` is the plain
torch form of the check: bits(frame) @ W, reduced mod 2, all zero -> clean.
The CUDA kernel is ``sondetpu_torch.kernels.syndrome``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from benchmark.frozen.fec.gf256 import GF256


def _mul_const_bits(gf: GF256, k: int) -> np.ndarray:
    """[8, 8] 0/1: bit b' of x contributes bit b of GF_mul(x, k)."""
    m = np.zeros((8, 8), np.float32)
    for bp in range(8):
        prod = int(gf.mul(1 << bp, k))
        for b in range(8):
            if (prod >> b) & 1:
                m[bp, b] = 1.0
    return m


@lru_cache(maxsize=8)
def syndrome_matrix(n: int, nroots: int, fcr: int = 0, prim: int = 0x11D
                    ) -> np.ndarray:
    """W [8*n, 8*nroots] float32 0/1: bit b' of symbol j contributes
    bit b of syndrome i iff W[8j+b', 8i+b] = 1 (symbol j has degree
    n-1-j)."""
    gf = GF256(prim)
    w = np.zeros((8 * n, 8 * nroots), dtype=np.float32)
    for j in range(n):
        deg = n - 1 - j
        for i in range(nroots):
            k = int(gf.exp[(deg * (fcr + i)) % 255])     # alpha^{deg*(fcr+i)}
            w[8 * j:8 * j + 8, 8 * i:8 * i + 8] = _mul_const_bits(gf, k)
    return w


@lru_cache(maxsize=8)
def frame_syndrome_matrix(frame_bytes: int, data_start: int, parity_start: int,
                          nroots: int, interleave: int, fcr: int = 0,
                          prim: int = 0x11D) -> np.ndarray:
    """W_full [8*frame_bytes, 8*nroots*interleave]: the interleaved-codeword
    layout baked into one frame-level matrix (rows byte-major: 8*byte +
    bit)."""
    gf = GF256(prim)
    nrs = (frame_bytes - data_start) // interleave
    n = nrs + nroots
    w = np.zeros((8 * frame_bytes, 8 * nroots * interleave), dtype=np.float32)
    for i in range(interleave):
        for j in range(n):
            if j < nrs:
                b_idx = data_start + interleave * j + i
            else:
                b_idx = parity_start + nroots * i + (j - nrs)
            deg = n - 1 - j
            for r in range(nroots):
                k = int(gf.exp[(deg * (fcr + r)) % 255])
                col = 8 * (i * nroots + r)
                w[8 * b_idx:8 * b_idx + 8, col:col + 8] = _mul_const_bits(gf, k)
    return w


def layout_matrix(frame_bytes: int, rs_layout: dict) -> np.ndarray:
    """frame_syndrome_matrix for a spec's ``extra['rs']`` layout."""
    return frame_syndrome_matrix(
        frame_bytes, rs_layout["data_start"], rs_layout["parity_start"],
        rs_layout["nroots"], rs_layout.get("interleave", 2),
        rs_layout.get("fcr", 0), rs_layout.get("prim", 0x11D))


def rs_clean_flags(frames: torch.Tensor, rs_layout: dict) -> torch.Tensor:
    """frames [..., frame_bytes] uint8 -> clean [...] bool.

    True iff every syndrome of every interleaved codeword is zero. The
    float32 product of 0/1 values is exact (sums stay below 2**24)."""
    fb = frames.shape[-1]
    w = torch.from_numpy(layout_matrix(fb, rs_layout)).to(frames.device)
    shifts = torch.arange(8, dtype=torch.int32, device=frames.device)
    bits = ((frames.to(torch.int32)[..., None] >> shifts) & 1).to(torch.float32)
    bits = bits.reshape(bits.shape[:-2] + (8 * fb,))
    snd = bits @ w
    odd = snd.to(torch.int32) & 1
    return odd.sum(dim=-1) == 0
