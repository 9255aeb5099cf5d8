"""RS syndrome flag per frame (counterpart:
``sondetpu/pallas/syndrome.py:rs_clean_kernel`` / ``rs_clean_flags_pallas``).

:func:`rs_clean_flags_kernel` launches the CUDA kernel of
``csrc/syndrome.cu`` (XOR parity against the bit-packed syndrome matrix)
for CUDA tensors and runs :func:`rs_clean_plain` (the float GF(2) product
of ``fec.syndrome.rs_clean_flags``) for CPU tensors. Both are exact.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from sondetpu_torch.fec.syndrome import layout_matrix, rs_clean_flags
from sondetpu_torch.kernels import cuda

rs_clean_plain = rs_clean_flags


def pack_syndrome_matrix(w: np.ndarray) -> np.ndarray:
    """W [rows, ncols] 0/1 -> [rows, ceil(ncols/32)] uint32, column
    32*k + j in bit j of word k (padding columns are 0)."""
    rows, ncols = w.shape
    nw = -(-ncols // 32)
    bits = np.zeros((rows, nw * 32), np.uint64)
    bits[:, :ncols] = np.asarray(w) != 0
    weights = np.left_shift(np.uint64(1), np.arange(32, dtype=np.uint64))
    return (bits.reshape(rows, nw, 32) * weights).sum(axis=-1).astype(np.uint32)


@lru_cache(maxsize=8)
def _packed_on(frame_bytes: int, layout: tuple, device: torch.device):
    w = pack_syndrome_matrix(layout_matrix(frame_bytes, dict(layout)))
    return torch.from_numpy(w.view(np.int32)).to(device)


def rs_clean_flags_kernel(frames: torch.Tensor, rs_layout: dict) -> torch.Tensor:
    """frames [..., frame_bytes] uint8 -> clean [...] bool: True iff every
    RS syndrome of the frame is zero. CPU tensors run the plain twin; CUDA
    tensors launch the kernel."""
    dev = frames.device
    if dev.type == "cpu":
        return rs_clean_plain(frames, rs_layout)
    if dev.type != "cuda":
        raise ValueError(f"rs_clean_flags_kernel: unsupported device {dev}")
    if frames.dim() < 1:
        raise ValueError("rs_clean_flags_kernel: frames need a byte axis")
    cuda.check_tensor("frames", frames, torch.uint8, dev)
    fb = frames.shape[-1]
    lead = frames.shape[:-1]
    r = int(np.prod(lead)) if lead else 1
    w = _packed_on(fb, tuple(sorted(rs_layout.items())), dev)
    out = torch.empty(lead, dtype=torch.bool, device=dev)
    if r == 0:
        return out
    cuda.launch("rs_clean", "sondetpu_rs_clean", frames.data_ptr(),
                w.data_ptr(), r, fb, w.shape[1], out.data_ptr(),
                cuda.stream_handle(dev))
    return out
