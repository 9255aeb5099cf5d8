"""RS syndrome flag per frame (counterpart:
``sondetpu/pallas/syndrome.py:rs_clean_kernel`` / ``rs_clean_flags_pallas``).

:func:`rs_clean_flags_kernel` launches the CUDA kernel of
``csrc/syndrome.cu`` (column parities of the frame words against the
column-packed syndrome matrix) for CUDA tensors and runs
:func:`rs_clean_plain` (the float GF(2) product of
``fec.syndrome.rs_clean_flags``) for CPU tensors. Both are exact. The
kernel has a body per padded column count, which :func:`syndrome_body`
names.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from sondetpu_torch.fec.syndrome import layout_matrix, rs_clean_flags
from sondetpu_torch.kernels import cuda

rs_clean_plain = rs_clean_flags

# padded column counts csrc/syndrome.cu compiles in, and their bodies
BODY_COLUMNS = {"c384": 384, "c512": 512}


def syndrome_body(ncols: int) -> str:
    """The kernel body for a syndrome matrix of ``ncols`` columns: the
    narrowest compiled width that holds them (padding columns are zero)."""
    for body, width in BODY_COLUMNS.items():
        if 1 <= ncols <= width:
            return body
    raise ValueError(f"rs_clean_flags_kernel: {ncols} syndrome columns "
                     f"(1 to {max(BODY_COLUMNS.values())})")


def pack_syndrome_columns(w: np.ndarray) -> np.ndarray:
    """W [rows, ncols] 0/1 -> WT [ceil(rows/32), width] uint32, the
    kernel's column packing: bit t of WT[k, c] is W[32k + t, c], zero past
    the last row and in the columns from ncols up to the body's width."""
    rows, ncols = w.shape
    width = BODY_COLUMNS[syndrome_body(ncols)]
    nw = -(-rows // 32)
    bits = np.zeros((nw * 32, width), np.uint64)
    bits[:rows, :ncols] = np.asarray(w) != 0
    weights = np.left_shift(np.uint64(1), np.arange(32, dtype=np.uint64))
    return (bits.reshape(nw, 32, width) * weights[None, :, None]).sum(
        axis=1).astype(np.uint32)


@lru_cache(maxsize=8)
def _packed_on(frame_bytes: int, layout: tuple, device: torch.device):
    w = layout_matrix(frame_bytes, dict(layout))
    wt = pack_syndrome_columns(w)
    return torch.from_numpy(wt.view(np.int32)).to(device), syndrome_body(
        w.shape[1])


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
    wt, body = _packed_on(fb, tuple(sorted(rs_layout.items())), dev)
    out = torch.empty(lead, dtype=torch.bool, device=dev)
    if r == 0:
        return out
    cuda.launch("rs_clean", "sondetpu_rs_clean", frames.data_ptr(),
                wt.data_ptr(), r, fb, wt.shape[1], out.data_ptr(),
                cuda.stream_handle(dev), body=body)
    return out
