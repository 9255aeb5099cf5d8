"""Syncword correlator (counterpart: ``sondetpu/pallas/corr.py:corr_kernel``).

:func:`corr_kernel` launches the CUDA kernel of ``csrc/corr.cu`` for CUDA
tensors and runs :func:`corr_plain` for CPU tensors; the two agree bit for
bit (same order of operations, each rounded on its own).
"""

from __future__ import annotations

import numpy as np
import torch

from sondetpu_torch.dsp.fir import conv1d
from sondetpu_torch.kernels import cuda


def corr_plain(chipbuf: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """chipbuf [C, buf], template [L] -> corr [C, buf - L + 1]:
    ``(sum_k t[k] * buf[c, i + k]) * float32(1/L)``, as the Pallas
    correlator scales it (``sondetpu/pallas/corr.py:28``). The plain
    ``correlate_syncword`` divides by L instead."""
    t = template.cpu().numpy()
    inv_l = torch.tensor(np.float32(1.0 / t.shape[0]), device=chipbuf.device)
    return conv1d(chipbuf, t) * inv_l


def corr_kernel(chipbuf: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """chipbuf [C, buf] float32, template [L] float32 on the same device
    -> corr [C, buf - L + 1] float32, normalized so a perfect hard match
    scores 1.0. CPU tensors run the plain twin; CUDA tensors launch the
    kernel."""
    dev = chipbuf.device
    if dev.type == "cpu":
        return corr_plain(chipbuf, template)
    if dev.type != "cuda":
        raise ValueError(f"corr_kernel: unsupported device {dev}")
    cuda.check_tensor("chipbuf", chipbuf, torch.float32, dev, (None, None))
    cuda.check_tensor("template", template, torch.float32, dev, (None,))
    c, buf = chipbuf.shape
    L = template.shape[0]
    if not 1 <= L <= min(buf, 2048):
        raise ValueError(f"corr_kernel: template length {L} for a buffer of "
                         f"{buf} (at most 2048)")
    if c > 65535:
        raise ValueError(f"corr_kernel: {c} channels exceed the grid's 65535 "
                         "rows")
    out = torch.empty((c, buf - L + 1), dtype=torch.float32, device=dev)
    cuda.launch("corr", "sondetpu_corr", chipbuf.data_ptr(),
                template.data_ptr(), L, float(np.float32(1.0 / L)), c, buf,
                out.data_ptr(), cuda.stream_handle(dev))
    return out
