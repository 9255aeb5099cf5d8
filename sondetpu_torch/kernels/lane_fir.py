"""FIR in the lane experiment's form (counterpart:
``tools/exp_chanfilt.py:lane_fir``).

``y[m] = sum_t x[m + t] * h[t]`` over t ascending, the first product not
added to zero: the lane-shift Pallas kernel that the channel-filter
experiment held against XLA's depthwise conv. For the symmetric lowpass
taps of ``design_lowpass`` it equals ``dsp.fir.apply_windows`` up to the
order of the sum.

:func:`lane_fir` launches the CUDA kernel of ``csrc/lane_fir.cu`` for CUDA
tensors and runs :func:`lane_fir_plain` for CPU tensors; the two agree bit
for bit. The kernel compiles in the experiment's 41 taps (body ``t41``) and
takes any other count up to 64 at run time (``runtime_t``).
"""

from __future__ import annotations

import numpy as np
import torch

from sondetpu_torch.kernels import cuda

FIXED_TAPS = 41               # the tap count csrc/lane_fir.cu compiles in


def _check_args(x, h):
    c, ln = x.shape
    ntaps = len(h)
    if not 1 <= ntaps <= 64:
        raise ValueError(f"{ntaps} taps (1 to 64)")
    if ln < ntaps:
        raise ValueError(f"rows of {ln} samples are shorter than {ntaps} taps")
    return c, ln - ntaps + 1, ntaps


def lane_fir_plain(x: torch.Tensor, h) -> torch.Tensor:
    """Plain torch twin of :func:`lane_fir` (same arguments and result)."""
    c, n, ntaps = _check_args(x, h)
    hv = torch.as_tensor(np.asarray(h, np.float32), device=x.device)
    acc = x[:, 0:n] * hv[0]
    for t in range(1, ntaps):
        acc = acc + x[:, t:t + n] * hv[t]
    return acc


def lane_fir(x: torch.Tensor, h) -> torch.Tensor:
    """x [C, n + ntaps - 1] float32, h: NumPy float32 taps (at most 64)
    -> y [C, n] float32, ``y[m] = sum_t x[m + t] * h[t]``.

    CPU tensors run the plain twin; CUDA tensors launch the kernel."""
    dev = x.device
    if dev.type == "cpu":
        return lane_fir_plain(x, h)
    if dev.type != "cuda":
        raise ValueError(f"lane_fir: unsupported device {dev}")
    c, n, ntaps = _check_args(x, h)
    cuda.check_tensor("x", x, torch.float32, dev, (c, n + ntaps - 1))
    if c > 65535:
        raise ValueError(f"lane_fir: {c} channels exceed the grid's 65535 "
                         "rows")
    hv = np.ascontiguousarray(h, np.float32)
    y = torch.empty((c, n), dtype=torch.float32, device=dev)
    cuda.launch("lane_fir", "sondetpu_lane_fir", x.data_ptr(), hv.ctypes.data,
                ntaps, c, n + ntaps - 1, y.data_ptr(), cuda.stream_handle(dev),
                body="t41" if ntaps == FIXED_TAPS else "runtime_t")
    return y
