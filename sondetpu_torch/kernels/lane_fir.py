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

:func:`plain_corr` is the plain syncword correlation on the same kernel
design (the file's second entry): ``conv1d(x, t) / L`` bit for bit, which
:func:`plain_corr_plain` computes and CPU tensors run. It takes float32 or
bfloat16 rows, compiles in m10's two template lengths (bodies ``t80`` and
``t64``) and takes any other length up to 256 at run time (``runtime_t``);
its taps ride in the launch, so it copies nothing to the card and does not
synchronise.

:func:`plain_fir` is the plain-op front end's filter on the same design
(the file's third entry): ``dsp.fir.window_sum`` bit for bit, which CPU
tensors run, and what ``dsp.fir.apply_windows`` launches for CUDA tensors.
It takes float32 or bfloat16 rows at any stride, compiles in RS41's 41
taps at strides 2 and 1 (bodies ``t41_d2`` and ``t41_d1``: its channel and
matched filters) and takes any other count or stride at run time
(``runtime_t``); its taps ride in the launch, 256 a launch, more chaining
launches.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from sondetpu_torch.dsp.fir import conv1d, window_sum
from sondetpu_torch.kernels import cuda

FIXED_TAPS = 41               # the tap count csrc/lane_fir.cu compiles in
CORR_MAX_TAPS = 256           # csrc/lane_fir.cu CORR_MAX_TAPS
CORR_FIXED_LENGTHS = (80, 64)  # template lengths plain_corr compiles in
FIR_FIXED_STRIDES = (2, 1)    # strides plain_fir compiles in at 41 taps


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


def plain_corr_plain(x: torch.Tensor, template) -> torch.Tensor:
    """The plain correlation, ``conv1d(x, template) / L`` (x of any dtype
    conv1d takes): the twin of :func:`plain_corr`, and what
    ``correlate_syncword`` computes on the CPU. L is a 0-d tensor on x's
    device: CUDA turns a division by a Python number into a multiply by
    its reciprocal, which rounds otherwise."""
    t = np.asarray(template, np.float32)
    return conv1d(x, t) / torch.full((), float(t.shape[0]),
                                     dtype=torch.float32, device=x.device)


def plain_corr_body(length: int) -> str:
    """The body of :func:`plain_corr` that runs a template of ``length``
    taps: ``t80`` or ``t64`` compiled in, else ``runtime_t``."""
    return f"t{length}" if length in CORR_FIXED_LENGTHS else "runtime_t"


def _host_taps(taps) -> np.ndarray:
    """The taps as contiguous float32 NumPy (a tensor is copied to the
    host)."""
    if isinstance(taps, torch.Tensor):
        taps = taps.detach().cpu().numpy()
    return np.ascontiguousarray(taps, np.float32)


def _corr_args(x, template) -> np.ndarray:
    """Check x and the template; return the template as float32 NumPy."""
    t = _host_taps(template)
    if t.ndim != 1 or not 1 <= t.shape[0] <= CORR_MAX_TAPS:
        raise ValueError(f"plain_corr: template of shape {t.shape} (1 to "
                         f"{CORR_MAX_TAPS} taps)")
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("plain_corr: x must be a [C, n] tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"plain_corr: dtype {x.dtype}, expected float32 or "
                        "bfloat16")
    if x.shape[1] < t.shape[0]:
        raise ValueError(f"plain_corr: rows of {x.shape[1]} samples are "
                         f"shorter than {t.shape[0]} taps")
    return t


def plain_corr(x: torch.Tensor, template) -> torch.Tensor:
    """x [C, n] float32 or bfloat16 (rows may be a view with a row stride
    of their own), template [L] float32 (NumPy, or a tensor, copied to the
    host) -> [C, n - L + 1] float32, ``(sum_k t[k] * x[c, i + k]) / L`` as
    :func:`plain_corr_plain` rounds it.

    CPU tensors run the plain twin; CUDA tensors launch the kernel."""
    t = _corr_args(x, template)
    dev = x.device
    if dev.type == "cpu":
        return plain_corr_plain(x, t)
    if dev.type != "cuda":
        raise ValueError(f"plain_corr: unsupported device {dev}")
    c, ln = x.shape
    L = t.shape[0]
    if x.stride(1) != 1 or (c > 1 and x.stride(0) < ln):
        x = x.contiguous()
    if x.dtype == torch.bfloat16:
        # conv1d takes the taps rounded to bfloat16 for a bfloat16 input
        t = torch.from_numpy(t).to(torch.bfloat16).float().numpy()
    y = torch.empty((c, ln - L + 1), dtype=torch.float32, device=dev)
    if c == 0:
        return y
    cuda.launch("plain_corr", "sondetpu_plain_corr", x.data_ptr(),
                int(x.dtype == torch.bfloat16), t.ctypes.data, L, c, ln,
                x.stride(0), y.data_ptr(), cuda.stream_handle(dev),
                body=plain_corr_body(L))
    return y


def plain_fir_body(ntaps: int, stride: int) -> str:
    """The body of :func:`plain_fir` that runs ``ntaps`` taps at
    ``stride``: ``t41_d2`` or ``t41_d1`` compiled in, else ``runtime_t``."""
    if ntaps == FIXED_TAPS and stride in FIR_FIXED_STRIDES:
        return f"t41_d{stride}"
    return "runtime_t"


def _fir_args(xp, taps, stride) -> tuple:
    """Check the rows, taps and stride; return (taps as float32 NumPy, the
    stride as an int, outputs a row)."""
    h = _host_taps(taps)
    if h.ndim != 1 or h.shape[0] < 1:
        raise ValueError(f"plain_fir: taps of shape {h.shape} (one or more)")
    if not isinstance(xp, torch.Tensor) or xp.dim() != 2:
        raise ValueError("plain_fir: xp must be a [C, n] tensor")
    if xp.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"plain_fir: dtype {xp.dtype}, expected float32 or "
                        "bfloat16")
    stride = operator.index(stride)
    if stride < 1:
        raise ValueError(f"plain_fir: stride {stride} (1 or more)")
    n_out = (xp.shape[1] - h.shape[0]) // stride + 1
    if n_out < 0:
        raise ValueError(f"plain_fir: rows of {xp.shape[1]} samples are "
                         f"shorter than {h.shape[0]} taps")
    return h, stride, n_out


def plain_fir(xp: torch.Tensor, taps, stride: int = 1) -> torch.Tensor:
    """xp [C, n + T - 1] float32 or bfloat16 (rows may be a view with a row
    stride of their own), taps [T] float32 (NumPy, or a tensor, copied to
    the host) -> [C, n // stride] float32, ``y[m] = sum_u taps[u] *
    xp[m*stride + T - 1 - u]`` as :func:`dsp.fir.window_sum` rounds it
    (the taps rounded to bfloat16 for a bfloat16 input).

    CPU tensors run ``window_sum``; CUDA tensors launch the kernel."""
    h, stride, n_out = _fir_args(xp, taps, stride)
    dev = xp.device
    if dev.type == "cpu":
        return window_sum(xp, taps, stride)
    if dev.type != "cuda":
        raise ValueError(f"plain_fir: unsupported device {dev}")
    c, ln = xp.shape
    if xp.stride(1) != 1 or (c > 1 and xp.stride(0) < ln):
        xp = xp.contiguous()
    if xp.dtype == torch.bfloat16:
        # window_sum takes the taps rounded to bfloat16 for a bfloat16 input
        h = torch.from_numpy(h).to(torch.bfloat16).float().numpy()
    y = torch.empty((c, n_out), dtype=torch.float32, device=dev)
    if c == 0 or n_out == 0:
        return y
    cuda.launch("plain_fir", "sondetpu_plain_fir", xp.data_ptr(),
                int(xp.dtype == torch.bfloat16), h.ctypes.data, h.shape[0],
                stride, c, ln, xp.stride(0), y.data_ptr(),
                cuda.stream_handle(dev), body=plain_fir_body(h.shape[0],
                                                             stride))
    return y
