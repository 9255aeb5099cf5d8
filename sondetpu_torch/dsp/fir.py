"""Filter design and streaming FIR application (counterpart:
``sondetpu/dsp/fir.py``).

``design_lowpass`` and ``gaussian_taps`` are NumPy copies of the originals
(the original module imports jax): the port designs the same taps from the
same config. ``apply_windows``/``conv1d`` are the torch form of
``_apply_windows``/``_conv1d``: a causal FIR (correlation with reversed
taps) with an optional stride, accumulated in float32 in a fixed order. A
bfloat16 input is filtered with the taps rounded to bfloat16, as the
original's conv takes them; the products of two bfloat16 values are exact
in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _blackman_harris(n: int) -> np.ndarray:
    k = np.arange(n)
    a0, a1, a2, a3 = 0.35875, 0.48829, 0.14128, 0.01168
    return (a0 - a1 * np.cos(2 * np.pi * k / (n - 1))
            + a2 * np.cos(4 * np.pi * k / (n - 1))
            - a3 * np.cos(6 * np.pi * k / (n - 1)))


def design_lowpass(cutoff_hz: float, fs: float, ntaps: int) -> np.ndarray:
    """Windowed-sinc lowpass, Blackman-Harris window, unity DC gain."""
    if ntaps % 2 == 0:
        raise ValueError(f"ntaps must be odd, got {ntaps}")
    n = np.arange(ntaps) - (ntaps - 1) / 2
    fc = cutoff_hz / fs
    h = np.sinc(2 * fc * n) * 2 * fc
    h *= _blackman_harris(ntaps)
    h /= h.sum()
    return h.astype(np.float32)


def gaussian_taps(bt: float, sps: float, span: int = 4) -> np.ndarray:
    """Gaussian pulse-shaping filter for GFSK (BT product ``bt``)."""
    ntaps = int(span * sps) | 1
    t = (np.arange(ntaps) - (ntaps - 1) / 2) / sps
    sigma = np.sqrt(np.log(2)) / (2 * np.pi * bt)
    h = np.exp(-(t ** 2) / (2 * sigma ** 2))
    h /= h.sum()
    return h.astype(np.float32)


class FIRState(NamedTuple):
    """Per-channel FIR carry: the last ``ntaps-1`` input samples."""

    tail: torch.Tensor  # [channels, ntaps-1]


def _taps(taps, x: torch.Tensor) -> torch.Tensor:
    """The taps as float32 on x's device, rounded to bfloat16 first when x
    is bfloat16."""
    h = torch.as_tensor(np.asarray(taps, np.float32), device=x.device)
    if x.dtype == torch.bfloat16:
        h = h.to(torch.bfloat16).to(torch.float32)
    return h


def conv1d(x: torch.Tensor, kernel, stride: int = 1) -> torch.Tensor:
    """Valid 1-D correlation of every row of ``x`` [C, n] with ``kernel``
    [L]: ``out[c, i] = sum_k kernel[k] * x[c, i*stride + k]``, float32.

    Summed in ascending k, every product and every sum rounded on its own:
    the order the CUDA kernels use, so a kernel can be held to this bit for
    bit (``F.conv1d`` leaves the order to the backend, and cuDNN rounds to
    TF32 by default on the card)."""
    k = _taps(kernel, x)
    n_out = (x.shape[-1] - k.shape[0]) // stride + 1
    x = x.to(torch.float32)
    acc = torch.zeros((x.shape[0], n_out), dtype=torch.float32, device=x.device)
    for j in range(k.shape[0]):
        acc = acc + k[j] * x[:, j: j + stride * (n_out - 1) + 1: stride]
    return acc


def apply_windows(xp: torch.Tensor, taps, stride: int = 1) -> torch.Tensor:
    """[C, n + ntaps - 1] padded input -> [C, n // stride] causal FIR
    ``y[m] = sum_u taps[u] * xp[m*stride + ntaps - 1 - u]``, summed in
    ascending u with every operation rounded on its own (see
    :func:`conv1d`)."""
    h = _taps(taps, xp)
    ntaps = h.shape[0]
    n_out = (xp.shape[-1] - ntaps) // stride + 1
    xp = xp.to(torch.float32)
    acc = torch.zeros((xp.shape[0], n_out), dtype=torch.float32,
                      device=xp.device)
    for u in range(ntaps):
        o = ntaps - 1 - u
        acc = acc + h[u] * xp[:, o: o + stride * (n_out - 1) + 1: stride]
    return acc
