"""Filter design and streaming FIR application (counterpart:
``sondetpu/dsp/fir.py``).

``design_lowpass`` and ``gaussian_taps`` are NumPy copies of the originals
(the original module imports jax): the port designs the same taps from the
same config. ``apply_windows``/``conv1d`` are the torch form of
``_apply_windows``/``_conv1d``: a causal FIR (correlation with reversed
taps) with an optional stride, accumulated in float32 in a fixed order. A
bfloat16 input is filtered with the taps rounded to bfloat16, as the
original's conv takes them; the products of two bfloat16 values are exact
in float32. The sums are taken in place (the same rounding as a new
accumulator each tap), so a call holds one accumulator and one product
beside its input.

``boxcar_taps``, ``fir_init``, ``fir_filter`` and ``fir_apply`` are the
original's public streaming FIR on ``apply_windows``: a complex input is
filtered plane by plane (real, then imaginary, as the original's
``_apply_windows`` does), and ``fir_apply`` over chunks is ``torch.equal``
to ``fir_filter`` over the whole stream, since every output sums its own
window in the same order.

On a CUDA tensor ``apply_windows`` is one launch of the hand-written
filter ``kernels/lane_fir.py:plain_fir``, which sums in the same order
and rounds every operation alone, so the card gives ``window_sum``'s bits;
its taps ride in the launch. ``tap_passes`` counts the eager passes that
``apply_windows`` makes on any other device, one a tap (a product and an
in-place sum over the whole output): the plain-op front end's filters make
123 a step of RS41 at 41 taps on the CPU, none on the card (there
``cuda.launches["plain_fir"]`` counts its launches). The kernels' plain
twins filter through ``window_sum``, which counts none, as their kernels
make none on the card. A run resets it with :func:`reset_tap_passes` and
reads it afterwards.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

tap_passes = {"apply_windows": 0}


def reset_tap_passes() -> None:
    for k in tap_passes:
        tap_passes[k] = 0


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


def boxcar_taps(sps: int) -> np.ndarray:
    """Integrate-and-dump matched filter for rectangular NRZ pulses."""
    return (np.ones(sps) / sps).astype(np.float32)


class FIRState(NamedTuple):
    """Per-channel FIR carry: the last ``ntaps-1`` input samples."""

    tail: torch.Tensor  # [channels, ntaps-1]


def fir_init(channels: int, ntaps: int, dtype=torch.float32,
             device="cuda") -> FIRState:
    return FIRState(tail=torch.zeros((channels, ntaps - 1), dtype=dtype,
                                     device=device))


def _filter_padded(xp: torch.Tensor, taps) -> torch.Tensor:
    """apply_windows on a real input; a complex one plane by plane, as the
    original's ``_apply_windows`` (``sondetpu/dsp/fir.py:119-121``)."""
    if xp.is_complex():
        return torch.complex(apply_windows(xp.real, taps),
                             apply_windows(xp.imag, taps))
    return apply_windows(xp, taps)


def fir_filter(x: torch.Tensor, taps) -> torch.Tensor:
    """Causal batched FIR: y[n] = sum_k h[k] * x[n - k], zero initial
    state. x [channels, n] -> [channels, n] (float32, or complex64 for a
    complex x)."""
    pad = torch.zeros((x.shape[0], len(taps) - 1), dtype=x.dtype,
                      device=x.device)
    return _filter_padded(torch.cat([pad, x], dim=-1), taps)


def fir_apply(state: FIRState, x: torch.Tensor, taps):
    """Streaming FIR step: filter block ``x`` [channels, n] with carry;
    chunked ``fir_apply`` equals ``fir_filter`` of the whole stream.
    Returns (new_state, y); the new tail is in x's dtype."""
    ntaps = len(taps)
    xp = torch.cat([state.tail.to(x.dtype), x], dim=-1)
    y = _filter_padded(xp, taps)
    new_tail = xp[:, -(ntaps - 1):] if ntaps > 1 else state.tail
    return FIRState(tail=new_tail), y


def _taps(taps, x: torch.Tensor) -> torch.Tensor:
    """The taps (host values or a tensor) as float32 on x's device, rounded
    to bfloat16 first when x is bfloat16."""
    if isinstance(taps, torch.Tensor):
        h = taps.to(device=x.device, dtype=torch.float32)
    else:
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
        acc += k[j] * x[:, j: j + stride * (n_out - 1) + 1: stride]
    return acc


def apply_windows(xp: torch.Tensor, taps, stride: int = 1) -> torch.Tensor:
    """[C, n + ntaps - 1] padded input -> [C, n // stride] causal FIR
    ``y[m] = sum_u taps[u] * xp[m*stride + ntaps - 1 - u]``, summed in
    ascending u with every operation rounded on its own (see
    :func:`conv1d`): on a CUDA tensor one launch of ``plain_fir``, else
    :func:`window_sum`, counted in ``tap_passes``."""
    if xp.device.type == "cuda":
        # imported here: kernels.lane_fir imports this module
        from sondetpu_torch.kernels.lane_fir import plain_fir

        if xp.dtype not in (torch.float32, torch.bfloat16):
            xp = xp.to(torch.float32)       # as window_sum widens it
        return plain_fir(xp, taps, stride)
    tap_passes["apply_windows"] += len(taps)
    return window_sum(xp, taps, stride)


def window_sum(xp: torch.Tensor, taps, stride: int = 1) -> torch.Tensor:
    """:func:`apply_windows`' eager passes, uncounted: the kernels' plain
    twins, ``plain_fir``'s among them."""
    h = _taps(taps, xp)
    ntaps = h.shape[0]
    n_out = (xp.shape[-1] - ntaps) // stride + 1
    xp = xp.to(torch.float32)
    acc = torch.zeros((xp.shape[0], n_out), dtype=torch.float32,
                      device=xp.device)
    for u in range(ntaps):
        o = ntaps - 1 - u
        acc += h[u] * xp[:, o: o + stride * (n_out - 1) + 1: stride]
    return acc
