"""Rational resampling (counterpart: ``sondetpu/dsp/resample.py``).

``make_rational_resampler`` and the NumPy ``StreamingResampler`` are
copies of the originals (the original module imports jax).
``DeviceStreamingResampler`` is the original's static-shape streaming
resampler as torch ops on an explicit device, with the original's block
geometry, errors and history carry. Its step (``_dsr_step``) is plain
``jnp`` in the original, not a Pallas kernel, so here it is plain torch:
for each polyphase tap it gathers that tap's input for every output at
once through a strided view and adds its product, which keeps each
output's sum in the original's order (taps in order from the first
non-zero one; a zero tap adds an exact zero) in ``nph`` multiply-adds.
"""

from __future__ import annotations

from fractions import Fraction
from math import gcd

import numpy as np
import torch

from sondetpu_torch.dsp.fir import design_lowpass


def make_rational_resampler(fs_in: float, fs_out: float, ntaps_per_phase: int = 8):
    """Build a rational resampling plan fs_in -> fs_out."""
    frac = (fs_out / fs_in)
    # find rational approximation
    f = Fraction(frac).limit_denominator(1 << 14)
    up, down = f.numerator, f.denominator
    g = gcd(up, down)
    up //= g
    down //= g
    cutoff = 0.45 * min(fs_in, fs_out)
    ntaps = ntaps_per_phase * up
    if ntaps % 2 == 0:
        ntaps += 1
    taps = design_lowpass(cutoff, fs_in * up, ntaps) * up
    return up, down, taps


class StreamingResampler:
    """Stateful rational resampler: chunked output == unchunked output.

    The streaming form of SDR++'s RationalResampler (reference main.cpp:60
    resamples each channel's audio to 48 kHz continuously). Carries the
    polyphase filter history and the fractional output phase across blocks.
    Input blocks may be any length; output length varies per block
    (floor-accumulated), so this host-facing utility returns NumPy arrays.
    """

    def __init__(self, fs_in: float, fs_out: float, channels: int,
                 ntaps_per_phase: int = 8):
        self.up, self.down, taps = make_rational_resampler(
            fs_in, fs_out, ntaps_per_phase)
        taps = np.asarray(taps, dtype=np.float32)
        self.nph = -(-taps.size // self.up)
        tp = np.zeros(self.up * self.nph, dtype=np.float32)
        tp[: taps.size] = taps
        self._bank = tp.reshape(self.nph, self.up).T   # [up, nph]
        self.channels = channels
        self._hist = np.zeros((channels, self.nph - 1), dtype=np.float32)
        self._next_t = 0   # position of next output on the upsampled grid,
                           # relative to the first unconsumed input sample

    def process(self, x: np.ndarray) -> np.ndarray:
        """x: [channels, n] float32 -> [channels, m] resampled block."""
        x = np.asarray(x, dtype=np.float32)
        n = x.shape[-1]
        xp = np.concatenate([self._hist, x], axis=-1)
        # outputs at upsampled positions t = next_t, next_t+down, ... while
        # input index i = t // up < n
        t = self._next_t + self.down * np.arange(
            max(0, (n * self.up - self._next_t + self.down - 1) // self.down))
        t = t[t < n * self.up]
        i = t // self.up                     # input sample index in x
        ph = t % self.up                     # polyphase phase
        # window ends at xp index i + nph - 1 (i is index into x)
        win = np.lib.stride_tricks.sliding_window_view(xp, self.nph, axis=-1)
        sel = win[:, i, :]                   # [c, m, nph]
        coeffs = self._bank[ph][:, ::-1]     # [m, nph]
        y = np.einsum("cmj,mj->cm", sel, coeffs)
        self._hist = xp[:, -(self.nph - 1):] if self.nph > 1 else self._hist
        self._next_t = (t[-1] + self.down - n * self.up) if t.size else \
            (self._next_t - n * self.up)
        return y.astype(np.float32)


class DeviceStreamingResampler:
    """Static-shape streaming rational resampler for [n] sample planes on
    ``device``: lets any SDR capture rate feed the 48 kHz-grid pipeline
    (reference src/main.cpp:60).

    The block geometry is fixed at construction (``out_len`` output samples
    per block; the input length follows as out_len*down/up, which must be
    an integer: one-second blocks satisfy this for any integer rates), so
    the polyphase phase pattern repeats exactly every block: output
    m = k*up + r has phase (r*down) % up and input origin
    (r*down)//up + k*down.

    Carries the nph-1 input-sample history across blocks; chunked output
    equals unchunked. Integer input planes (cs16/cs8 wire formats)
    dequantize on the device, ``x.to(float32) * qs``, one rounding, keeping
    the host->device transfer narrow.
    """

    def __init__(self, fs_in: float, fs_out: float, out_len: int, device,
                 ntaps_per_phase: int = 8, input_dtype: str = "f32"):
        self.up, self.down, taps = make_rational_resampler(
            fs_in, fs_out, ntaps_per_phase)
        up, down = self.up, self.down
        if (out_len * down) % up:
            raise ValueError(
                f"out_len {out_len} not compatible with rate ratio "
                f"{up}/{down}: need out_len*{down} % {up} == 0 (use "
                "whole-second blocks)")
        if out_len % up:
            raise ValueError(
                f"out_len {out_len} must be a multiple of up={up}")
        self.in_len = out_len * down // up
        self.out_len = out_len
        self.device = torch.device(device)
        taps = np.asarray(taps, dtype=np.float32)
        self.nph = -(-taps.size // up)
        tp = np.zeros(up * self.nph, dtype=np.float32)
        tp[: taps.size] = taps
        bank = tp.reshape(self.nph, up).T               # [up, nph]
        self._bankrev = np.ascontiguousarray(bank[:, ::-1])
        if input_dtype not in ("f32", "i16", "i8"):
            raise ValueError(input_dtype)
        self._qs = {"f32": None, "i16": np.float32(1 / 32768.0),
                    "i8": np.float32(1 / 128.0)}[input_dtype]
        # output k*up + r reads xp[i0[r] + k*down + j] with tap
        # bankrev[(r*down) % up][j]: coef[j] is that tap for every r
        r = np.arange(up)
        self._i0 = torch.from_numpy((r * down) // up).to(self.device)
        self._coef = torch.from_numpy(np.ascontiguousarray(
            self._bankrev[(r * down) % up].T)).to(self.device)   # [nph, up]

    def init_state(self):
        z = torch.zeros(self.nph - 1, dtype=torch.float32, device=self.device)
        return (z, z.clone())

    def __call__(self, state, x_i, x_q):
        """state, planes [n_in] (1-D; NumPy arrays or tensors) ->
        (state', y_i [out_len], y_q [out_len]) on the device."""
        hist_i, hist_q = state
        (hist_i, hist_q), y_i, y_q = _dsr_step(self, hist_i, hist_q, x_i, x_q)
        return (hist_i, hist_q), y_i, y_q


def _dsr_step(rs: DeviceStreamingResampler, hist_i, hist_q, x_i, x_q):
    k_count = rs.out_len // rs.up
    span = int(rs._i0[-1]) + rs.nph          # input samples one k reads

    def one(hist, x):
        x = torch.as_tensor(x).to(rs.device)
        if tuple(x.shape) != (rs.in_len,):
            raise ValueError(f"resampler input {tuple(x.shape)}, expected "
                             f"({rs.in_len},)")
        if rs._qs is not None:
            x = x.to(torch.float32) * float(rs._qs)
        xp = torch.cat([hist, x.to(torch.float32)])
        # windows[k, :] = xp[k*down : k*down + span]: a strided view
        windows = xp[:(k_count - 1) * rs.down + span].unfold(0, span, rs.down)
        acc = torch.zeros((k_count, rs.up), dtype=torch.float32,
                          device=rs.device)
        for j in range(rs.nph):
            acc = acc + rs._coef[j] * windows.index_select(1, rs._i0 + j)
        new = xp[-(rs.nph - 1):] if rs.nph > 1 else hist
        return new, acc.reshape(rs.out_len)          # y[k*up + r]

    new_i, y_i = one(hist_i, x_i)
    new_q, y_q = one(hist_q, x_q)
    return (new_i, new_q), y_i, y_q
