"""Polyphase filter-bank channelizer: wideband IQ -> N baseband channels
(counterpart: ``sondetpu/dsp/channelizer.py``).

A critically sampled N-channel DFT filter bank on real I/Q planes, the same
function as the original's time-major formulation:

    vv[r, j] = xp[r*N + j]                     (xp = concat(tail, block))
    u[r, j]  = sum_t hcol[t, j] * vv[r + tpp - 1 - t (+1 if j == 0), j]
    y[k, r]  = sum_j u[r, j] * exp(-2*pi*i*j*k/N)

Column j of vv holds branch (N - j) % N, and the DFT's sign -1 absorbs that
reversal, so channel k is centred at +k * fs_chan (k taken mod N, negative
above N/2). The branch FIR runs kernel ``pfb_fir_stream``, or
``pfb_fir_timemajor`` when the block is shorter than the filter history;
the DFT runs ``pfb_dft``, which writes channel k at row k (for N a
power of two from 8 to 4096; any other N takes its plain twin).

Streaming: the last ``N * tpp`` wideband samples carry across blocks, so
chunked channelization equals unchunked.

``dtype="bf16"`` runs both stages in bfloat16 as the original's bf16
channelizer does (the branch FIR rounds to bfloat16 on its read and after
every operation; the DFT reads bfloat16 and rounds its float32 transform
once): y comes out in bfloat16, and the carried tail stays float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sondetpu_torch.dsp.fir import design_lowpass
from sondetpu_torch.kernels.pfb import (TPP, pfb_dft, pfb_dft_plain,
                                        pfb_fir_stream, pfb_fir_timemajor,
                                        twiddle_table)

CUTOFF_FRAC = 0.45   # prototype cutoff, in units of the channel spacing


class ChannelizerState(NamedTuple):
    tail_i: torch.Tensor    # [N * tpp] last wideband I samples
    tail_q: torch.Tensor    # [N * tpp] last wideband Q samples


def bin_and_offset(center_hz: float, fs_chan: float, n_bins: int):
    """Map an arbitrary carrier frequency to (pfb_bin, fine_offset_hz): the
    nearest bin (mod N) and the alias-equivalent residual in
    [-fs_chan/2, fs_chan/2]."""
    r = round(center_hz / fs_chan)
    return int(r) % n_bins, center_hz - r * fs_chan


class PFBChannelizer:
    """Critically sampled N-channel analysis filter bank on ``device``,
    in ``dtype`` "f32" or "bf16", with the original's defaults: ``TPP``
    taps per phase (the FIR kernel's only size) and a cutoff of
    ``CUTOFF_FRAC``."""

    def __init__(self, n_channels: int, device, dtype: str = "f32"):
        if dtype not in ("f32", "bf16"):
            raise ValueError(dtype)
        self.dtype = dtype
        self._cdt = torch.bfloat16 if dtype == "bf16" else torch.float32
        self.n = int(n_channels)
        self.tpp = TPP
        self.device = torch.device(device)
        L = self.n * self.tpp
        # prototype lowpass at the channel Nyquist, unity passband; the
        # same NumPy design and layout as the original
        proto = design_lowpass(CUTOFF_FRAC, float(self.n), L + 1)[:L] * self.n
        self._hbank = proto.reshape(self.tpp, self.n).T.astype(np.float32)
        # column taps for the time-major FIR: column j holds branch
        # p = (N - j) % N
        perm = np.zeros(self.n, np.int64)
        perm[1:] = self.n - np.arange(1, self.n)
        self._hcol = np.ascontiguousarray(self._hbank[perm].T)  # [tpp, N]
        self._hcol_t = torch.from_numpy(self._hcol).to(self.device)
        # the DFT kernel covers powers of two from 8 to 4096; any other N
        # runs its plain twin (torch.fft) on the card, as the original runs
        # its XLA DFT where its kernel's tile does not fit
        # (sondetpu/dsp/channelizer.py:214-222)
        self._dft_kernel = 8 <= self.n <= 4096 and not self.n & (self.n - 1)
        self._twiddles = (tuple(torch.from_numpy(t).to(self.device)
                                for t in twiddle_table(self.n))
                          if self.device.type == "cuda" and self._dft_kernel
                          else None)

    @property
    def history(self) -> int:
        return self.n * self.tpp

    def init_state(self) -> ChannelizerState:
        z = torch.zeros(self.history, dtype=torch.float32, device=self.device)
        return ChannelizerState(tail_i=z, tail_q=z.clone())

    def center_freqs(self, fs_wide: float) -> np.ndarray:
        """Center frequency of each output channel (Hz, negative above
        N/2)."""
        k = np.arange(self.n)
        k = np.where(k < self.n / 2, k, k - self.n)
        return k * fs_wide / self.n

    def bin_and_offset(self, center_hz: float, fs_chan: float):
        """See :func:`bin_and_offset`."""
        return bin_and_offset(center_hz, fs_chan, self.n)

    def __call__(self, state: ChannelizerState, x_i: torch.Tensor,
                 x_q: torch.Tensor):
        """One block: wideband planes [W] float32 on the channelizer's
        device, W % N == 0 -> (state, y_i [N, W/N], y_q [N, W/N]) in natural
        channel order, in the channelizer's dtype."""
        n, tpp, L = self.n, self.tpp, self.history
        w = x_i.shape[-1]
        if x_i.dim() != 1 or x_q.shape != x_i.shape or w % n:
            raise ValueError(f"wideband planes of shape {tuple(x_i.shape)}: "
                             f"expected [W] with W a multiple of {n}")
        m = w // n
        x_i = x_i.to(torch.float32).contiguous()
        x_q = x_q.to(torch.float32).contiguous()
        if w >= L:
            u_i, u_q = pfb_fir_stream(
                x_i.view(m, n), x_q.view(m, n), state.tail_i.view(tpp, n),
                state.tail_q.view(tpp, n), self._hcol_t, self._cdt)
            new_state = ChannelizerState(tail_i=x_i[-L:].clone(),
                                         tail_q=x_q[-L:].clone())
        else:
            xp_i = torch.cat([state.tail_i, x_i])
            xp_q = torch.cat([state.tail_q, x_q])
            u_i, u_q = pfb_fir_timemajor(xp_i.view(-1, n), xp_q.view(-1, n),
                                         self._hcol_t, self._cdt)
            new_state = ChannelizerState(tail_i=xp_i[-L:].clone(),
                                         tail_q=xp_q[-L:].clone())
        if not self._dft_kernel:
            return (new_state, *pfb_dft_plain(u_i, u_q))
        y_i, y_q = pfb_dft(u_i, u_q, self._twiddles)
        return new_state, y_i, y_q
