"""Analog demodulators: FM quadrature discriminator, AFSK tone
discriminator (counterpart: ``sondetpu/dsp/demod.py``).

Batched over a channel axis; the one-sample carry of ``fm_apply`` makes
chunked demodulation ``torch.equal`` to demodulating the whole stream.
The original runs without float64, so its Python-float scale factors are
float32 values (taken here as Python floats, which torch multiplies in
float32) and its divisions are float32 divisions: the time axis of
``afsk_discriminate`` is divided by a 0-d tensor, since on a CUDA tensor
``x / fs`` would multiply by fl(1/fs).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from sondetpu_torch.dsp.fir import fir_filter


class FMState(NamedTuple):
    """Per-channel carry: the previous complex sample."""

    prev: torch.Tensor  # [channels] complex64


def fm_init(channels: int, device="cuda") -> FMState:
    return FMState(prev=torch.zeros((channels,), dtype=torch.complex64,
                                    device=device))


def _discriminate(iq: torch.Tensor, prev: torch.Tensor, fs: float,
                  deviation: float) -> torch.Tensor:
    # angle(x[n] * conj(x[n-1])) * fs / (2*pi*deviation)
    d = iq * torch.conj(prev)
    return torch.atan2(d.imag, d.real) * (fs / (2.0 * math.pi * deviation))


def fm_demod(iq: torch.Tensor, fs: float, deviation: float) -> torch.Tensor:
    """Stateless quadrature FM discriminator, zero initial phase reference.
    iq [channels, n] complex64 -> audio [channels, n] float32; a tone at
    +deviation reads +1.0."""
    prev = torch.cat([torch.zeros((iq.shape[0], 1), dtype=iq.dtype,
                                  device=iq.device), iq[:, :-1]], dim=-1)
    return _discriminate(iq, prev, fs, deviation)


def fm_apply(state: FMState, iq: torch.Tensor, fs: float, deviation: float):
    """Streaming FM discriminator step. Returns (new_state, audio)."""
    prev = torch.cat([state.prev.to(iq.dtype)[:, None], iq[:, :-1]], dim=-1)
    audio = _discriminate(iq, prev, fs, deviation)
    return FMState(prev=iq[:, -1]), audio


def afsk_discriminate(audio: torch.Tensor, fs: float, f_mark: float,
                      f_space: float, baud: float) -> torch.Tensor:
    """Dual-tone AFSK discriminator: +1 toward mark, -1 toward space.

    Quadrature correlators at the mark and space tones (cos and -sin of a
    float32 phase, as the original mixes) with a one-symbol boxcar
    (``fir_filter``); the difference of the envelope energies is the soft
    bit stream. audio [channels, n] float32."""
    n = audio.shape[-1]
    dev = audio.device
    t = torch.arange(n, dtype=torch.float32, device=dev) / torch.full(
        (), fs, dtype=torch.float32, device=dev)
    win = max(int(fs / baud), 1)
    box = np.ones(win, np.float32) / np.float32(win)

    def tone_energy(f):
        wt = t * (2.0 * math.pi * f)
        ci = audio * torch.cos(wt)
        cq = -audio * torch.sin(wt)
        i = fir_filter(ci, box)
        q = fir_filter(cq, box)
        return i * i + q * q

    return tone_energy(f_mark) - tone_energy(f_space)
