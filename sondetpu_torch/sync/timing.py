"""Feed-forward symbol timing (counterpart: ``sondetpu/sync/timing.py``,
``TimingState``, ``oerder_meyr_tau`` and ``_linear_interp``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class TimingState(NamedTuple):
    """Per-channel symbol-clock carry.

    pos: next symbol-center position relative to the start of the next block,
         in samples (fractional, in [0, sps)).
    locked: 0.0 until the first block sets the phase from its estimate.
    """

    pos: torch.Tensor     # [channels] float32
    locked: torch.Tensor  # [channels] float32 (0 or 1)


def spectral_line_tables(n: int, sps: float):
    """cos(w), sin(w) [n] float32 for w = 2*pi*idx/sps, the angle formed in
    float32 in the order the JAX package forms it. The trig itself is taken
    in float64 of that float32 angle and rounded once, so the CPU and the
    card use the same tables (the angle reaches ~1.2e5 rad at 96000
    samples, where float32 range reduction differs between libraries)."""
    idx = np.arange(n, dtype=np.float32)
    w = np.float32(2.0 * np.pi) * idx / np.float32(sps)
    w64 = w.astype(np.float64)
    return np.cos(w64).astype(np.float32), np.sin(w64).astype(np.float32)


def oerder_meyr_tau(x: torch.Tensor, sps: float, cos_w: torch.Tensor,
                    sin_w: torch.Tensor) -> torch.Tensor:
    """Feed-forward timing estimate per channel.

    x: [channels, n] real baseband; cos_w, sin_w: [n] from
    :func:`spectral_line_tables`. Returns tau [channels] in samples, in
    [0, sps): the offset of symbol centers from the block start.
    """
    sq = x.to(torch.float32) ** 2
    cr = torch.sum(sq * cos_w, dim=-1)
    ci = -torch.sum(sq * sin_w, dim=-1)
    two_pi = torch.tensor(np.float32(2.0 * math.pi), device=x.device)
    tau = -torch.atan2(ci, cr) / two_pi * float(sps)
    return torch.remainder(tau, float(sps))


def linear_interp(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Linearly interpolate x [channels, n] at fractional positions pos
    [channels, m]; out-of-range positions clamp to the edges. The
    original's ``_linear_interp`` in its dtypes: ``b - a`` in x's dtype,
    then ``a + (b - a) * frac`` promoted to float32 by the float32
    ``frac``."""
    n = x.shape[-1]
    p0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 2)
    frac = torch.clamp(pos - p0.to(pos.dtype), 0.0, 1.0)
    a = torch.gather(x, -1, p0)
    b = torch.gather(x, -1, p0 + 1)
    return a + (b - a) * frac
