"""Symbol timing (counterpart: ``sondetpu/sync/timing.py``).

``oerder_meyr_tau`` with ``symbol_sample`` is the feed-forward clock the
pipeline inlines: the symbol-rate spectral line of ``x**2`` gives each
block's timing phase, and a per-channel NCO carry slews toward it.
``gardner_scan`` is the original's feedback Gardner loop, a Python loop
over symbols that advances every channel at once (a few launches a
symbol on the card), kept as library code and oracle.
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


def timing_init(channels: int, device="cuda") -> TimingState:
    return TimingState(
        pos=torch.zeros((channels,), dtype=torch.float32, device=device),
        locked=torch.zeros((channels,), dtype=torch.float32, device=device))


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


def oerder_meyr_tau(x: torch.Tensor, sps: float, cos_w=None,
                    sin_w=None) -> torch.Tensor:
    """Feed-forward timing estimate per channel.

    x: [channels, n] real baseband; cos_w, sin_w: [n] from
    :func:`spectral_line_tables` (built on x's device when not given; the
    pipeline passes its cached tables). Returns tau [channels] in samples,
    in [0, sps): the offset of symbol centers from the block start.
    """
    if cos_w is None or sin_w is None:
        c, s = spectral_line_tables(x.shape[-1], sps)
        cos_w = torch.from_numpy(c).to(x.device)
        sin_w = torch.from_numpy(s).to(x.device)
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


def symbol_sample(state: TimingState, x: torch.Tensor, sps: float,
                  n_sym: int, slew: float = 0.5):
    """Sample symbol centers from block ``x`` [channels, n], continuing the
    per-channel symbol clock. Returns (new_state, soft [channels, n_sym],
    valid [channels, n_sym]); ``n_sym`` >= floor(n/sps)+1 (invalid slots
    are masked). Each block the NCO phase moves toward the block's
    Oerder-Meyr estimate by at most ``slew`` samples (wrap-aware), and is
    clamped, not wrapped, to [0, sps - 1e-3]: a wrap would skip the symbol
    just before the block edge."""
    n = x.shape[-1]
    dev = x.device
    tau = oerder_meyr_tau(x, sps)
    pos0 = torch.as_tensor(state.pos, device=dev)
    locked = torch.as_tensor(state.locked, device=dev)
    err = torch.remainder(tau - pos0 + sps / 2.0, float(sps)) - sps / 2.0
    corrected = pos0 + torch.clamp(err, -slew, slew)
    start = torch.where(locked > 0, corrected, tau)
    start = torch.clamp(start, 0.0, sps - 1e-3)
    k = torch.arange(n_sym, dtype=torch.float32, device=dev)
    pos = start[:, None] + k[None, :] * sps            # [channels, n_sym]
    # a symbol anywhere inside [0, n) belongs to this block; one in the
    # last fractional interval extrapolates from the last two samples
    valid = pos < n
    soft = torch.where(valid, linear_interp(x, pos), 0.0)
    # next block's phase: the first symbol position beyond this block
    n_fit = torch.sum(valid, dim=-1).to(torch.float32)
    next_pos = start + n_fit * sps - n
    return (TimingState(pos=next_pos, locked=torch.ones_like(locked)),
            soft, valid)


def gardner_scan(x: torch.Tensor, sps: float, n_sym: int,
                 gain: float = 0.02):
    """Classic Gardner timing-error-detector loop over ``n_sym`` symbols,
    every channel at once. Returns (soft [channels, n_sym], valid
    [channels, n_sym]). Its interpolator does not clamp the fraction
    (``sondetpu/sync/timing.py:132-137``), unlike :func:`linear_interp`."""
    c, n = x.shape
    dev = x.device

    def interp(pos):
        p0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 2)
        frac = pos - p0.to(pos.dtype)
        a = torch.gather(x, 1, p0[:, None])[:, 0]
        b = torch.gather(x, 1, p0[:, None] + 1)[:, 0]
        return a + (b - a) * frac

    pos = torch.full((c,), sps, dtype=torch.float32, device=dev)
    prev = torch.zeros((c,), dtype=x.dtype, device=dev)
    soft, valid = [], []
    for _ in range(n_sym):
        mid = interp(pos - sps / 2.0)
        cur = interp(pos)
        # Gardner TED: e = (cur - prev) * mid
        e = (cur - prev) * mid
        v = pos <= (n - 1)
        soft.append(torch.where(v, cur, 0.0))
        valid.append(v)
        pos = pos + sps - torch.clamp(gain * e, -sps / 4, sps / 4)
        prev = cur
    return torch.stack(soft, dim=1), torch.stack(valid, dim=1)
