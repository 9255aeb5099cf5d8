"""Streaming automatic gain control (counterpart: ``sondetpu/dsp/agc.py``).

Per-channel one-pole envelope tracker with separate attack and decay,
updated once a block from the block's mean power and carried across
blocks. The FM discriminator is amplitude-invariant, so no decode path
needs it; it serves magnitude-sensitive front ends and external callers.
The original's divisions (the mean, the gain) are taken as divisions by
tensors: on a CUDA tensor ``x / n`` would multiply by fl(1/n), and a
Python number over a tensor is a reciprocal times the number.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AGCState(NamedTuple):
    env: torch.Tensor  # [channels] tracked envelope


def agc_init(channels: int, device="cuda") -> AGCState:
    return AGCState(env=torch.ones((channels,), dtype=torch.float32,
                                   device=device))


def agc_apply(state: AGCState, x_i: torch.Tensor, x_q: torch.Tensor,
              target: float = 1.0, attack: float = 0.1, decay: float = 0.01):
    """Normalize I/Q planes [channels, n] toward a target RMS; the gain is
    constant within a block. Returns (state, y_i, y_q, gain [channels])."""
    dev = x_i.device
    n = torch.full((), x_i.shape[-1], dtype=torch.float32, device=dev)
    power = torch.sum(x_i * x_i + x_q * x_q, dim=-1) / n
    rms = torch.sqrt(power + 1e-20)
    env0 = torch.as_tensor(state.env, device=dev)
    alpha = torch.where(rms > env0, attack, decay)
    env = env0 + alpha * (rms - env0)
    gain = torch.full((), target, dtype=torch.float32, device=dev) / \
        torch.clamp_min(env, 1e-10)
    return (AGCState(env=env), x_i * gain[:, None], x_q * gain[:, None], gain)
