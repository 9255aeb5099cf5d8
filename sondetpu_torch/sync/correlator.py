"""Frame synchronization: syncword template, correlation, peak picking,
frame gather (counterpart: ``sondetpu/sync/correlator.py``).

``correlate_syncword`` is the plain correlation, what the dual-tone and
AFSK families correlate with, as in the original.
"""

from __future__ import annotations

import numpy as np
import torch

from sondetpu_torch.kernels.lane_fir import plain_corr, plain_corr_plain
from sondetpu_torch.kernels.peak_pick import peak_pick
from sondetpu_torch.sync.coding import np_bytes_to_bits


def syncword_to_chips(syncword: bytes, lsb_first: bool = False) -> np.ndarray:
    """Convert a syncword byte string to a +/-1 float32 chip template."""
    bits = np_bytes_to_bits(np.frombuffer(syncword, dtype=np.uint8), lsb_first)
    return (bits.astype(np.float32) * 2.0 - 1.0)


def correlate_syncword(soft: torch.Tensor, template) -> torch.Tensor:
    """Correlate soft symbols [channels, n] against template [L].

    Returns corr [channels, n - L + 1] float32,
    ``(sum_k t[k] * soft[c, i + k]) / L``, normalized so a perfect hard
    match scores 1.0. It divides by L as the JAX ``correlate_syncword``
    does (the correlator kernel's twin multiplies by ``float32(1/L)``
    instead, which rounds differently unless L is a power of two).

    On a CUDA device one launch of the plain correlation kernel
    (``kernels/lane_fir.py:plain_corr``, float32 or bfloat16 soft symbols,
    L up to 256); elsewhere the formula it equals bit for bit
    (``plain_corr_plain``)."""
    if soft.device.type == "cuda":
        return plain_corr(soft, template)
    return plain_corr_plain(soft, template)


def find_frame_starts(corr: torch.Tensor, threshold: float, max_peaks: int,
                      min_distance: int):
    """Pick up to ``max_peaks`` correlation peaks per channel.

    The same two-level search as the original: per half-window block the
    top-2 values are candidates, then an iterative argmax with
    +/-``min_distance`` suppression runs on the candidates. Ties resolve to
    the first index, as in JAX, and the final position sort is stable, as
    ``jnp.argsort`` is. corr is float32. Returns (starts [C, K] int32
    sorted ascending, ok [C, K] bool).

    On a CUDA device one launch of the peak-pick kernel
    (``kernels/peak_pick.py:peak_pick``); elsewhere the eager ops it equals
    bit for bit (``find_frame_starts_plain``)."""
    return peak_pick(corr, threshold, max_peaks, min_distance)


def gather_frames(stream: torch.Tensor, starts: torch.Tensor,
                  ok: torch.Tensor, frame_len: int):
    """Gather fixed-length frames at per-channel offsets.

    stream [C, n] (bits or soft symbols); starts, ok [C, K]. Returns
    (frames [C, K, frame_len], valid [C, K]): one contiguous slice per
    (channel, slot) from the start clamped to [0, n - frame_len], and
    valid = ok & the whole frame fits inside the stream."""
    c, n = stream.shape
    k = starts.shape[1]
    valid = ok & (starts + frame_len <= n)
    if n < frame_len:
        return (torch.zeros((c, k, frame_len), dtype=stream.dtype,
                            device=stream.device), valid & False)
    safe = torch.clamp(starts, 0, n - frame_len).to(torch.int64)
    rows = torch.arange(c, device=stream.device)[:, None]
    # a view [C, n - frame_len + 1, frame_len]; indexing copies only the
    # [C, K, frame_len] result
    return stream.unfold(1, frame_len, 1)[rows, safe], valid

