"""Frame synchronization: syncword template, correlation, peak picking,
frame gather (counterpart: ``sondetpu/sync/correlator.py``).

``correlate_syncword`` is the plain correlation, what the dual-tone and
AFSK families correlate with, as in the original.
"""

from __future__ import annotations

import numpy as np
import torch

from sondetpu_torch.dsp.fir import conv1d
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
    instead, which rounds differently unless L is a power of two). L is a
    tensor on the input's device: CUDA turns a division by a Python number
    into a multiply by its reciprocal, which is that other rounding.
    """
    t = np.asarray(template, np.float32)
    return conv1d(soft, t) / torch.full((), float(t.shape[0]),
                                        dtype=torch.float32, device=soft.device)


def find_frame_starts(corr: torch.Tensor, threshold: float, max_peaks: int,
                      min_distance: int):
    """Pick up to ``max_peaks`` correlation peaks per channel.

    The same two-level search as the original: per half-window block the
    top-2 values are candidates, then an iterative argmax with
    +/-``min_distance`` suppression runs on the candidates. Ties resolve to
    the first index, as in JAX, and the final position sort is stable, as
    ``jnp.argsort`` is. Returns (starts [C, K] int32 sorted ascending,
    ok [C, K] bool).
    """
    c, n = corr.shape
    dev = corr.device
    half = max(min_distance // 2, 1)
    nb = -(-n // half)
    cp = torch.nn.functional.pad(corr, (0, nb * half - n), value=-float("inf"))
    blocks = cp.reshape(c, nb, half)
    v1, a1 = _max_first(blocks)
    masked = blocks.scatter(-1, a1[..., None], -float("inf"))
    v2, a2 = _max_first(masked)
    base = half * torch.arange(nb, device=dev)[None, :]
    cand_v = torch.cat([v1, v2], dim=-1)                    # [C, 2*nb]
    cand_p = torch.cat([a1 + base, a2 + base], dim=-1)
    idxs = []
    oks = []
    work = cand_v
    for _ in range(max_peaks):
        v, j = _max_first(work)
        p = torch.gather(cand_p, -1, j[:, None])[:, 0]
        idxs.append(p)
        oks.append(v >= threshold)
        work = torch.where((cand_p - p[:, None]).abs() <= min_distance,
                           torch.full_like(work, -float("inf")), work)
    starts = torch.stack(idxs, dim=-1).to(torch.int32)
    ok = torch.stack(oks, dim=-1)
    key = torch.where(ok, starts, torch.full_like(starts, n + 1))
    order = torch.argsort(key, dim=-1, stable=True)
    return torch.gather(starts, -1, order), torch.gather(ok, -1, order)


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


def _max_first(x: torch.Tensor):
    """(max, index of its first occurrence) over the last axis, as
    ``jnp.max``/``jnp.argmax``."""
    v = torch.amax(x, dim=-1)
    idx = torch.arange(x.shape[-1], device=x.device)
    first = torch.where(x == v[..., None], idx, x.shape[-1]).amin(dim=-1)
    return v, first
