"""Peak pick: the frame starts of a syncword correlation (counterpart:
``sondetpu/sync/correlator.py:find_frame_starts``, jnp ops, not a Pallas
kernel).

:func:`peak_pick` launches the CUDA kernel of ``csrc/peak_pick.cu`` for
CUDA tensors, one launch a call, and runs :func:`find_frame_starts_plain`
for CPU tensors; the two agree bit for bit. Both devices refuse the same
arguments: a dtype other than float32 (the correlations of every route
are float32) and a candidate set beyond the kernel's shared-memory plan.
"""

from __future__ import annotations

import operator

import torch

from sondetpu_torch.kernels import cuda

PLAN_BYTES = 48 * 1024        # the shared memory a block of csrc/peak_pick.cu
                              # may take (no opt-in above the default)


def _windows(n: int, min_distance: int) -> tuple:
    """(half, nb): the half-window width and the number of half-windows of
    a row of ``n`` columns."""
    half = max(min_distance // 2, 1)
    return half, -(-n // half)


def shared_bytes(n: int, max_peaks: int, min_distance: int) -> int:
    """The shared memory a row's block takes: the 2 nb candidates' values
    and positions and the picks' positions and flags, 4 bytes each
    (``csrc/peak_pick.cu:smem_bytes``)."""
    _, nb = _windows(n, min_distance)
    return 4 * (4 * nb + 2 * max_peaks)


def _check_args(corr, max_peaks, min_distance) -> tuple:
    if not isinstance(corr, torch.Tensor) or corr.dim() != 2:
        raise ValueError("peak_pick: corr must be a [C, n] tensor")
    if corr.dtype != torch.float32:
        raise TypeError(f"peak_pick: dtype {corr.dtype}, expected float32")
    max_peaks = operator.index(max_peaks)
    min_distance = operator.index(min_distance)
    if max_peaks < 1:
        raise ValueError(f"peak_pick: max_peaks {max_peaks} (1 or more)")
    if corr.shape[1] < 1:
        raise ValueError("peak_pick: rows of no columns")
    need = shared_bytes(corr.shape[1], max_peaks, min_distance)
    if need > PLAN_BYTES:
        raise ValueError(
            f"peak_pick: {2 * _windows(corr.shape[1], min_distance)[1]} "
            f"candidates and {max_peaks} picks take {need} bytes of shared "
            f"memory, beyond the kernel's plan of {PLAN_BYTES}")
    return max_peaks, min_distance


def find_frame_starts_plain(corr: torch.Tensor, threshold: float,
                            max_peaks: int, min_distance: int):
    """The eager twin of :func:`peak_pick` (same arguments and result).

    The two-level search of the original: per half-window block the top-2
    values are candidates, then an iterative argmax with
    +/-``min_distance`` suppression runs on the candidates. Ties resolve to
    the first index, as in JAX, and the final position sort is stable, as
    ``jnp.argsort`` is."""
    c, n = corr.shape
    dev = corr.device
    half, nb = _windows(n, min_distance)
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


def _max_first(x: torch.Tensor):
    """(max, index of its first occurrence) over the last axis, as
    ``jnp.max``/``jnp.argmax``."""
    v = torch.amax(x, dim=-1)
    idx = torch.arange(x.shape[-1], device=x.device)
    first = torch.where(x == v[..., None], idx, x.shape[-1]).amin(dim=-1)
    return v, first


def peak_pick(corr: torch.Tensor, threshold: float, max_peaks: int,
              min_distance: int):
    """corr [C, n] float32 -> (starts [C, K] int32 sorted ascending, ok
    [C, K] bool), K = ``max_peaks``: up to K correlation peaks a row at
    least ``min_distance`` apart, ``ok`` where a peak reaches
    ``threshold``, as :func:`find_frame_starts_plain` picks them.

    CPU tensors run the twin; CUDA tensors launch the kernel, which takes
    its arguments by value and copies nothing from the host."""
    max_peaks, min_distance = _check_args(corr, max_peaks, min_distance)
    dev = corr.device
    if dev.type == "cpu":
        return find_frame_starts_plain(corr, threshold, max_peaks,
                                       min_distance)
    if dev.type != "cuda":
        raise ValueError(f"peak_pick: unsupported device {dev}")
    c, n = corr.shape
    half, nb = _windows(n, min_distance)
    corr = corr.contiguous()
    starts = torch.empty((c, max_peaks), dtype=torch.int32, device=dev)
    ok = torch.empty((c, max_peaks), dtype=torch.bool, device=dev)
    if c == 0:
        return starts, ok
    # every distance between two positions lies in [0, n): a distance
    # beyond n suppresses as n does, one below 0 as -1
    md = min(max(min_distance, -1), n)
    cuda.launch("peak_pick", "sondetpu_peak_pick", corr.data_ptr(), c, n,
                half, nb, float(threshold), max_peaks, md, starts.data_ptr(),
                ok.data_ptr(), cuda.stream_handle(dev))
    return starts, ok
