"""Fused AFSK tone discriminator (counterpart:
``sondetpu/pallas/frontend.py:fused_afsk_frontend``).

Stage 2 of the AFSK front end (iMet-4, SRS-C50): on the DC-removed FM
discriminator audio, mix by the mark and the space tone, take a
``win``-tap boxcar of the I and Q product of each tone, and form the
normalized envelope difference ``(Em - Es) / (Em + Es + 1e-9)``.

:func:`fused_afsk_frontend` launches the CUDA kernel of ``csrc/afsk.cu``
for CUDA tensors and runs :func:`fused_afsk_frontend_plain` for CPU
tensors. The two take every product and sum in the same order, each
rounded on its own, so they agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from sondetpu_torch.kernels import cuda
from sondetpu_torch.kernels.frontend import HALO


def afsk_tables(n: int, fmark_over_fs: float, fspace_over_fs: float):
    """The mark and space LO tables over block positions [-HALO, n):
    (mark cos, mark sin, space cos, space sin), NumPy float32 [HALO + n]
    each, entry ``HALO + g`` for position g.

    Position g is wrapped to ``p = g mod n`` and ``frac = (p * f/fs) mod 1``
    is taken in float64 before the trig, rounded once: the values the
    Pallas kernel's per-chunk tables hold (``frontend.py:702-713``). The
    caller gates on the tones' joint period dividing n, so no LO phase is
    carried between blocks."""
    p = np.arange(-HALO, n, dtype=np.int64) % n
    tabs = []
    for fof in (fmark_over_fs, fspace_over_fs):
        frac = np.mod(p.astype(np.float64) * float(fof), 1.0)
        tabs.append(np.cos(2.0 * np.pi * frac).astype(np.float32))
        tabs.append(np.sin(2.0 * np.pi * frac).astype(np.float32))
    return tuple(tabs)


def _check_args(audio, tabs, win):
    c, n = audio.shape
    if not 2 <= win <= HALO + 1:
        raise ValueError(f"boxcar width {win} (2 <= win <= {HALO + 1}: the "
                         f"history comes from the {HALO}-sample tail)")
    if n < HALO:
        raise ValueError(f"block of {n} samples is shorter than the "
                         f"{HALO}-sample carried tail")
    if len(tabs) != 4 or any(t.shape[-1] != HALO + n for t in tabs):
        raise ValueError(f"expected 4 LO tables of {HALO + n} entries "
                         "(afsk_tables)")
    return c, n


def fused_afsk_frontend_plain(audio, atail, tabs, win: int):
    """Plain torch twin of :func:`fused_afsk_frontend` (same arguments and
    results)."""
    c, n = _check_args(audio, tabs, win)
    dev = audio.device
    h = win - 1
    # audio at positions [-(win - 1), n)
    a = torch.cat([atail[:, HALO - h:], audio], dim=-1)
    inv_win = torch.tensor(np.float32(1.0 / win), device=dev)

    def box(p):
        # sum of positions m, m - 1, ..., m - win + 1, from zero
        acc = torch.zeros((c, n), dtype=torch.float32, device=dev)
        for v in range(win):
            o = h - v
            acc = acc + p[:, o:o + n]
        return acc * inv_win

    energies = []
    for tc, ts in (tabs[0:2], tabs[2:4]):
        fi = box(a * tc[HALO - h:])
        fq = box(a * ts[HALO - h:])
        energies.append(fi * fi + fq * fq)
    em, es = energies
    eps = torch.tensor(np.float32(1e-9), device=dev)
    return (em - es) / (em + es + eps), audio[:, -HALO:].contiguous()


def fused_afsk_frontend(audio, atail, tabs, win: int):
    """Mark/space mix (the :func:`afsk_tables` ``tabs`` on the same device)
    -> ``win``-tap boxcar on the four products -> soft chips
    ``(Em - Es) / (Em + Es + 1e-9)``.

    audio [C, n] float32, the DC-removed discriminator audio of the block;
    atail [C, HALO] float32, the previous block's last HALO audio samples.
    Returns (soft [C, n], new atail [C, HALO]).

    CPU tensors run the plain twin; CUDA tensors launch the kernel (its
    compile-time body at win 40 or 20, the run-time one otherwise).
    """
    dev = audio.device
    if dev.type == "cpu":
        return fused_afsk_frontend_plain(audio, atail, tabs, win)
    if dev.type != "cuda":
        raise ValueError(f"fused_afsk_frontend: unsupported device {dev}")
    c, n = _check_args(audio, tabs, win)
    cuda.check_tensor("audio", audio, torch.float32, dev, (c, n))
    cuda.check_tensor("atail", atail, torch.float32, dev, (c, HALO))
    for name, t in zip(("mark_cos", "mark_sin", "space_cos", "space_sin"),
                       tabs):
        cuda.check_tensor(name, t, torch.float32, dev, (HALO + n,))
    if c > 65535:
        raise ValueError(f"fused_afsk_frontend: {c} channels exceed the "
                         "grid's 65535 rows")
    soft = torch.empty((c, n), dtype=torch.float32, device=dev)
    cuda.launch("fused_afsk_frontend", "sondetpu_afsk_frontend",
                audio.data_ptr(), atail.data_ptr(),
                *(t.data_ptr() for t in tabs), win,
                float(np.float32(1.0 / win)), c, n, HALO, soft.data_ptr(),
                cuda.stream_handle(dev),
                body=f"win{win}" if win in (20, 40) else "runtime_win")
    return soft, audio[:, -HALO:].contiguous()
