"""Fused dual-tone noncoherent FSK front end (counterpart:
``sondetpu/pallas/frontend.py:fused_dualtone_frontend``).

:func:`fused_dualtone_frontend` launches the CUDA kernel of
``csrc/dualtone.cu`` for CUDA tensors and runs :func:`fused_dualtone_plain`
for CPU tensors. The two take every product and sum in the same order, each
rounded on its own, so the metric agrees bit for bit and the DC and
rotation sums up to their order of summation. Both read float32 or
bfloat16 planes and tails and compute in float32 (the original's Pallas
kernel casts bfloat16 input in VMEM): on bfloat16 input x they give
exactly what they give on x.float().
"""

from __future__ import annotations

import numpy as np
import torch

from sondetpu_torch.dsp.fir import apply_windows
from sondetpu_torch.kernels import cuda
from sondetpu_torch.kernels.frontend import HALO, input_dtype


def mixer_tables(n: int, dev_over_fs: float):
    """cos, sin(2*pi*frac) [n] float32 (NumPy) for frac = (p * dev/fs) mod 1
    at block positions p < n, taken in float64 and rounded once: the +/-dev
    mixer. ``dev * n / fs`` must be an integer, so the tables are periodic
    in n and a position p < 0 reads entry p + n."""
    frac = np.mod(np.arange(n, dtype=np.float64) * float(dev_over_fs), 1.0)
    return (np.cos(2.0 * np.pi * frac).astype(np.float32),
            np.sin(2.0 * np.pi * frac).astype(np.float32))


def dualtone_body(nb: int, skip_chanfilt: bool, want_afc: bool,
                  bf16: bool = False, ntaps: int = 41) -> str:
    """The kernel body that runs these arguments: with the channel filter
    skipped, nb = 5 (m10's one-chip boxcar at 48 kHz) compiled in or nb at
    run time; with the channel filter, ``ntaps`` = 41 taps (every path's
    count) and nb = 20 (ims100's and mrzn1's boxcar) compiled in, or both
    at run time; each with or without the AFC sums, for float32 or
    (``_bf16``) bfloat16 input."""
    if skip_chanfilt:
        name = "skip_nb5" if nb == 5 else "skip_runtime_nb"
    else:
        name = "chanfilt_t41_nb20" if (ntaps, nb) == (41, 20) else "chanfilt"
    return name + ("_afc" if want_afc else "") + ("_bf16" if bf16 else "")


def _check_args(iq_i, iq_q, tail_i, tail_q, chan_taps, tab_cos, nb,
                skip_chanfilt):
    input_dtype(iq_i, iq_q, tail_i, tail_q)
    c, n = iq_i.shape
    ntaps = len(chan_taps)
    if nb < 1:
        raise ValueError(f"boxcar width {nb}")
    if nb + (0 if skip_chanfilt else ntaps - 1) > HALO:
        raise ValueError(f"a {nb}-tap boxcar after {ntaps} channel-filter "
                         f"taps needs more than the {HALO}-sample tail")
    if tab_cos.shape[-1] != n:
        raise ValueError(f"mixer tables of {tab_cos.shape[-1]} entries for a "
                         f"block of {n}")
    return c, n, ntaps


def fused_dualtone_plain(iq_i, iq_q, tail_i, tail_q, chan_taps, tab_cos,
                         tab_sin, nb: int, want_afc: bool = False,
                         skip_chanfilt: bool = False):
    """Plain torch twin of :func:`fused_dualtone_frontend` (same arguments
    and results)."""
    c, n, T = _check_args(iq_i, iq_q, tail_i, tail_q, chan_taps, tab_cos,
                          nb, skip_chanfilt)
    dev = iq_i.device

    def chanfilt(tail, x):
        # cf at positions [-nb, n), from the input widened to float32
        xw = torch.cat([tail, x], dim=-1).to(torch.float32)
        if skip_chanfilt:
            return xw[:, HALO - nb:]
        return apply_windows(xw[:, HALO - nb - (T - 1):], chan_taps)

    cf_i = chanfilt(tail_i, iq_i)
    cf_q = chanfilt(tail_q, iq_q)
    pos = torch.arange(-nb, n, device=dev) % n
    cv = tab_cos[pos]
    sv = tab_sin[pos]
    planes = (cf_i * cv + cf_q * sv,       # +tone I  (x * e^{-j ang})
              cf_q * cv - cf_i * sv,       # +tone Q
              cf_i * cv - cf_q * sv,       # -tone I  (x * e^{+j ang})
              cf_q * cv + cf_i * sv)       # -tone Q
    inv_nb = torch.tensor(np.float32(1.0 / nb), device=dev)

    def box(p):
        # lp at positions [-1, n): sum of positions k - v, v < nb
        acc = torch.zeros((c, n + 1), dtype=torch.float32, device=dev)
        for v in range(nb):
            o = nb - 1 - v
            acc = acc + p[:, o:o + n + 1]
        return acc * inv_nb

    lpi, lpq, lmi, lmq = (box(p) for p in planes)
    pp = lpi * lpi + lpq * lpq
    pm = lmi * lmi + lmq * lmq
    eps = torch.tensor(np.float32(1e-12), device=dev)
    met = ((pp - pm) / (pp + pm + eps))[:, 1:]
    dc = torch.sum(met, dim=-1) / torch.full((), float(n),
                                             dtype=torch.float32, device=dev)
    if want_afc:
        # rotation products of the pairs (k, k - 1) for 1 <= k < n: lp
        # index k + 1 against index k
        rot_re = (lpi[:, 2:] * lpi[:, 1:-1] + lpq[:, 2:] * lpq[:, 1:-1]
                  + lmi[:, 2:] * lmi[:, 1:-1] + lmq[:, 2:] * lmq[:, 1:-1])
        rot_im = (lpq[:, 2:] * lpi[:, 1:-1] - lpi[:, 2:] * lpq[:, 1:-1]
                  + lmq[:, 2:] * lmi[:, 1:-1] - lmi[:, 2:] * lmq[:, 1:-1])
        rre, rim = torch.sum(rot_re, dim=-1), torch.sum(rot_im, dim=-1)
    else:
        rre = torch.zeros(c, dtype=torch.float32, device=dev)
        rim = torch.zeros(c, dtype=torch.float32, device=dev)
    return (met, iq_i[:, -HALO:].contiguous(), iq_q[:, -HALO:].contiguous(),
            dc, rre, rim)


def fused_dualtone_frontend(iq_i, iq_q, tail_i, tail_q, chan_taps, tab_cos,
                            tab_sin, nb: int, want_afc: bool = False,
                            skip_chanfilt: bool = False):
    """Optional channel filter (``chan_taps``) -> +/-dev mix (the
    :func:`mixer_tables` ``tab_cos``/``tab_sin`` [n] on the same device) ->
    ``nb``-tap boxcar on the four mixed planes -> envelope metric
    ``(P+ - P-) / (P+ + P- + 1e-12)``.

    iq planes [C, n] and tails [C, HALO] (the raw input that precedes the
    block), all float32 or all bfloat16; chan_taps: NumPy float32 array
    (ignored when ``skip_chanfilt``). Returns (metric [C, n], new tail_i,
    new tail_q [C, HALO] in the planes' dtype, dc [C], rot_re [C], rot_im
    [C]; the rest float32): dc is the block-mean metric; rot_re/rot_im are the AFC envelope-rotation sums over the pairs
    (k, k-1), 1 <= k < n (zeros unless ``want_afc``).

    CPU tensors run the plain twin; CUDA tensors launch the kernel body
    that :func:`dualtone_body` names.
    """
    dev = iq_i.device
    if dev.type == "cpu":
        return fused_dualtone_plain(iq_i, iq_q, tail_i, tail_q, chan_taps,
                                    tab_cos, tab_sin, nb, want_afc,
                                    skip_chanfilt)
    if dev.type != "cuda":
        raise ValueError(f"fused_dualtone_frontend: unsupported device {dev}")
    c, n, T = _check_args(iq_i, iq_q, tail_i, tail_q, chan_taps, tab_cos,
                          nb, skip_chanfilt)
    bf16 = iq_i.dtype == torch.bfloat16
    for name, t, shape in (("iq_i", iq_i, (c, n)), ("iq_q", iq_q, (c, n)),
                           ("tail_i", tail_i, (c, HALO)),
                           ("tail_q", tail_q, (c, HALO))):
        cuda.check_tensor(name, t, iq_i.dtype, dev, shape)
    for name, t in (("tab_cos", tab_cos), ("tab_sin", tab_sin)):
        cuda.check_tensor(name, t, torch.float32, dev, (n,))
    if c > 65535:
        raise ValueError(f"fused_dualtone_frontend: {c} channels exceed the "
                         "grid's 65535 rows")
    hc = np.ascontiguousarray(chan_taps, np.float32)
    lib = cuda.library()
    ntiles = lib.sondetpu_dualtone_tiles(n)
    metric = torch.empty((c, n), dtype=torch.float32, device=dev)
    parts = torch.zeros((3, c, ntiles), dtype=torch.float32, device=dev)
    cuda.launch("fused_dualtone_frontend", "sondetpu_dualtone_frontend",
                iq_i.data_ptr(), iq_q.data_ptr(), tail_i.data_ptr(),
                tail_q.data_ptr(), hc.ctypes.data, T, nb, tab_cos.data_ptr(),
                tab_sin.data_ptr(), int(skip_chanfilt), int(want_afc),
                int(bf16), c, n, HALO, metric.data_ptr(), parts[0].data_ptr(),
                parts[1].data_ptr(), parts[2].data_ptr(),
                cuda.stream_handle(dev),
                body=dualtone_body(nb, skip_chanfilt, want_afc, bf16, T))
    sums = torch.sum(parts, dim=-1)
    return (metric, iq_i[:, -HALO:].contiguous(), iq_q[:, -HALO:].contiguous(),
            sums[0] / torch.full((), float(n), dtype=torch.float32,
                                 device=dev), sums[1], sums[2])
