"""Fused front end: channel filter + decimation + FM discriminator + matched
FIR + block DC (counterpart: ``sondetpu/pallas/frontend.py:fused_frontend``
and ``fast_atan2``), and the r4 front end without the channel filter
(counterpart: ``fused_demod_fir`` in the same file).

:func:`fused_frontend` launches the CUDA kernel of ``csrc/frontend.cu``,
and :func:`fused_demod_fir` that of ``csrc/demod_fir.cu``, for CUDA
tensors; for CPU tensors they run :func:`fused_frontend_plain` and
:func:`fused_demod_fir_plain`. Kernel and twin take every product and sum
in the same order, each rounded on its own, so they agree bit for bit up to
the order of the DC sum. :func:`fused_frontend` reads float32 or bfloat16
planes and tails and computes in float32 (the original's Pallas kernel
casts bfloat16 input in VMEM): on bfloat16 input x it gives exactly what it
gives on x.float().
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from sondetpu_torch.dsp.fir import window_sum
from sondetpu_torch.kernels import cuda

HALO = 256   # raw input samples carried per plane (the JAX package's HALO:
             # the carried state has this width on both sides)
FIXED_TAPS = 41   # the tap count csrc/frontend.cu compiles in (T_FIXED)

# odd minimax polynomial for atan on [0, 1] (max err ~1e-6 rad)
_ATAN_C = (0.99997726, -0.33262347, 0.19354346, -0.11643287,
           0.05265332, -0.01172120)


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Octant reduction + degree-11 odd minimax polynomial, the same
    operations in the same order as the JAX package's ``fast_atan2``."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    den = torch.maximum(ax, ay)
    num = torch.minimum(ax, ay)
    z = num / torch.clamp_min(den, 1e-30)
    z2 = z * z
    c = _ATAN_C
    p = z * (c[0] + z2 * (c[1] + z2 * (c[2] + z2 * (c[3] + z2 * (c[4] + z2 * c[5])))))
    p = torch.where(ay > ax, (math.pi / 2) - p, p)
    p = torch.where(x < 0, math.pi - p, p)
    return torch.where(y < 0, -p, p)


def is_delay_taps(taps) -> bool:
    """True when ``taps`` is exactly ``[0, ..., 0, 1]`` in float32: then
    the FIR ``sum_u taps[u] * a[g - u]`` equals ``a[g - T + 1]`` exactly for
    finite ``a`` (each zero product adds nothing, and 1 * a is a), and the
    kernel skips the multiply-adds. A scaled, shifted or noisy delta is a
    FIR like any other."""
    h = np.asarray(taps, np.float32)
    return bool(h.ndim == 1 and h.size >= 1 and h[-1] == 1.0
                and not np.any(h[:-1]))


INPUT_DTYPES = (torch.float32, torch.bfloat16)   # K1's and K7's load types

# K1's walking bodies (41 taps, bfloat16): a block takes up to WALK_MAX
# consecutive tiles of its row, each overlapping the next one's staging,
# when the grid still fills WALK_WAVES waves of BLOCKS_PER_SM blocks an SM
WALK_MAX = 8
WALK_WAVES = 8
BLOCKS_PER_SM = 4     # csrc/frontend.cu's __launch_bounds__(256, 4)


def frontend_walk(channels: int, tiles: int, sms: int) -> int:
    """Tiles a block of K1's walking bodies takes at most, on ``channels``
    rows of ``tiles`` tiles on a card of ``sms`` SMs: the longest walk up
    to WALK_MAX that leaves WALK_WAVES waves of resident blocks, and 1 (a
    block a tile) on a grid too small for that. The kernel gives a row
    ceil(tiles / walk) blocks and splits its tiles evenly among them."""
    return max(1, min(WALK_MAX, channels * tiles
                      // (WALK_WAVES * BLOCKS_PER_SM * sms)))


# The inputs on which the card's tests and chip_smoke.py hold the walking
# bodies to the float32 body on the widened input: (rows, samples at decim
# 1, planes 2 bytes past a 16-byte boundary, tiles a block walks or None
# for frontend_walk's choice). 48005 is 5 mod 8, so 13 rows start at every
# even byte offset mod 16 (decim 2 doubles the samples: the aligned run
# gives offsets 0, 4, 8, 12 and the misaligned one the rest); a block
# shorter than a tile, and one tile and one sample (TILE = 2240 outputs);
# walks of 3 tiles on rows of 8 and of 8 on rows of 86.
WALK_EDGE_CASES = {
    "offsets-13x48005": (13, 48005, False, None),
    "misaligned": (13, 48005, True, None),
    "c1": (1, 48005, False, None),
    "short": (5, 1001, False, None),
    "tile-plus-one": (3, 2241, False, None),
    "walk3": (13, 8 * 2240 - 7, False, 3),
    "walk8-long-row": (4, 192005, True, 8),
}


def input_dtype(*planes) -> torch.dtype:
    """The one element type of a kernel's sample planes and tails: float32
    or bfloat16."""
    dt = planes[0].dtype
    if dt not in INPUT_DTYPES or any(p.dtype != dt for p in planes):
        raise TypeError("planes and tails must all be float32 or all "
                        "bfloat16, got " + ", ".join(str(p.dtype)
                                                     for p in planes))
    return dt


def _check_args(iq_i, iq_q, tail_i, tail_q, chan_taps, match_taps, decim):
    input_dtype(iq_i, iq_q, tail_i, tail_q)
    if decim not in (1, 2):
        raise ValueError(f"decim must be 1 or 2, got {decim}")
    c, n = iq_i.shape
    if n % decim:
        raise ValueError(f"block length {n} is not a multiple of decim {decim}")
    ntaps = len(chan_taps)
    if len(match_taps) != ntaps:
        raise ValueError("chan_taps and match_taps differ in length")
    if decim * ntaps + ntaps - 1 > HALO:
        raise ValueError(f"{ntaps} taps at decim {decim} need more than the "
                         f"{HALO}-sample carried tail")
    return c, n, ntaps


def frontend_body(decim: int, ntaps: int, identity: bool,
                  bf16: bool = False) -> str:
    """The kernel body that runs these arguments: decim 1 or 2, 41 taps
    compiled in or a run-time count, the identity matched taps or a FIR,
    float32 or bfloat16 input."""
    return (f"decim{decim}_" + ("t41" if ntaps == FIXED_TAPS else "runtime_t")
            + ("_identity" if identity else "") + ("_bf16" if bf16 else ""))


def fused_frontend_plain(iq_i, iq_q, tail_i, tail_q, chan_taps, match_taps,
                         scale: float, decim: int, dc_block: bool = True):
    """Plain torch twin of :func:`fused_frontend` (same arguments and
    results)."""
    c, n, T = _check_args(iq_i, iq_q, tail_i, tail_q, chan_taps, match_taps,
                          decim)
    nproc = n // decim
    # cf[g] for g in [-T, nproc): its first input is x[-(decim*T + T - 1)]
    s0 = HALO - (decim * T + T - 1)

    def chanfilt(tail, x):
        # widened first: float32 arithmetic and float32 taps on either
        # input type
        xcat = torch.cat([tail, x], dim=-1)[:, s0:].to(torch.float32)
        return window_sum(xcat, chan_taps, stride=decim)[:, :nproc + T]

    cf_i = chanfilt(tail_i, iq_i)
    cf_q = chanfilt(tail_q, iq_q)
    dre = cf_i[:, 1:] * cf_i[:, :-1] + cf_q[:, 1:] * cf_q[:, :-1]
    dim = cf_q[:, 1:] * cf_i[:, :-1] - cf_i[:, 1:] * cf_q[:, :-1]
    audio = fast_atan2(dim, dre) * torch.tensor(scale, dtype=torch.float32,
                                                device=iq_i.device)
    # audio[g] for g in [-(T-1), nproc)
    filt = window_sum(audio, match_taps)
    dc = torch.sum(audio[:, T - 1:], dim=-1) / torch.full(
        (), float(nproc), dtype=torch.float32, device=audio.device)
    if dc_block:
        filt = filt - dc[:, None]
    return (filt, iq_i[:, -HALO:].contiguous(), iq_q[:, -HALO:].contiguous(),
            dc)


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def fused_frontend(iq_i, iq_q, tail_i, tail_q, chan_taps, match_taps,
                   scale: float, decim: int, dc_block: bool = True):
    """Channel filter (``chan_taps``, stride ``decim``) -> FM discriminator
    (``fast_atan2`` x ``scale``) -> matched FIR (``match_taps``), with the
    block DC subtracted when ``dc_block`` is set.

    iq planes [C, n] and tails [C, HALO] (the raw input that precedes the
    block), all float32 or all bfloat16; taps: NumPy float32 arrays of
    equal odd length. Returns (filt [C, n/decim] float32, new tail_i, new
    tail_q [C, HALO] in the planes' dtype, dc [C] float32), dc being the
    block-mean discriminator audio.

    CPU tensors run the plain twin; CUDA tensors launch the kernel: the
    body for 41 taps or for any other count, and, when
    :func:`is_delay_taps` holds for ``match_taps``, the body that writes
    the delayed audio instead of the matched FIR (the same result); each
    for float32 or (``_bf16``) bfloat16 input.
    """
    dev = iq_i.device
    if dev.type == "cpu":
        return fused_frontend_plain(iq_i, iq_q, tail_i, tail_q, chan_taps,
                                    match_taps, scale, decim, dc_block)
    if dev.type != "cuda":
        raise ValueError(f"fused_frontend: unsupported device {dev}")
    c, n, T = _check_args(iq_i, iq_q, tail_i, tail_q, chan_taps, match_taps,
                          decim)
    dt = iq_i.dtype
    for name, t, shape in (("iq_i", iq_i, (c, n)), ("iq_q", iq_q, (c, n)),
                           ("tail_i", tail_i, (c, HALO)),
                           ("tail_q", tail_q, (c, HALO))):
        cuda.check_tensor(name, t, dt, dev, shape)
    if c > 65535:
        raise ValueError(f"fused_frontend: {c} channels exceed the grid's "
                         "65535 rows")
    bf16 = dt == torch.bfloat16
    hc = np.ascontiguousarray(chan_taps, np.float32)
    hm = np.ascontiguousarray(match_taps, np.float32)
    identity = is_delay_taps(hm)
    nproc = n // decim
    lib = cuda.library()
    ntiles = lib.sondetpu_frontend_tiles(n, decim)
    filt = torch.empty((c, nproc), dtype=torch.float32, device=dev)
    partial = torch.empty((c, ntiles), dtype=torch.float32, device=dev)
    body = frontend_body(decim, T, identity, bf16)
    walk = frontend_walk(c, ntiles, _sm_count(dev))
    cuda.launch("fused_frontend", "sondetpu_fused_frontend",
                iq_i.data_ptr(), iq_q.data_ptr(), tail_i.data_ptr(),
                tail_q.data_ptr(), hc.ctypes.data, hm.ctypes.data, T,
                float(np.float32(scale)), decim, int(identity), int(bf16), c,
                n, HALO, walk, filt.data_ptr(), partial.data_ptr(),
                cuda.stream_handle(dev), body=body)
    # a divisor on the device: CUDA multiplies by the reciprocal of a
    # Python number, which rounds otherwise than the twin on the CPU
    dc = torch.sum(partial, dim=-1) / torch.full(
        (), float(nproc), dtype=torch.float32, device=dev)
    if dc_block:
        filt = filt - dc[:, None]
    return (filt, iq_i[:, -HALO:].contiguous(), iq_q[:, -HALO:].contiguous(),
            dc)


# --- K9: the r4 front end without a channel filter --------------------------

def _check_demod_args(iq_i, taps):
    c, n = iq_i.shape
    ntaps = len(taps)
    if not 2 <= ntaps <= 64:
        raise ValueError(f"{ntaps} taps (2 to 64)")
    if n < ntaps - 1:
        raise ValueError(f"block of {n} samples is shorter than the "
                         f"{ntaps - 1}-sample audio tail")
    return c, n, ntaps


def fused_demod_fir_plain(iq_i, iq_q, prev, atail, taps, scale: float,
                          dc_block: bool = True):
    """Plain torch twin of :func:`fused_demod_fir` (same arguments and
    results)."""
    c, n, T = _check_demod_args(iq_i, taps)
    ip = torch.cat([prev[:, 0:1], iq_i[:, :-1]], dim=-1)
    qp = torch.cat([prev[:, 1:2], iq_q[:, :-1]], dim=-1)
    dre = iq_i * ip + iq_q * qp
    dim = iq_q * ip - iq_i * qp
    audio = fast_atan2(dim, dre) * torch.tensor(
        scale, dtype=torch.float32, device=iq_i.device)
    if dc_block:
        audio = audio - torch.mean(audio, dim=-1, keepdim=True)
    filt = window_sum(torch.cat([atail, audio], dim=-1), taps)
    return filt, audio[:, n - (T - 1):].contiguous()


def fused_demod_fir(iq_i, iq_q, prev, atail, taps, scale: float,
                    dc_block: bool = True):
    """FM discriminator (``fast_atan2`` x ``scale``, the previous sample
    from ``prev``) -> block-mean DC removal (when ``dc_block``) -> FIR
    (``taps``) over the audio after the carried tail ``atail``.

    iq planes [C, n] float32; prev [C, 2] float32, the (I, Q) sample before
    the block; atail [C, ntaps - 1] float32, the previous block's last
    DC-removed audio; taps: NumPy float32 array. Returns (filt [C, n], the
    next atail [C, ntaps - 1]).

    CPU tensors run the plain twin; CUDA tensors launch the kernel's two
    launches (two counts): the discriminator with per-block partial sums
    (body ``audio``), then the DC and the FIR, compiled for 41 taps
    (``t41``) or for any other count (``runtime_t``).
    """
    dev = iq_i.device
    if dev.type == "cpu":
        return fused_demod_fir_plain(iq_i, iq_q, prev, atail, taps, scale,
                                     dc_block)
    if dev.type != "cuda":
        raise ValueError(f"fused_demod_fir: unsupported device {dev}")
    c, n, T = _check_demod_args(iq_i, taps)
    for name, t, shape in (("iq_i", iq_i, (c, n)), ("iq_q", iq_q, (c, n)),
                           ("prev", prev, (c, 2)),
                           ("atail", atail, (c, T - 1))):
        cuda.check_tensor(name, t, torch.float32, dev, shape)
    if c > 65535:
        raise ValueError(f"fused_demod_fir: {c} channels exceed the grid's "
                         "65535 rows")
    h = np.ascontiguousarray(taps, np.float32)
    lib = cuda.library()
    audio = torch.empty((c, n), dtype=torch.float32, device=dev)
    partial = torch.empty((c, lib.sondetpu_demod_audio_parts(n)),
                          dtype=torch.float32, device=dev)
    filt = torch.empty((c, n), dtype=torch.float32, device=dev)
    tail = torch.empty((c, T - 1), dtype=torch.float32, device=dev)
    stream = cuda.stream_handle(dev)
    cuda.launch("fused_demod_fir", "sondetpu_demod_audio", iq_i.data_ptr(),
                iq_q.data_ptr(), prev.data_ptr(), float(np.float32(scale)), c,
                n, audio.data_ptr(), partial.data_ptr(), stream, body="audio")
    cuda.launch("fused_demod_fir", "sondetpu_demod_fir", audio.data_ptr(),
                atail.data_ptr(), partial.data_ptr(), h.ctypes.data, T,
                int(dc_block), c, n, filt.data_ptr(), tail.data_ptr(), stream,
                body="t41" if T == FIXED_TAPS else "runtime_t")
    return filt, tail
