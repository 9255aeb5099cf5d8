"""Plain torch stages of the decode chain, frozen for the reference.

Each function is the plain form of one stage of ``sondetpu_torch`` as it
stood when the benchmark was written, copied here so that no later change
to the program moves the yardstick: the fused front end (channel filter,
decimation, FM discriminator, matched FIR, block DC), the dual-tone
front end, the PFB's branch FIR and DFT, the Oerder-Meyr timing estimate,
the syncword correlation, the peak pick and the frame gather. Every
product and sum is taken in float32 in a fixed order. Nothing here imports
the program.

A storage precision is named by ``Precision``: float32, bfloat16, or
float8 (e4m3, scaled per tensor by a power of two that puts its largest
magnitude just under e4m3's largest value, as float8 is used) kept in
bfloat16 storage, which is exact since every scaled e4m3 value is a
bfloat16 value. The benchmark's control computes the reference one
precision below the configuration's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.frozen.dsp.fir import apply_windows

HALO = 256   # raw input samples the kernel route carries per plane

# odd minimax polynomial for atan on [0, 1]
_ATAN_C = (0.99997726, -0.33262347, 0.19354346, -0.11643287,
           0.05265332, -0.01172120)


class Precision:
    """A storage precision: ``round`` maps a tensor onto its values and
    returns it in ``dtype``."""

    def __init__(self, name: str):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"precision {name!r}")
        self.name = name
        self.dtype = torch.float32 if name == "f32" else torch.bfloat16

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            x = x.to(torch.float32)
            amax = torch.clamp_min(x.abs().amax(), 1e-30)
            scale = torch.exp2(torch.floor(torch.log2(448.0 / amax)))
            return ((x * scale).to(torch.float8_e4m3fn).to(torch.float32)
                    / scale).to(torch.bfloat16)
        return x.to(self.dtype)

    def lower(self) -> "Precision":
        """The next precision below: bfloat16 below float32, float8 below
        bfloat16."""
        return Precision({"f32": "bf16", "bf16": "fp8"}[self.name])


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Octant reduction and a degree-11 odd minimax polynomial."""
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


def fused_frontend(iq_i, iq_q, tail_i, tail_q, chan_taps, match_taps,
                   scale: float, decim: int, dc_block: bool = True):
    """Channel filter (stride ``decim``) over [HALO tail | block], FM
    discriminator, matched FIR and block DC. Returns (filt [C, n/decim]
    float32 with the DC subtracted, new tails, dc [C])."""
    n = iq_i.shape[-1]
    T = len(chan_taps)
    nproc = n // decim
    s0 = HALO - (decim * T + T - 1)

    def chanfilt(tail, x):
        xcat = torch.cat([tail, x], dim=-1)[:, s0:].to(torch.float32)
        return apply_windows(xcat, chan_taps, stride=decim)[:, :nproc + T]

    cf_i = chanfilt(tail_i, iq_i)
    cf_q = chanfilt(tail_q, iq_q)
    dre = cf_i[:, 1:] * cf_i[:, :-1] + cf_q[:, 1:] * cf_q[:, :-1]
    dim = cf_q[:, 1:] * cf_i[:, :-1] - cf_i[:, 1:] * cf_q[:, :-1]
    del cf_i, cf_q
    audio = fast_atan2(dim, dre) * torch.tensor(scale, dtype=torch.float32,
                                                device=iq_i.device)
    filt = apply_windows(audio, match_taps)
    dc = torch.sum(audio[:, T - 1:], dim=-1) / torch.full(
        (), float(nproc), dtype=torch.float32, device=audio.device)
    if dc_block:
        filt = filt - dc[:, None]
    return (filt, iq_i[:, -HALO:].contiguous(), iq_q[:, -HALO:].contiguous(),
            dc)


def mixer_tables(n: int, dev_over_fs: float):
    """cos, sin(2*pi*frac) [n] float32 for frac = (p * dev/fs) mod 1,
    taken in float64 and rounded once: the +/-dev mixer."""
    frac = np.mod(np.arange(n, dtype=np.float64) * float(dev_over_fs), 1.0)
    return (np.cos(2.0 * np.pi * frac).astype(np.float32),
            np.sin(2.0 * np.pi * frac).astype(np.float32))


def fused_dualtone(iq_i, iq_q, tail_i, tail_q, chan_taps, tab_cos, tab_sin,
                   nb: int, skip_chanfilt: bool):
    """Optional channel filter, +/-dev mix, nb-tap boxcar and the envelope
    metric (P+ - P-) / (P+ + P- + 1e-12). Returns (metric [C, n], new
    tails, dc [C])."""
    c, n = iq_i.shape
    T = len(chan_taps)
    dev = iq_i.device

    def chanfilt(tail, x):
        xw = torch.cat([tail, x], dim=-1).to(torch.float32)
        if skip_chanfilt:
            return xw[:, HALO - nb:]
        return apply_windows(xw[:, HALO - nb - (T - 1):], chan_taps)

    cf_i = chanfilt(tail_i, iq_i)
    cf_q = chanfilt(tail_q, iq_q)
    pos = torch.arange(-nb, n, device=dev) % n
    cv = tab_cos[pos]
    sv = tab_sin[pos]
    planes = (cf_i * cv + cf_q * sv, cf_q * cv - cf_i * sv,
              cf_i * cv - cf_q * sv, cf_q * cv + cf_i * sv)
    inv_nb = torch.tensor(np.float32(1.0 / nb), device=dev)

    def box(p):
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
    return (met, iq_i[:, -HALO:].contiguous(), iq_q[:, -HALO:].contiguous(),
            dc)


def pfb_fir(vv_i, vv_q, hcol, prec: Precision):
    """The PFB's time-major branch FIR over [tpp + m, N] planes:
    ``u[r, j] = sum_t hcol[t, j] * vvs[r + tpp - 1 - t, j]`` (column 0
    moved up one row), input, taps, every product and every running sum
    rounded to ``prec``."""
    tpp = hcol.shape[0]
    m = vv_i.shape[0] - tpp
    rows = m + tpp - 1
    h = prec.round(hcol)

    def fir(vv):
        vv = prec.round(vv)
        vvs = torch.cat([vv[1:rows + 1, :1], vv[:rows, 1:]], dim=1)
        acc = None
        for t in range(tpp):
            o = tpp - 1 - t
            s = prec.round(vvs[o:o + m, :] * h[t][None, :])
            acc = s if acc is None else prec.round(acc + s)
        return acc

    return fir(vv_i), fir(vv_q)


def pfb_dft(u_i, u_q, prec: Precision, bins=None):
    """DFT across the N branches of every row, sign -1, in float32,
    rounded to ``prec`` once: y [N, m] (or the rows ``bins`` of it)."""
    y = torch.fft.fft(torch.complex(u_i.to(torch.float32),
                                    u_q.to(torch.float32)), dim=-1)
    if bins is not None:
        y = y[:, bins]
    return (prec.round(y.real.t().contiguous()),
            prec.round(y.imag.t().contiguous()))


def spectral_line_tables(n: int, sps: float):
    """cos(w), sin(w) [n] float32 for w = 2*pi*idx/sps formed in float32,
    the trig taken in float64 of that angle and rounded once."""
    idx = np.arange(n, dtype=np.float32)
    w = np.float32(2.0 * np.pi) * idx / np.float32(sps)
    w64 = w.astype(np.float64)
    return np.cos(w64).astype(np.float32), np.sin(w64).astype(np.float32)


def oerder_meyr_tau(x, sps: float, cos_w, sin_w):
    """Feed-forward timing estimate per row, in [0, sps)."""
    sq = x.to(torch.float32) ** 2
    cr = torch.sum(sq * cos_w, dim=-1)
    ci = -torch.sum(sq * sin_w, dim=-1)
    two_pi = torch.tensor(np.float32(2.0 * math.pi), device=x.device)
    tau = -torch.atan2(ci, cr) / two_pi * float(sps)
    return torch.remainder(tau, float(sps))


def correlate(chipbuf, template: np.ndarray, divide: bool):
    """``sum_k t[k] * buf[c, i + k]`` over L, summed in float64 and rounded
    to float32 once, then divided by L (``divide``) or scaled by
    float32(1/L): what the plain correlation and the correlator kernel
    compute, up to the order of the float32 sums."""
    dev = chipbuf.device
    t = torch.as_tensor(np.asarray(template, np.float64), device=dev)
    L = t.shape[0]
    s = torch.nn.functional.conv1d(chipbuf.to(torch.float64)[:, None, :],
                                   t[None, None, :])[:, 0].to(torch.float32)
    if divide:
        return s / torch.full((), float(L), dtype=torch.float32, device=dev)
    return s * torch.tensor(np.float32(1.0 / L), device=dev)


def _max_first(x):
    v = torch.amax(x, dim=-1)
    idx = torch.arange(x.shape[-1], device=x.device)
    first = torch.where(x == v[..., None], idx, x.shape[-1]).amin(dim=-1)
    return v, first


def find_frame_starts(corr, threshold: float, max_peaks: int,
                      min_distance: int):
    """Up to ``max_peaks`` peaks per row: the top two of each half-window
    block as candidates, then an iterative first-index argmax with
    +/-``min_distance`` suppression; sorted by position, valid first.
    Returns (starts [C, K] int32, ok [C, K], value [C, K] of each peak)."""
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
    cand_v = torch.cat([v1, v2], dim=-1)
    cand_p = torch.cat([a1 + base, a2 + base], dim=-1)
    idxs, oks, vals = [], [], []
    work = cand_v
    for _ in range(max_peaks):
        v, j = _max_first(work)
        p = torch.gather(cand_p, -1, j[:, None])[:, 0]
        idxs.append(p)
        oks.append(v >= threshold)
        vals.append(v)
        work = torch.where((cand_p - p[:, None]).abs() <= min_distance,
                           torch.full_like(work, -float("inf")), work)
    starts = torch.stack(idxs, dim=-1).to(torch.int32)
    ok = torch.stack(oks, dim=-1)
    val = torch.stack(vals, dim=-1)
    key = torch.where(ok, starts, torch.full_like(starts, n + 1))
    order = torch.argsort(key, dim=-1, stable=True)
    return (torch.gather(starts, -1, order), torch.gather(ok, -1, order),
            torch.gather(val, -1, order))


def gather_frames(stream, starts, frame_len: int):
    """One contiguous slice [C, K, frame_len] per (row, slot) from the
    start clamped to [0, n - frame_len]."""
    c, n = stream.shape
    safe = torch.clamp(starts, 0, n - frame_len).to(torch.int64)
    rows = torch.arange(c, device=stream.device)[:, None]
    return stream.unfold(1, frame_len, 1)[rows, safe]
