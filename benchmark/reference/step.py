"""The reference decode step of one sonde family, in plain torch.

``RefStep`` follows one family's per-block chain on a set of rows, as the
program's pipeline defines it on its kernel route: the int16 dequant, the
front end (the fused front end, or the dual-tone front end for the
dual-tone families), Oerder-Meyr timing with the slew-limited symbol clock,
symbol sampling (integer or rational samples per symbol), the chip ring,
syncword correlation and peak pick, the frame gather with the NRZ byte
pack or the Manchester / biphase-M decode, the Chase weak bits,
de-whitening, the RS syndrome flag and the packed row. Its sizes come from
the frozen protocol specs; it imports nothing of the program.

``step`` returns the packed rows the program would read back for these
rows, and the internals the judge needs: the soft chips of each slot, the
peak values, and the soft-chip RMS.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from benchmark.frozen.dsp.fir import design_lowpass
from benchmark.frozen.fec.syndrome import layout_matrix
from benchmark.frozen.sondes import get_sonde
from benchmark.reference import twins
from benchmark.reference.twins import HALO, Precision


class Family:
    """The sizes one family's chain takes at a sample rate and block
    length (the program's ``PipelineConfig`` rules)."""

    def __init__(self, sonde: str, fs: float, block_len: int, ntaps: int = 41,
                 sync_threshold: float = 0.6):
        spec = get_sonde(sonde)["spec"]
        self.sonde, self.spec = sonde, spec
        self.fs, self.block_len, self.ntaps = float(fs), int(block_len), ntaps
        self.sync_threshold = float(sync_threshold)
        self.decim = 2 if (spec.modulation != "afsk"
                           and fs / 2.0 >= 2.2 * spec.bandwidth
                           and (fs / 2.0) / spec.baud >= 4.0
                           and block_len % 2 == 0) else 1
        self.fs_proc = self.fs / self.decim
        self.sps = self.fs_proc / spec.baud
        self.cpb = int(round(block_len / self.decim / self.sps))
        self.frame_chips = spec.chips_per_frame
        self.min_frame_chips = int(spec.extra.get("min_frame_chips",
                                                  self.frame_chips))
        self.k_slots = int(np.ceil(self.cpb / self.min_frame_chips)) + 1
        self.buf_len = self.frame_chips + self.cpb
        cols = spec.extra.get("wire_columns")
        self.wire_columns = None if cols is None else np.asarray(cols, np.int64)
        self.wire_ncols = spec.frame_bytes if cols is None else len(cols)
        self.chase_m = int(spec.extra.get("chase_m", 0))
        spans = spec.extra.get("chase_spans")
        if not self.chase_m:
            self.chase_spans = ()
        elif spans is None:
            self.chase_spans = ((0, spec.frame_bytes * 8),)
        else:
            self.chase_spans = tuple(tuple(s) for s in spans)
        self.chase_total = self.chase_m * len(self.chase_spans)
        self.row_bytes = (self.k_slots * self.wire_ncols + 2 * self.k_slots
                          + 4 + 2 * self.k_slots * self.chase_total)
        n_proc = block_len // self.decim
        turns = spec.dev * n_proc / self.fs_proc
        self.dualtone = (spec.modulation in ("gfsk", "fsk")
                         and bool(spec.extra.get("fsk_dualtone"))
                         and abs(turns - round(turns)) < 1e-6
                         and 2 <= round(self.sps) <= ntaps)
        self.skip_chanfilt = (self.dualtone and spec.bandwidth / 2.0
                              >= 0.45 * self.fs_proc)
        fr = Fraction(self.sps).limit_denominator(16)
        p, q = fr.numerator, fr.denominator
        self.rational = ((p, q) if (abs(float(fr) - self.sps) < 1e-9 and q > 1
                                    and self.cpb % q == 0
                                    and n_proc == (self.cpb // q) * p)
                         else None)


def unpack_rows(packed: np.ndarray, fam: Family):
    """Split packed rows [R, row_bytes] uint8 into (frames [R, K, ncols],
    valid [R, K], rs_clean [R, K], soft_rms [R] float32, weak [R, K, M]
    or None): the program's wire layout."""
    k, nc = fam.k_slots, fam.wire_ncols
    r = packed.shape[0]
    fbk = k * nc
    frames = packed[:, :fbk].reshape(r, k, nc)
    valid = packed[:, fbk:fbk + k].astype(bool)
    rs_clean = packed[:, fbk + k:fbk + 2 * k].astype(bool)
    off = fbk + 2 * k
    rms = np.ascontiguousarray(packed[:, off:off + 4]).view(np.float32)[:, 0].copy()
    weak = None
    if fam.chase_total:
        weak = np.ascontiguousarray(packed[:, off + 4:]).view(np.uint16) \
            .reshape(r, k, fam.chase_total).astype(np.int64)
    return frames, valid, rs_clean, rms, weak


class RefStep:
    """One family's chain on ``rows`` rows, stored in ``prec``; call
    ``frontend`` then ``back`` per block (``step`` does both)."""

    def __init__(self, fam: Family, rows: int, prec: Precision, device,
                 tuning=None, afc_beta: float = 0.5):
        """``tuning``: the rows' carrier offsets (Hz, ``fine_offsets``) and
        ``afc``: the per-channel DDC between the dequant and the front end,
        and the first-order AFC loop that moves its frequency each block by
        the front end's block DC."""
        self.fam, self.rows, self.prec = fam, rows, prec
        self.dev = torch.device(device)
        spec, dev = fam.spec, self.dev
        self.ddc = tuning is not None
        if self.ddc:
            self.afc = bool(tuning.get("afc"))
            self.f_seed = torch.from_numpy(np.asarray(
                tuning["fine_offsets"], np.float32)).to(dev)
            self.fs_t = torch.full((), fam.fs, dtype=torch.float32, device=dev)
            self.afc_beta = float(np.float32(afc_beta))
            self.afc_max = float(np.float32(spec.bandwidth / 2.0))
            if self.afc and fam.dualtone:
                raise NotImplementedError("the dual-tone AFC loop reads the "
                                          "envelope rotation, not modelled")
        self.taps = design_lowpass(0.55 * spec.baud, fam.fs_proc, fam.ntaps)
        self.chan_taps = design_lowpass(
            min(spec.bandwidth / 2.0, 0.45 * fam.fs_proc), fam.fs, fam.ntaps)
        templates = [spec.sync_chip_template()]
        alt = spec.extra.get("alt_syncword")
        if alt:
            templates.append(spec.sync_chip_template(alt))
        for b in spec.extra.get("alt_sync_bits", ()):
            templates.append(spec.sync_chip_template(bits=np.asarray(b)))
        self.templates = [np.asarray(t, np.float32) for t in templates]
        self.scale = float(np.float32(fam.fs_proc / (2.0 * np.pi * spec.dev)))
        n = fam.block_len // fam.decim
        cw, sw = twins.spectral_line_tables(n, fam.sps)
        self.cos_w = torch.from_numpy(cw).to(dev)
        self.sin_w = torch.from_numpy(sw).to(dev)
        if fam.dualtone:
            c, s = twins.mixer_tables(n, spec.dev / fam.fs_proc)
            self.mix = (torch.from_numpy(c).to(dev), torch.from_numpy(s).to(dev))
            self.nb = max(2, int(round(fam.sps)))
        mask = spec.extra.get("whitening")
        self.whiten = None if mask is None else torch.from_numpy(np.resize(
            np.asarray(mask, np.uint8), spec.frame_bytes)).to(dev)
        self.rs = spec.extra.get("rs")
        if self.rs is not None:
            self.rs_w = torch.from_numpy(layout_matrix(spec.frame_bytes,
                                                       self.rs)).to(dev)
        self.bit_shift = torch.arange(8, device=dev, dtype=torch.int32)
        if not spec.lsb_first:
            self.bit_shift = 7 - self.bit_shift
        self.reset()

    def reset(self):
        fam, dev, r = self.fam, self.dev, self.rows
        sdt = self.prec.dtype
        self.tail_i = torch.zeros((r, HALO), dtype=sdt, device=dev)
        self.tail_q = torch.zeros((r, HALO), dtype=sdt, device=dev)
        self.pos = torch.zeros(r, device=dev)
        self.locked = torch.zeros(r, device=dev)
        self.chipbuf = torch.zeros((r, fam.buf_len), dtype=sdt, device=dev)
        self.buf_fill = torch.zeros(r, dtype=torch.int32, device=dev)
        if self.ddc:
            self.phase = torch.zeros(r, device=dev)
            self.freq = self.f_seed.clone()

    def _downconvert(self, iq_i, iq_q):
        """Rotate each row by -2 pi freq t from its carried phase (cycles),
        in float32: f_norm = freq / fs on the device, the angle
        fl32(-2 pi) * (phase + f_norm * k) with the product and the sum
        rounded apart, accurate cos and sin; the phase carried mod 1."""
        n = iq_i.shape[-1]
        f_norm = self.freq / self.fs_t
        ang = f_norm[:, None] * torch.arange(n, dtype=torch.float32,
                                             device=iq_i.device)
        ang.add_(self.phase[:, None]).mul_(-2.0 * np.pi)
        cosv = torch.cos(ang)
        sinv = ang.sin_()
        out_i = (iq_i * cosv).sub_(iq_q * sinv)
        out_q = (iq_i * sinv).add_(iq_q * cosv)
        self.phase = torch.remainder(self.phase + f_norm * float(n), 1.0)
        return out_i, out_q

    def _afc_update(self, dc):
        dev = float(np.float32(self.fam.spec.dev))
        self.freq = self.f_seed + torch.clamp(
            self.freq + self.afc_beta * dc * dev - self.f_seed,
            -self.afc_max, self.afc_max)

    # -- the front end: a function of the block and the carried tails ------

    def frontend(self, iq_i, iq_q, tail_i, tail_q):
        """(filt in the storage precision [R, n/decim], tau [R], new tails)
        of one block of planes [R, block_len] (int16, float32 or
        bfloat16)."""
        fam, prec = self.fam, self.prec
        if iq_i.dtype in (torch.int16, torch.int8):
            qs = float(np.float32(1.0 / 32768.0 if iq_i.dtype == torch.int16
                                  else 1.0 / 128.0))
            iq_i = iq_i.to(torch.float32) * qs
            iq_q = iq_q.to(torch.float32) * qs
        if self.ddc:
            iq_i, iq_q = self._downconvert(iq_i.to(torch.float32),
                                           iq_q.to(torch.float32))
        iq_i = prec.round(iq_i).contiguous()
        iq_q = prec.round(iq_q).contiguous()
        if fam.dualtone:
            filt, ti, tq, dc = twins.fused_dualtone(
                iq_i, iq_q, tail_i, tail_q, self.chan_taps, *self.mix,
                self.nb, fam.skip_chanfilt)
            filt = filt - dc[:, None]
        else:
            filt, ti, tq, dc = twins.fused_frontend(
                iq_i, iq_q, tail_i, tail_q, self.chan_taps, self.taps,
                self.scale, fam.decim, True)
        if self.ddc and self.afc:
            self._afc_update(dc)
        filt = prec.round(filt)
        tau = twins.oerder_meyr_tau(filt, fam.sps, self.cos_w, self.sin_w)
        return filt, tau, ti, tq

    # -- the rest of the step: timing, ring, sync, frames, packing ---------

    def _sample(self, filt, start):
        fam = self.fam
        sps, cpb = fam.sps, fam.cpb
        dev = filt.device
        if float(sps).is_integer():
            isps = int(sps)
            s0 = torch.floor(start).to(torch.int64)
            frac = (start - s0.to(torch.float32))[:, None]
            fp = torch.cat([filt, filt[:, -1:].expand(-1, isps + 1)], dim=-1)
            idx = s0[:, None] + isps * torch.arange(cpb, device=dev)
            a = torch.gather(fp, 1, idx)
            b = torch.gather(fp, 1, idx + 1)
            return (1.0 - frac) * a + frac * b
        if fam.rational is None:
            raise NotImplementedError(f"{sps} samples a symbol: neither "
                                      "whole nor a ratio the block splits by")
        p, q = fam.rational
        c = filt.shape[0]
        g = filt.shape[-1] // p
        j = torch.arange(q, dtype=torch.float32, device=dev)
        pos = start[:, None] + j[None, :] * torch.tensor(np.float32(sps),
                                                         device=dev)
        i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, p - 1)
        frac = torch.clamp(pos - i0.to(torch.float32), 0.0, 1.0)
        nxt = torch.cat([filt[:, p::p], filt[:, -1:]], dim=-1)[:, :g]
        ext = torch.cat([filt.reshape(c, g, p), nxt[:, :, None]], dim=-1)
        idx = i0[:, None, :].expand(c, g, q)
        a = torch.gather(ext, 2, idx)
        b = torch.gather(ext, 2, idx + 1)
        soft = (1.0 - frac)[:, None, :] * a + frac[:, None, :] * b
        return soft.reshape(c, cpb)

    def back(self, filt, tau):
        """Advance the clock and the ring by one block whose front end gave
        ``filt`` and ``tau``. Returns (packed rows [R, row_bytes] uint8,
        internals dict)."""
        fam, prec, spec = self.fam, self.prec, self.fam.spec
        sps, cpb, n = fam.sps, fam.cpb, filt.shape[-1]
        pos = self.pos
        err = torch.remainder(tau - pos + sps / 2.0, sps) - sps / 2.0
        corrected = pos + torch.clamp(err, -0.5, 0.5)
        start = torch.where(self.locked > 0, corrected, tau)
        start = torch.clamp(start, 0.0, sps - 1e-3)
        self.pos = start + cpb * sps - n
        self.locked = torch.ones_like(self.locked)
        soft = self._sample(filt, start)
        chipbuf = torch.cat([self.chipbuf, prec.round(soft)],
                            dim=-1)[:, cpb:].contiguous()
        self.chipbuf = chipbuf
        self.buf_fill = torch.clamp_max(self.buf_fill + cpb, fam.buf_len)
        # the plain correlation divides by L; the correlator kernel (the
        # fused route's) scales by float32(1/L)
        divide = fam.dualtone
        corr = None
        for t in self.templates:
            c2 = twins.correlate(chipbuf, t, divide)
            if spec.extra.get("abs_corr"):
                c2 = c2.abs()
            if corr is None:
                corr = c2
            else:
                m = min(corr.shape[-1], c2.shape[-1])
                corr = torch.maximum(corr[:, :m], c2[:, :m])
        min_dist = max(fam.min_frame_chips // 4, self.templates[0].shape[0])
        starts, ok, peak = twins.find_frame_starts(
            corr, fam.sync_threshold, fam.k_slots, min_dist)
        is_new = (starts + fam.frame_chips) > (fam.buf_len - cpb)
        in_hist = starts >= (fam.buf_len - self.buf_fill)[:, None]
        fit = (starts + fam.frame_chips) <= fam.buf_len
        valid = ok & fit & is_new & in_hist
        soft_fr = twins.gather_frames(chipbuf, starts, fam.frame_chips)
        hard = (soft_fr > 0).to(torch.int32)
        rr, kk, fb = hard.shape[0], hard.shape[1], spec.frame_bytes
        weak = None
        if spec.line_code == "nrz":
            bits = hard.reshape(rr, kk, fb, 8)
        else:
            a, b = hard[..., 0::2], hard[..., 1::2]
            bits = (a & (1 - b)) if spec.line_code == "manchester" else (a ^ b)
            bits = bits.reshape(rr, kk, fb, 8)
            if fam.chase_m:
                rel = torch.minimum(soft_fr[..., 0::2].abs(),
                                    soft_fr[..., 1::2].abs())
                weak = torch.cat([
                    torch.sort(rel[..., a0:b0], dim=-1, stable=True
                               ).indices[..., :fam.chase_m] + a0
                    for a0, b0 in fam.chase_spans], dim=-1)
        frames = torch.sum(bits << self.bit_shift, dim=-1).to(torch.uint8)
        if self.whiten is not None:
            frames = torch.bitwise_xor(frames, self.whiten)
        soft_rms = torch.sqrt(torch.mean(soft * soft, dim=-1))
        if self.rs is not None:
            rs_clean = rs_flags(frames, self.rs_w) & valid
        else:
            rs_clean = torch.zeros_like(valid)
        wire = frames if fam.wire_columns is None else frames[
            ..., torch.from_numpy(fam.wire_columns).to(frames.device)]
        parts = [wire.reshape(rr, -1), valid.to(torch.uint8),
                 rs_clean.to(torch.uint8),
                 soft_rms.to(torch.float32).contiguous().view(
                     torch.uint8).reshape(rr, 4)]
        if fam.chase_m:
            parts.append(weak.to(torch.int16).contiguous().view(
                torch.uint8).reshape(rr, -1))
        packed = torch.cat(parts, dim=-1)
        return packed, {"valid": valid, "peak": peak, "soft_fr": soft_fr,
                        "soft_rms": soft_rms, "frames": frames}

    def step(self, iq_i, iq_q):
        filt, tau, self.tail_i, self.tail_q = self.frontend(
            iq_i, iq_q, self.tail_i, self.tail_q)
        return self.back(filt, tau)


def rs_flags(frames, w):
    """frames [..., fb] uint8 -> True where every RS syndrome is zero: the
    bits of the frame times the GF(2) syndrome matrix, mod 2."""
    shifts = torch.arange(8, dtype=torch.int32, device=frames.device)
    bits = ((frames.to(torch.int32)[..., None] >> shifts) & 1).to(
        torch.float64)
    bits = bits.reshape(bits.shape[:-2] + (8 * frames.shape[-1],))
    snd = bits @ w.to(torch.float64)
    return (snd.to(torch.int64) & 1).sum(dim=-1) == 0


class BlockRing:
    """Drives a ``RefStep`` over a stream that cycles through a ring of
    blocks. The front end of block k depends only on block k and the tail
    of block k - 1, so it is computed once for the first block (``first``,
    with zero tails) and once per ring position (``steady[p]``, the tails
    from ``steady[p - 1]``), and reused."""

    def __init__(self, step: RefStep, steady, first=None):
        """steady, first: (i, q) [R, block_len] planes."""
        self.step, self.steady = step, steady
        self.first = steady[0] if first is None else first
        self.cache = {}

    def block(self, k: int):
        ring = len(self.steady)
        if self.step.ddc:
            # the DDC carries its phase and frequency: no reuse
            i, q = self.first if k == 0 else self.steady[k % ring]
            return self.step.step(i, q)
        key = "first" if k == 0 else k % ring
        if key not in self.cache:
            st = self.step
            if k == 0:
                ti = torch.zeros_like(st.tail_i)
                tq = torch.zeros_like(st.tail_q)
                i, q = self.first
            else:
                pi, pq = self.steady[(k - 1) % ring]
                ti = st.prec.round(_dequant(pi[:, -HALO:])).contiguous()
                tq = st.prec.round(_dequant(pq[:, -HALO:])).contiguous()
                i, q = self.steady[k % ring]
            filt, tau, _, _ = st.frontend(i, q, ti, tq)
            self.cache[key] = (filt, tau)
        return self.step.back(*self.cache[key])


def _dequant(x):
    if x.dtype == torch.int16:
        return x.to(torch.float32) * float(np.float32(1.0 / 32768.0))
    return x
