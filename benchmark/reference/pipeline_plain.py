"""The reference of a ``pipeline`` configuration on the plain-op route
(``use_pallas`` false): one family per channel, sampled as
``PipelineReference`` samples it, each sampled row followed from the first
block of the stream by ``PlainStep``.

``PlainStep`` is ``RefStep`` with the front end, the carry and the
correlation of ``Pipeline._plain_frontend`` and ``Pipeline._correlate``
(``sondetpu_torch/runtime/pipeline.py``, the line numbers below) where the
kernel route differs:

- the carry: the last ``ntaps - 1`` samples of each plane in the storage
  precision (not ``HALO`` raw samples), the last channel-filtered sample
  of each plane (``fm_prev``) and the last ``ntaps - 1`` DC-removed audio
  samples (the matched FIR's tail);
- the discriminator: ``torch.atan2`` in float32 (not the kernel's
  polynomial), from the previous sample carried across the block edge;
- the DC: the mean of the block's own audio, a sum over a 0-d divisor;
- the correlation: divided by L for every family (the kernel route
  divides for the dual-tone families alone).

Its back half, the RS flag (``step.rs_flags``, the same GF(2) product as
the plain route's) and the judge are ``RefStep``'s. The filters are the
frozen ``apply_windows``, the program's order of products and sums.

Departures from the program's formula, each for a reason:

- the correlation sums in float64 and rounds once, then divides by L
  (``twins.correlate``): the program sums in float32 tap by tap, so a
  peak may differ in its last bits; the judge excuses a peak within
  ``judge.TIE`` of the threshold;
- the block DC and the timing sums run over the sampled rows alone, whose
  reduction may split otherwise on the card than the program's over
  every channel: a last-ulp difference of the DC, which ``soft_rms_gap``'s
  limit holds;
- the dual-tone and AFSK front ends, the midpoint DC and the DDC are not
  modelled (no cell runs them on this route): ``PlainStep`` refuses them.

Unlike ``CellReference.run``, :meth:`PlainReference.run` steps every block
in turn: the plain front end's output depends on the two blocks before it
(the DC of the block before reads ``fm_prev``), so ``BlockRing``'s reuse,
which assumes one, does not hold.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.frozen.dsp.fir import apply_windows
from benchmark.reference import twins
from benchmark.reference.cells import PipelineReference
from benchmark.reference.judge import Judge, merge
from benchmark.reference.step import RefStep


class PlainStep(RefStep):
    """One family's chain on the plain-op route on ``rows`` rows."""

    def __init__(self, fam, rows, prec, device, tuning=None):
        spec = fam.spec
        if (tuning is not None or fam.dualtone or spec.modulation == "afsk"
                or spec.extra.get("dc_mode") == "midpoint"):
            raise NotImplementedError(
                f"{fam.sonde}: the plain route's DDC, dual-tone, AFSK and "
                "midpoint-DC front ends are not modelled")
        super().__init__(fam, rows, prec, device)
        self.scale_t = torch.tensor(self.scale, dtype=torch.float32,
                                    device=self.dev)

    def reset(self):
        """The carry at the stream's start, zeros (:717-740)."""
        super().reset()
        r, h, sdt = self.rows, self.fam.ntaps - 1, self.prec.dtype
        self.tail_i = torch.zeros((r, h), dtype=sdt, device=self.dev)
        self.tail_q = torch.zeros((r, h), dtype=sdt, device=self.dev)
        self.fm_prev = torch.zeros((r, 2), dtype=sdt, device=self.dev)
        self.fir_tail = torch.zeros((r, h), dtype=sdt, device=self.dev)

    def frontend(self, iq_i, iq_q):
        """(filt in the storage precision [R, n/decim], tau [R]) of one
        block of int16 planes [R, block_len]; advances the carry."""
        fam, prec, f32 = self.fam, self.prec, torch.float32
        h = fam.ntaps - 1
        # ingest: the dequant, then the storage precision (:1046-1048, :1074)
        qs = float(np.float32(1.0 / 32768.0))
        iq_i = prec.round(iq_i.to(f32) * qs).contiguous()
        iq_q = prec.round(iq_q.to(f32) * qs).contiguous()
        # channel filter over [carried tail | block] at stride decim
        # (:904-920)
        ci = prec.round(apply_windows(torch.cat([self.tail_i, iq_i], dim=-1),
                                      self.chan_taps, stride=fam.decim))
        cq = prec.round(apply_windows(torch.cat([self.tail_q, iq_q], dim=-1),
                                      self.chan_taps, stride=fam.decim))
        self.tail_i = iq_i[:, -h:].contiguous()
        self.tail_q = iq_q[:, -h:].contiguous()
        # FM discriminator from the carried previous sample (:921-935)
        ip = torch.cat([self.fm_prev[:, 0:1], ci[:, :-1]], dim=-1).to(f32)
        qp = torch.cat([self.fm_prev[:, 1:2], cq[:, :-1]], dim=-1).to(f32)
        self.fm_prev = torch.stack([ci[:, -1], cq[:, -1]], dim=-1)
        ii, qq = ci.to(f32), cq.to(f32)
        audio = torch.atan2(qq * ip - ii * qp, ii * ip + qq * qp) \
            * self.scale_t
        # the block DC, a sum over a 0-d divisor, and its removal (:936-943)
        dc = torch.sum(audio, dim=-1) / torch.full(
            (), float(audio.shape[-1]), dtype=f32, device=audio.device)
        audio = audio - dc[:, None]
        # matched FIR over [carried audio tail | audio] (:951-955)
        xp = torch.cat([self.fir_tail, prec.round(audio)], dim=-1)
        self.fir_tail = xp[:, -h:].contiguous()
        filt = prec.round(apply_windows(xp, self.taps))
        # the timing estimate on the stored samples (:1145-1147)
        return filt, twins.oerder_meyr_tau(filt, fam.sps, self.cos_w,
                                           self.sin_w)

    def back(self, filt, tau):
        """``RefStep.back`` with every correlation divided by L, as the
        plain route's (:842, ``correlate_syncword``)."""
        with _dividing():
            return super().back(filt, tau)

    def step(self, iq_i, iq_q):
        return self.back(*self.frontend(iq_i, iq_q))


@contextlib.contextmanager
def _dividing():
    correlate = twins.correlate
    twins.correlate = lambda buf, t, divide: correlate(buf, t, True)
    try:
        yield
    finally:
        twins.correlate = correlate


class PlainReference(PipelineReference):
    """``PipelineReference``'s rows, followed by ``PlainStep``."""

    def run(self, n_blocks: int, program=None, full=None, lower=False,
            track=False):
        """``CellReference.run`` (the same arguments and results) with a
        ``PlainStep`` stepped through blocks 0 .. n_blocks - 1 in turn."""
        planes = self._planes(lower)
        steps, judges = [], []
        for g, (steady, _) in zip(self.groups, planes):
            prec = g.prec.lower() if lower else g.prec
            st = PlainStep(g.fam, len(g.local), prec, steady[0][0].device,
                           self._tuning(g))
            steps.append((st, steady))
            judges.append(Judge(g.fam, st, g.noise, track))
        rows = []
        for k in range(n_blocks):
            out = []
            for j, ((st, steady), judge) in enumerate(zip(steps, judges)):
                packed, internals = st.step(*steady[k % len(steady)])
                if program is None:
                    out.append((packed.cpu().numpy(),
                                internals["frames"].cpu().numpy()))
                else:
                    f = full.get(k) if full else None
                    judge.block(program[k][j], internals,
                                None if f is None else f[j])
            rows.append(out)
        if program is None:
            return rows
        out = merge([j.numbers() for j in judges],
                    [g.fam.sonde for g in self.groups])
        if track:
            # rows as the cell's channel ids
            for fam, w in out.get("where", {}).items():
                g = next(g for g in self.groups if g.fam.sonde == fam)
                for k, (v, r, b) in w.items():
                    w[k] = (v, int(g.rows[r]), b,
                            int(g.rows[r]) in getattr(self.ring, "truths", {}))
        return out


def build(config, traffic, ring, seed, device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return PlainReference(config, traffic, ring, seed, device)
