"""The reference of a ``pipeline`` configuration of a midpoint-DC dual-tone
family (``ims100``) on the kernel route: one family per channel, sampled
as ``PipelineReference`` samples it, each sampled row followed from the
first block of the stream by ``MeiseiStep``.

``MeiseiStep`` is ``RefStep`` with the front end's DC taken as the program
defines it for the families whose spec says ``dc_mode: midpoint``
(``sondetpu_torch/runtime/pipeline.py:midpoint_dc``): the midpoint
``0.5 * (q10 + q90)`` of each row of the dual-tone metric, where
``RefStep`` subtracts the metric's block mean. Each quantile is taken as
``jnp.quantile`` takes it, which is what the program copies:

- the position q * (n - 1) in float32 (q = 0.1 and 0.9 rounded to float32
  first) sets the order statistics at its floor and ceil, and the weight
  w of the upper one;
- the quantile is ``lo * (1 - w) + hi * w`` in float32, ``hi * w`` rounded
  on its own and the other product fused into the sum (one rounding of
  the exact ``lo * (1 - w) + fl(hi * w)``), then cast to the storage
  dtype;
- the midpoint is formed in the storage dtype, and a row holding a NaN
  gives NaN.

The order statistics come from a full sort (the program selects them with
``torch.kthvalue``), and the fused sum is rounded from its exact value in
rational arithmetic (the program emulates it in float64 with a rounding
to odd). The rest of the chain (K7's plain twin ``twins.fused_dualtone``
with its channel filter, the timing, the correlation divided by L, the
peak pick, the NRZ gather, the judge) is ``RefStep``'s, but for one
departure: the timing estimate's two row sums are taken over a zero
tensor of the program's row count with the sampled rows in it
(``MeiseiStep._row_sum``). On the card a reduction splits a row by the
tensor's shape; summed over the sampled rows alone, the estimate parted
from the program's in its last bits and the soft-chip RMS by an ulp (6.4e-8
to 1.3e-7 on 9 of 14 readings on an H100), as much as a q10 one rank off
moves it; laid out so, every sound number reads 0. The control is the
reference one precision below the configuration's.

Planted faults, for setting and testing the limits (``FAULTS``, in
``benchmark/control.py``'s form; ``control.py`` reads them once they are
added to its own)::

    python3 -c "import sys; from benchmark import control; \\
    from benchmark.reference import pipeline_meisei as m; \\
    control.FAULTS.update(m.FAULTS); sys.exit(control.main())" \\
        --workload ims100-2048.ongrid-meisei --seeds 1,2 --blocks 12 \\
        --side fault:mean_dc
"""

from __future__ import annotations

import contextlib
import functools
from fractions import Fraction

import numpy as np
import torch

import benchmark.frozen.sondes.ims100  # noqa: F401  (registers ims100)
from benchmark.reference import cells, twins
from benchmark.reference.cells import PipelineReference
from benchmark.reference.step import RefStep

QUANTILES = (np.float32(0.1), np.float32(0.9))


def _round_f32(exact: Fraction) -> np.float32:
    """The float32 nearest ``exact``, ties to an even significand."""
    g = np.float32(float(exact))
    best = None
    for cand in (np.nextafter(g, np.float32(-np.inf)), g,
                 np.nextafter(g, np.float32(np.inf))):
        d = abs(Fraction(float(cand)) - exact)
        even = int(np.array(cand, np.float32).view(np.int32)) & 1 == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, cand)
    return np.float32(best[1])


def fma_f32(a: np.ndarray, b: np.float32, c: np.ndarray) -> np.ndarray:
    """fl32(a * b + c), rounded once, element by element: float32 ``a``,
    ``c`` and a float32 ``b``."""
    out = np.empty(a.shape, np.float32)
    fb = Fraction(float(b))
    for i, (x, y) in enumerate(zip(a.tolist(), c.tolist())):
        if not (np.isfinite(x) and np.isfinite(y)):
            out[i] = np.float32(x * float(b) + y)
            continue
        exact = Fraction(x) * fb + Fraction(y)
        # an exact zero keeps IEEE's sign, which float64 gives exactly
        out[i] = (np.float32(x * float(b) + y) if exact == 0
                  else _round_f32(exact))
    return out


def midpoint(x: torch.Tensor, q10_offset: int = 0) -> torch.Tensor:
    """Per-row ``0.5 * (q10 + q90)`` of ``x`` [R, n] in x's dtype, as the
    module's docstring sets out. ``q10_offset`` moves both order
    statistics of q10 by that many ranks (a planted fault; 0 otherwise)."""
    n = x.shape[-1]
    srt = torch.sort(x.to(torch.float32), dim=-1).values
    qs = []
    for j, q in enumerate(QUANTILES):
        pos = np.float32(q * np.float32(n - 1))
        lo, hi = int(np.floor(pos)), int(np.ceil(pos))
        w = np.float32(pos - np.floor(pos))
        if j == 0 and q10_offset:
            lo = min(n - 1, lo + q10_offset)
            hi = min(n - 1, hi + q10_offset)
        a = srt[:, lo].cpu().numpy()
        hw = srt[:, hi].cpu().numpy() * w           # float32, rounded
        qv = fma_f32(a, np.float32(np.float32(1.0) - w), hw)
        qs.append(torch.from_numpy(qv).to(x.device).to(x.dtype))
    mid = (qs[0] + qs[1]) * 0.5
    return torch.where(torch.isnan(x).any(dim=-1),
                       torch.full_like(mid, float("nan")), mid)


class MeiseiStep(RefStep):
    """``RefStep`` with the dual-tone front end's midpoint DC, and the
    timing estimate's row sums taken over ``program_rows`` rows, as the
    program takes them."""

    def __init__(self, fam, rows, prec, device, tuning=None,
                 program_rows=None):
        super().__init__(fam, rows, prec, device, tuning)
        if (not fam.dualtone or fam.spec.extra.get("dc_mode") != "midpoint"
                or tuning is not None):
            raise NotImplementedError(
                f"{fam.sonde}: MeiseiStep models the midpoint-DC dual-tone "
                "front end on the channel centres alone")
        self.skip_chanfilt = fam.skip_chanfilt
        self.program_rows = max(rows, program_rows or rows)

    def dc(self, met: torch.Tensor) -> torch.Tensor:
        return midpoint(met)

    def _row_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``torch.sum(x, dim=-1)`` of x [R, m] with the rows laid in a zero
        tensor of the program's [C, m]: on the card a reduction splits
        each row by the tensor's shape, so the sampled rows sum in the
        order the program's step sums them over every channel."""
        r = x.shape[0]
        if self.program_rows == r:
            return torch.sum(x, dim=-1)
        full = x.new_zeros((self.program_rows, x.shape[1]))
        full[:r] = x
        return torch.sum(full, dim=-1)[:r]

    def _tau(self, filt: torch.Tensor) -> torch.Tensor:
        """``twins.oerder_meyr_tau`` with its two sums taken as the
        program's."""
        sq = filt.to(torch.float32) ** 2
        cr = self._row_sum(sq * self.cos_w)
        ci = -self._row_sum(sq * self.sin_w)
        two_pi = torch.tensor(np.float32(2.0 * np.pi), device=filt.device)
        tau = -torch.atan2(ci, cr) / two_pi * float(self.fam.sps)
        return torch.remainder(tau, float(self.fam.sps))

    def frontend(self, iq_i, iq_q, tail_i, tail_q):
        """``RefStep.frontend`` on the dual-tone route, the midpoint of the
        metric subtracted in place of its mean."""
        prec = self.prec
        qs = float(np.float32(1.0 / 32768.0))
        if iq_i.dtype == torch.int16:
            iq_i = iq_i.to(torch.float32) * qs
            iq_q = iq_q.to(torch.float32) * qs
        iq_i = prec.round(iq_i).contiguous()
        iq_q = prec.round(iq_q).contiguous()
        met, ti, tq, _ = twins.fused_dualtone(
            iq_i, iq_q, tail_i, tail_q, self.chan_taps, *self.mix, self.nb,
            self.skip_chanfilt)
        filt = prec.round(met - self.dc(met)[:, None])
        return filt, self._tau(filt), ti, tq


@contextlib.contextmanager
def _step_class(cls):
    """``CellReference.run`` builds its steps from ``cells.RefStep``."""
    orig = cells.RefStep
    cells.RefStep = cls
    try:
        yield
    finally:
        cells.RefStep = orig


class MeiseiReference(PipelineReference):
    """``PipelineReference``'s rows, followed by ``MeiseiStep``."""

    def run(self, *args, **kw):
        with _step_class(functools.partial(
                MeiseiStep, program_rows=self.groups[0].count)):
            return super().run(*args, **kw)


def _mean_dc(orig):
    """The block mean of the metric in the midpoint's place (the kernel
    route's DC for the other dual-tone families)."""
    def f(self, met):
        return torch.sum(met, dim=-1) / torch.full(
            (), float(met.shape[-1]), dtype=torch.float32, device=met.device)
    return f


def _q10_rank_off(orig):
    """The q10 order statistics one rank above where they belong."""
    return lambda self, met: midpoint(met, q10_offset=1)


def _chanfilt_skipped(orig):
    """K7 with its channel filter skipped."""
    def f(self, *args):
        self.skip_chanfilt = True
        return orig(self, *args)
    return f


FAULTS = {"mean_dc": (MeiseiStep, "dc", _mean_dc),
          "q10_rank_off": (MeiseiStep, "dc", _q10_rank_off),
          "chanfilt_skipped": (MeiseiStep, "frontend", _chanfilt_skipped)}


def build(config, traffic, ring, seed, device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return MeiseiReference(config, traffic, ring, seed, device)
