"""Judging the program's packed rows against the reference.

For each block and each sampled row the judge reads the program's packed
row (its wire layout, ``step.unpack_rows``) and compares it with the
reference's internals for the same row and block:

- ``soft_rms_gap``: |program - reference| / reference of the soft-chip
  RMS, the largest over rows and blocks; ``soft_rms_gap_first`` the same
  on the stream's first block alone, before any loop that carries state
  from the program's own sums (the AFC) has moved;
- ``valid_mismatch``: rows whose valid flags differ from the reference's,
  unless the reference has a peak within ``TIE`` of the threshold (a tie
  that a last-ulp difference may decide either way);
- ``chip_gap``: for every bit of every wire byte of a slot valid on both
  sides, how far the reference's soft chips lie on the wrong side of the
  decision for the program's bit (0 where they agree), over the row's
  reference RMS; the largest;
- ``weak_gap`` (families with Chase weak bits): how far above the
  reference's M-th smallest reliability of its span the reliability of a
  bit the program ranked among the M weakest lies, over the row's RMS; an
  index outside its span or repeated reads ``OUT_OF_SPAN``;
- ``rs_flag_mismatch`` (blocks whose full frames were kept, every row):
  slots whose RS-clean flag differs from the RS syndrome of the program's
  own frame.

Rows that carry no sonde (a fleet's noise bins) are judged apart, on
their soft-chip RMS alone: ``noise_soft_rms_gap``. Their decisions are
not compared. On such a row the symbol clock has no spectral line to lock
to, and the false syncs have near-equal peaks that compete, so a last-ulp
difference moves a clock across its wrap or picks another peak, and the
flags and chips part from there on.

Every number is the largest over the run, so a single bad answer shows.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.step import Family, RefStep, rs_flags, unpack_rows

GAPS = ("soft_rms_gap", "soft_rms_gap_first", "chip_gap", "weak_gap")
OUT_OF_SPAN = 1e9     # a weak-bit index the frame's span cannot hold
COUNTS = ("valid_mismatch", "rs_flag_mismatch")
TIE = 1e-3            # a peak this close to the sync threshold is a tie


class Judge:
    """Accumulates the comparison of one family's rows over blocks."""

    def __init__(self, fam: Family, ref: RefStep, noise=None,
                 track: bool = False):
        """``noise``: bool [R], the sampled rows that carry no sonde (None:
        every row carries one)."""
        self.fam, self.ref = fam, ref
        self.track = track       # where each maximum lies (reads the card)
        dev = ref.dev
        self.dev = dev
        rows = ref.rows
        self.noise = torch.zeros(rows, dtype=torch.bool, device=dev) \
            if noise is None else torch.as_tensor(
                np.asarray(noise, bool), device=dev)
        self.carrier = ~self.noise
        self.has_noise = bool(self.noise.any())
        keys = list(GAPS) + list(COUNTS) + ["noise_soft_rms_gap"]
        self.vals = {k: torch.zeros((), dtype=torch.int64 if k.endswith(
            "mismatch") else torch.float64, device=dev) for k in keys}
        self.slots = torch.zeros((), dtype=torch.int64, device=dev)
        self.ref_valid = torch.zeros((), dtype=torch.int64, device=dev)
        self.blocks = 0
        self.worst = {}          # number -> (value, row, block) of its max
        self.mismatched = []     # (row, block) of the first valid mismatches
        spec = fam.spec
        cols = (np.arange(spec.frame_bytes) if fam.wire_columns is None
                else fam.wire_columns)
        self.cols = torch.from_numpy(np.asarray(cols, np.int64)).to(dev)
        self.shift = ref.bit_shift.to(dev)
        self.whiten = (None if ref.whiten is None
                       else ref.whiten[self.cols].to(torch.int32))

    def _max(self, key, per_row, rows):
        """Fold this block's per-row values of a gap, over ``rows``, into
        its maximum, remembering where the largest was."""
        v, r = torch.where(rows, per_row, 0.0).max(dim=0)
        v = v.to(torch.float64)
        if self.track:
            prev = self.worst.get(key)
            if prev is None or float(v) > prev[0]:
                self.worst[key] = (float(v), int(r), self.blocks - 1)
        self.vals[key] = torch.maximum(self.vals[key], v)

    def block(self, packed: np.ndarray, internals: dict, full=None):
        """``packed``: the program's rows [R, row_bytes] of this block;
        ``internals``: the reference's for the same rows; ``full``: the
        program's full frames [R, K, frame_bytes] uint8, where kept."""
        fam, dev = self.fam, self.dev
        frames, valid, rs_clean, rms, weak = unpack_rows(packed, fam)
        self.blocks += 1
        p_valid = torch.from_numpy(valid).to(dev)
        p_rms = torch.tensor(np.array(rms, np.float32), device=dev)
        r_valid = internals["valid"]
        r_rms = internals["soft_rms"].to(torch.float32)
        denom = torch.clamp_min(r_rms, 1e-30)
        rms_gap = (p_rms - r_rms).abs() / denom
        self._max("soft_rms_gap", rms_gap, self.carrier)
        if self.blocks == 1:
            self._max("soft_rms_gap_first", rms_gap, self.carrier)
        if self.has_noise:
            self._max("noise_soft_rms_gap", rms_gap, self.noise)
        self.ref_valid += (r_valid & self.carrier[:, None]).sum()
        tie = ((internals["peak"] - fam.sync_threshold).abs()
               < TIE).any(dim=-1)
        differ = (p_valid != r_valid).any(dim=-1) & ~tie & self.carrier
        self.vals["valid_mismatch"] += differ.sum()
        if self.track and len(self.mismatched) < 8 and bool(differ.any()):
            self.mismatched += [(int(r), self.blocks - 1)
                                for r in torch.nonzero(differ)[:, 0]]
        both = p_valid & r_valid & ~differ[:, None] & self.carrier[:, None]
        self.slots += both.sum()
        soft = internals["soft_fr"].to(torch.float32)
        rr, kk = soft.shape[:2]
        pb = torch.from_numpy(frames).to(dev).to(torch.int32)
        if self.whiten is not None:
            pb = pb ^ self.whiten
        bits = (pb[..., None] >> self.shift) & 1            # [R, K, nc, 8]
        line = fam.spec.line_code
        if line == "nrz":
            x = soft.reshape(rr, kk, -1, 8)[:, :, self.cols]
            gap = torch.relu(-(2.0 * bits - 1.0) * x)
        else:
            a = soft[..., 0::2].reshape(rr, kk, -1, 8)[:, :, self.cols]
            b = soft[..., 1::2].reshape(rr, kk, -1, 8)[:, :, self.cols]
            if line == "manchester":
                one = torch.maximum(torch.relu(-a), torch.relu(b))
                zero = torch.where((a > 0) & (b <= 0),
                                   torch.minimum(a, -b), torch.zeros_like(a))
                gap = torch.where(bits == 1, one, zero)
            else:
                ref_bit = ((a > 0) ^ (b > 0)).to(torch.int32)
                gap = torch.where(ref_bit != bits,
                                  torch.minimum(a.abs(), b.abs()),
                                  torch.zeros_like(a))
        gap = gap.amax(dim=(-1, -2)) / denom[:, None]
        self._max("chip_gap", torch.where(both, gap, 0.0).amax(dim=-1),
                  self.carrier)
        if weak is not None:
            self._weak(torch.from_numpy(weak).to(dev), soft, both, denom)
        if full is not None:
            f = torch.from_numpy(full).to(dev)
            if self.ref.rs is not None:
                want = rs_flags(f, self.ref.rs_w) & p_valid
            else:
                want = torch.zeros_like(p_valid)
            got = torch.from_numpy(rs_clean).to(dev)
            self.vals["rs_flag_mismatch"] += (got != want).sum()

    def _weak(self, weak, soft, both, denom):
        fam = self.fam
        rel = torch.minimum(soft[..., 0::2].abs(), soft[..., 1::2].abs())
        m = fam.chase_m
        worst = torch.zeros(both.shape, dtype=torch.float32, device=self.dev)
        for s, (a0, b0) in enumerate(fam.chase_spans):
            idx = weak[..., s * m:(s + 1) * m]
            inside = (idx >= a0) & (idx < b0)
            srt = torch.sort(idx, dim=-1).values
            distinct = (srt[..., 1:] != srt[..., :-1]).all(dim=-1)
            kth = torch.sort(rel[..., a0:b0], dim=-1).values[..., m - 1]
            got = torch.gather(rel, -1, torch.clamp(idx, 0, rel.shape[-1] - 1))
            g = torch.relu(got - kth[..., None]).amax(dim=-1)
            g = torch.where(inside.all(dim=-1) & distinct, g,
                            torch.full_like(g, OUT_OF_SPAN))
            worst = torch.maximum(worst, g)
        self._max("weak_gap", torch.where(both, worst / denom[:, None],
                                          0.0).amax(dim=-1), self.carrier)

    def numbers(self) -> dict:
        keys = list(GAPS) + list(COUNTS)
        if self.has_noise:
            keys.append("noise_soft_rms_gap")
        if not self.fam.chase_m:
            keys.remove("weak_gap")
        if self.ref.rs is None:
            self.vals["rs_flag_mismatch"].zero_()
        out = {k: (int(self.vals[k]) if k.endswith("mismatch")
                   else float(self.vals[k])) for k in keys}
        out["slots_compared"] = int(self.slots)
        out["ref_valid_frames"] = int(self.ref_valid)
        if self.track:
            out["where"] = {k: v for k, v in self.worst.items() if v[0] > 0}
            out["mismatched"] = self.mismatched[:8]
        return out


def merge(parts, names=None) -> dict:
    """The numbers of several judges (one per family): the largest gap,
    the summed counts; ``where`` keyed by family."""
    out = {}
    for i, p in enumerate(parts):
        for k, v in p.items():
            if k in ("where", "mismatched"):
                out.setdefault(k, {})[names[i] if names else str(i)] = v
            elif isinstance(v, float):
                out[k] = max(out.get(k, 0.0), v)
            else:
                out[k] = out.get(k, 0) + v
    return out
