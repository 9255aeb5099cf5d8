"""The reference of a cell: which rows of the program's packed buffer it
checks, and the plain chain that follows those rows through the window.

A ``Group`` is one family's rows as the program's packed buffer lays
them out: its byte offset, its row count (with the pad rows the kernel
route adds), its sizes (``Family``) and its storage precision. The
reference of a cell samples rows from the seed, follows each sampled row
with a ``RefStep`` from the first block of the stream, and judges the
program's rows block by block (``judge.Judge``). ``run(..., lower=True)``
computes the reference one precision below the configuration's instead:
the control, whose packed rows are judged in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.frozen.dsp.fir import design_lowpass
from benchmark.gen.signals import numpy_rng
from benchmark.reference import twins
from benchmark.reference.judge import Judge, merge
from benchmark.reference.step import BlockRing, Family, RefStep
from benchmark.reference.twins import Precision

ROW_MULTIPLE = 8   # the kernel route pads a fleet group to this many rows
TPP = 8            # PFB taps per phase
PFB_CUTOFF = 0.45  # PFB prototype cutoff, in channel spacings


class Group:
    def __init__(self, fam: Family, prec: str, offset: int, count: int,
                 local, rows, noise=None):
        self.fam, self.prec = fam, Precision(prec)
        self.offset, self.count = offset, count
        self.local = np.asarray(local, np.int64)     # rows within the group
        self.rows = list(rows)                       # the cell's row ids
        self.noise = noise                           # rows with no sonde

    def select(self, packed: np.ndarray) -> np.ndarray:
        """This group's sampled rows [R, row_bytes] of a packed buffer."""
        rb = self.fam.row_bytes
        block = packed[self.offset:self.offset + self.count * rb]
        return block.reshape(self.count, rb)[self.local]


class CellReference:
    """Sampled rows, their groups, and the plain chain over them."""

    groups: list

    def select(self, packed: np.ndarray) -> list:
        return [g.select(packed) for g in self.groups]

    def select_frames(self, frames) -> list:
        """Host copies [R, K, frame_bytes] of the sampled rows' full frames
        from the program's per-group frame tensors."""
        return [f[torch.from_numpy(g.local).to(f.device)].cpu().numpy()
                for g, f in zip(self.groups, frames)]

    def _tuning(self, g):
        """The group's sampled rows' DDC offsets and AFC, or None."""
        tune = getattr(self.ring, "info", {}).get("tuning")
        if not tune:
            return None
        return {"fine_offsets": [tune["fine_offsets"][r] for r in g.rows],
                "afc": tune.get("afc", False)}

    def _planes(self, lower: bool):
        """Per group: (steady ring planes, first-block planes) of its
        sampled rows, in what the group's step reads."""
        raise NotImplementedError

    def run(self, n_blocks: int, program=None, full=None, lower=False,
            track=False):
        """Follow the sampled rows through ``n_blocks`` blocks. With
        ``program`` (per block, per group: the program's packed rows) and
        ``full`` (block -> per group full frames), judge them and return
        the numbers; without, return the reference's own (packed rows, full
        frames) per block and group (``lower``: the control's). ``track``
        also says where each largest gap lies (row id, block, whether the
        row carries a truth)."""
        planes = self._planes(lower)
        rings, judges = [], []
        for g, (steady, first) in zip(self.groups, planes):
            prec = g.prec.lower() if lower else g.prec
            st = RefStep(g.fam, len(g.local), prec, steady[0][0].device,
                         self._tuning(g))
            rings.append(BlockRing(st, steady, first))
            judges.append(Judge(g.fam, st, g.noise, track))
        rows = []
        for k in range(n_blocks):
            out = []
            for j, (ring, judge) in enumerate(zip(rings, judges)):
                packed, internals = ring.block(k)
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
            # rows as the cell's row ids (channels or bins)
            for fam, w in out.get("where", {}).items():
                g = next(g for g in self.groups if g.fam.sonde == fam)
                for k, (v, r, b) in w.items():
                    w[k] = (v, int(g.rows[r]), b, int(g.rows[r]) in getattr(
                        self.ring, "truths", {}))
        return out


class PipelineReference(CellReference):
    """One family on every channel (a ``pipeline`` configuration)."""

    def __init__(self, config: dict, traffic: dict, ring, seed: int, device):
        p = config["pipeline"]
        check = traffic["check"]
        self.ring, self.device = ring, torch.device(device)
        fam = Family(p["sonde"], p["fs"], p["block_len"], p.get("ntaps", 41),
                     p.get("sync_threshold", 0.6))
        c = int(p["channels"])
        rng = numpy_rng(seed ^ 0x5EED)
        local = np.sort(rng.choice(c, size=min(c, check["sample_rows"]),
                                   replace=False))
        self.groups = [Group(fam, p["compute_dtype"], 0, c, local, local)]

    def _planes(self, lower):
        idx = torch.from_numpy(self.groups[0].local).to(self.device)
        steady = [(i[idx], q[idx]) for i, q in self.ring.blocks]
        return [(steady, None)]


class FleetReference(CellReference):
    """The PFB and one group per family (a ``fleet`` configuration)."""

    def __init__(self, config: dict, traffic: dict, ring, seed: int, device):
        f = config["fleet"]
        check = traffic["check"]
        self.ring, self.device = ring, torch.device(device)
        self.n_bins, self.block_len = int(f["n_bins"]), int(f["block_len"])
        self.pfb_prec = Precision(f["compute_dtype"])
        fmap = f["family_by_bin_mod"]
        families = []
        bins_of = {}
        for k in range(self.n_bins):
            fam = fmap[k % len(fmap)]
            if fam not in bins_of:
                families.append(fam)
                bins_of[fam] = []
            bins_of[fam].append(k)
        rng = numpy_rng(seed ^ 0x5EED)
        carriers = set(ring.truths)
        self.groups, offset = [], 0
        for fam_name in families:
            fam = Family(fam_name, f["fs_chan"], self.block_len,
                         f.get("ntaps", 41), f["sync_threshold"])
            bins = bins_of[fam_name]
            count = len(bins) + (-len(bins)) % ROW_MULTIPLE
            noise = [b for b in bins if b not in carriers]
            pick = sorted(set(b for b in bins if b in carriers) | set(
                int(x) for x in rng.choice(
                    noise, size=min(len(noise),
                                    check["sample_noise_bins"][fam_name]),
                    replace=False)))
            local = [bins.index(b) for b in pick]
            # the group dtype rule: the kernel route's NRZ groups in
            # float32, the dual-tone groups in the fleet's dtype
            prec = f["compute_dtype"] if fam.dualtone else "f32"
            self.groups.append(Group(fam, prec, offset, count, local, pick,
                                     [b not in carriers for b in pick]))
            offset += count * fam.row_bytes
        L = self.n_bins * TPP
        proto = design_lowpass(PFB_CUTOFF, float(self.n_bins), L + 1)[:L] \
            * self.n_bins
        hbank = proto.reshape(TPP, self.n_bins).T.astype(np.float32)
        perm = np.zeros(self.n_bins, np.int64)
        perm[1:] = self.n_bins - np.arange(1, self.n_bins)
        self.hcol = torch.from_numpy(np.ascontiguousarray(hbank[perm].T)).to(
            self.device)

    def _pfb(self, tail, block, prec, bins):
        n, m = self.n_bins, self.block_len
        vi = torch.cat([tail[0].view(TPP, n), block[0].view(m, n)])
        vq = torch.cat([tail[1].view(TPP, n), block[1].view(m, n)])
        u_i, u_q = twins.pfb_fir(vi, vq, self.hcol, prec)
        del vi, vq
        return twins.pfb_dft(u_i, u_q, prec, bins)

    def _planes(self, lower):
        prec = self.pfb_prec.lower() if lower else self.pfb_prec
        bins = torch.tensor([b for g in self.groups for b in g.rows],
                            device=self.device)
        L = self.n_bins * TPP
        blocks = self.ring.blocks
        zero = torch.zeros(L, device=self.device)
        first = self._pfb((zero, zero), blocks[0], prec, bins)
        steady = [self._pfb((blocks[p - 1][0][-L:], blocks[p - 1][1][-L:]),
                            blocks[p], prec, bins)
                  for p in range(len(blocks))]
        out, r0 = [], 0
        for g in self.groups:
            r1 = r0 + len(g.rows)
            out.append(([(y_i[r0:r1], y_q[r0:r1]) for y_i, y_q in steady],
                        (first[0][r0:r1], first[1][r0:r1])))
            r0 = r1
        return out
