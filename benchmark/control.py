"""Readings for the limits that decide ``correct``: the program's, the
control's and planted faults', over many seeds in one process.

    python benchmark/control.py --workload <cell> --seeds 11,12,13 \
        --blocks <n> [--side program|control|both|fault:<name>]

For each seed it makes the cell's traffic, streams ``--blocks`` blocks
(the cell's warm-up and about as many as a window holds) and judges them
with the harness's own check (``harness.main.host_side`` and ``judge``):

- ``program`` streams them through the program's entry;
- ``control`` puts the reference computed one precision below the
  configuration's (bfloat16 for float32, float8 for bfloat16) in the
  program's place;
- ``fault:<name>`` puts the reference, in the configuration's precision,
  with one fault of ``FAULTS`` planted, in the program's place.

One JSON line per seed and side, with every compared number. The
benchmark's own runs never run this; its readings are in PERF.md.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import catalog  # noqa: E402
from benchmark.harness.main import host_side, judge, keeper  # noqa: E402
from benchmark.reference.cells import FleetReference  # noqa: E402
from benchmark.reference.step import RefStep  # noqa: E402


@contextlib.contextmanager
def _patched(owner, name, fn):
    orig = getattr(owner, name)
    setattr(owner, name, fn(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _phase_reset(orig):
    """The DDC's phase is not carried: every block starts from phase 0."""
    def f(self, i, q):
        self.phase = self.phase * 0.0
        return orig(self, i, q)
    return f


def _afc_frozen(orig):
    """The AFC never moves the DDC's frequency off its seed."""
    return lambda self, dc: None


def _afc_doubled(orig):
    """The AFC moves the frequency twice a block."""
    def f(self, dc):
        orig(self, dc)
        orig(self, dc)
    return f


def _tails_dropped(orig):
    """The front end's filter tails are not carried into the next block."""
    def f(self, i, q, ti, tq):
        return orig(self, i, q, ti * 0, tq * 0)
    return f


def _noise_bins_moved(orig):
    """The PFB hands each bin that carries no sonde its neighbour's output:
    a channelizer fault on empty bins alone."""
    def f(self, tail, block, prec, bins):
        empty = bins.new_tensor([int(b) not in self.ring.truths
                                 for b in bins.tolist()]).bool()
        return orig(self, tail, block, prec,
                    ((bins + 1) % self.n_bins).where(empty, bins))
    return f


# faults planted in the reference put in the program's place: the first
# four break state that the offgrid step carries from one block to the
# next; the last breaks the fleet's noise bins alone
FAULTS = {"ddc_phase_reset": (RefStep, "_downconvert", _phase_reset),
          "afc_frozen": (RefStep, "_afc_update", _afc_frozen),
          "afc_doubled": (RefStep, "_afc_update", _afc_doubled),
          "tails_dropped": (RefStep, "frontend", _tails_dropped),
          "noise_bins_moved": (FleetReference, "_pfb", _noise_bins_moved)}


def program_side(torch, cell, ring, ref, blocks, device, seed):
    system = cell.system().build(torch, cell.config, device, ring)
    keep = keeper(seed, int(cell.traffic["check"]["keep_every"]))
    rows, frames = {}, {}
    prev = None
    for k in range(blocks):
        packed, fr = system.step(ring.blocks[k % len(ring.blocks)])
        if keep(k):
            frames[k] = fr
        if prev is not None:
            rows[k - 1] = ref.select(prev.cpu().numpy())
        prev = packed
    rows[blocks - 1] = ref.select(prev.cpu().numpy())
    decoded, kept = host_side(system, ref, rows, frames)
    del system, prev
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return judge(ref, ring, rows, kept, decoded, track=True)


def control_side(torch, cell, ring, ref, blocks, fault=None):
    """The control, or with ``fault`` the reference at the configuration's
    precision with that fault planted, judged in the program's place."""
    plant = (_patched(*FAULTS[fault]) if fault
             else contextlib.nullcontext())
    with plant:
        out = ref.run(blocks, lower=fault is None)
    rows = {k: [p for p, _ in blk] for k, blk in enumerate(out)}
    full = {k: [f for _, f in blk] for k, blk in enumerate(out)}
    return ref.run(blocks, program=[rows[k] for k in range(blocks)],
                   full=full, track=True)


def main(argv=None, device=None, root=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--blocks", type=int, required=True)
    ap.add_argument("--side", default="both",
                    choices=("program", "control", "both")
                    + tuple("fault:" + f for f in FAULTS))
    args = ap.parse_args(argv)
    import torch

    cell = catalog.Cell(args.workload, root or catalog.ROOT)
    if device is None:
        if not torch.cuda.is_available():
            print("control: no GPU", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sides = ("program", "control") if args.side == "both" else (args.side,)
    for seed in (int(s) for s in args.seeds.split(",")):
        ring = cell.generator().make(torch, cell.config, cell.traffic, seed,
                                     device)
        ref = cell.reference().build(cell.config, cell.traffic, ring, seed,
                                     device)
        for side in sides:
            t0 = time.perf_counter()
            if side == "program":
                nums = program_side(torch, cell, ring, ref, args.blocks,
                                    device, seed)
            else:
                nums = control_side(torch, cell, ring, ref, args.blocks,
                                    side.partition(":")[2] or None)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "side": side, "blocks": args.blocks,
                              "seconds": time.perf_counter() - t0, **nums}),
                  flush=True)
        del ring, ref
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
