"""Where a cell's step spends the host's and the card's time, stage by
stage, from the program's own spans (``harness.spans``).

    python benchmark/stages.py --workload <cell> --seed <n> [--seconds 6]

It sets the cell up as a run does (traffic, system, warm-up), streams the
window with the profiler over its first 3 s as a ``--trace 1`` run does,
and prints one JSON object:

- ``metrics``: the cell's per-layer metrics (BENCHMARK.json's readers)
  and the readers of the program's spans (``SPAN_METRICS``);
- ``stages``: ``harness.spans.stages``' rows, and ``stages_cover``, the
  share of the traced host time inside ``bench.dispatch`` that they hold;
- ``idle_gaps``: the longest gaps of the card, labelled by the benchmark
  span and the program chain the host was in when each began, and
  ``unlabelled_gaps``, the gaps of 1 ms or more that opened inside
  ``bench.dispatch`` (after the window's start) outside every program
  span;
- ``dispatch_ms_traced`` / ``dispatch_ms_untraced``: host ms inside the
  entry a block, with the profiler on and after it stopped;
- ``entry_runtime``: each CUDA runtime or driver call the entry made, as
  [calls, host ms] a block.

It checks no output; the benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import catalog, spans, trace, window  # noqa: E402
from benchmark.harness import main as harness  # noqa: E402

SPAN_METRICS = ("syncs_per_step", "sync_wait_ms", "launches_per_step",
                "corr_device_ms", "ddc_device_ms")
GAP_MS = 1.0     # the gaps that must carry a program label


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/stages.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    return ap.parse_args(argv)


def traced_record(prof, cell, blocks: int) -> dict:
    """``trace.record_of``'s record with ``spans.program_keys`` beside it,
    from one export of the trace (a profiler exports it once)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            tr = json.load(f)
        record = trace.record_of(_Exported(path), cell, blocks)
    finally:
        os.remove(path)
    record.update(spans.program_keys(
        tr["traceEvents"] if isinstance(tr, dict) else tr))
    return record


class _Exported:
    """Stands in for a profiler whose trace is already at ``path``."""

    def __init__(self, path: str):
        self.path = path

    def export_chrome_trace(self, path: str) -> None:
        shutil.copyfile(self.path, path)


def summary(record, cell) -> dict:
    """Every number this script prints but the untraced dispatch."""
    metrics = {}
    names = [m["name"] for m in cell.per_layer] + list(SPAN_METRICS)
    for name in names:
        v = catalog.metric_reader(name)(record)
        if v is not None:
            metrics[name] = v
    rows = spans.stages(record)
    dispatch = [(ts, d) for n, ts, d in record["spans"]
                if n == "bench.dispatch"]
    traced_ms = sum(d for _, d in dispatch) / max(len(dispatch), 1) / 1e3
    ix = spans.Index(record["program_spans"])
    # a gap at the window's start opened before it (the card idles from
    # the warm-up's last readback), not inside the entry
    unlabelled = [d / 1e3 for t, d in spans.gaps(record)
                  if d >= GAP_MS * 1e3 and t > record["start_us"]
                  and spans.bench_span_at(record, t) == "bench.dispatch"
                  and ix.at(None, t) is None]
    chains = spans.runtime_chains(record)
    attributed = sum(1 for _, chain in chains if chain is not None)
    calls = {}
    for r, chain in chains:
        if spans.in_stage(chain, spans.ENTRY_SPANS):
            n, us = calls.get(r[1], (0, 0.0))
            calls[r[1]] = (n + 1, us + r[3])
    blocks = record["blocks"]
    return {"blocks_traced": record["blocks"], "metrics": metrics,
            "dispatch_ms_traced": traced_ms,
            "stages_cover": (sum(r["host_ms"] for r in rows) / traced_ms
                             if traced_ms else None),
            "stages": rows, "idle_gaps": spans.idle_gaps(record),
            "unlabelled_gaps": unlabelled,
            "runtime_calls": len(record["runtime"]),
            "runtime_attributed": attributed,
            "entry_runtime": {name: [n / blocks, us / blocks / 1e3]
                              for name, (n, us) in sorted(
                                  calls.items(), key=lambda x: -x[1][1])}}


def main(argv=None, check_device=True, root=None) -> int:
    args = parse(argv)
    root = root or catalog.ROOT
    harness.caches(root)
    cell = catalog.Cell(args.workload, root)
    import torch

    if check_device:
        if not torch.cuda.is_available():
            print("stages: no GPU", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(harness.HOST_THREADS)
    ring = cell.generator().make(torch, cell.config, cell.traffic,
                                 args.seed, device)
    system = cell.system().build(torch, cell.config, device, ring)
    warm = harness.WARMUP_BLOCKS
    for k in range(warm):
        system.step(ring.blocks[k % len(ring.blocks)])[0].cpu()
    w = window.run(torch, system, ring, warm, args.seconds,
                   lambda host: None, lambda k: False, trace=True)
    record = traced_record(w.prof, cell, w.traced)
    w.prof = None
    record["dispatch_s"] = w.dispatch[w.traced:] or w.dispatch
    result = {"workload": cell.name, "seed": args.seed,
              "device": (torch.cuda.get_device_name(0)
                         if device.type == "cuda" else "cpu")}
    result.update(summary(record, cell))
    result["dispatch_ms_untraced"] = harness._mean_ms(w.dispatch[w.traced:])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
