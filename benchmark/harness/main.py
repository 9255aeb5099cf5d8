"""One run of one cell: set-up, the measured window, the check, the
result line.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. Set-up builds the program's
system from the configuration, makes the traffic's ring of blocks on the
card from the seed, and warms up by streaming the ring once; ``setup_s``
runs from the process's start to the window's first block. The window
(``harness.window``) streams for ``--seconds``. After it, the program's
host decode reads the kept blocks' sampled rows, the program is freed, and
the reference follows the sampled rows through every block of the stream
and judges what the program read back (``reference.judge``). The run is
``correct`` when every number is within its limit
(``benchmark/limits/<cell>.json``); each number is printed beside its
limit on standard error, last, and in the result line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

from benchmark.gen.signals import RING_BLOCKS, numpy_rng
from benchmark.harness import catalog, trace, window

FORBIDDEN = ("jax", "jaxlib", "flax", "sondetpu")
HOST_THREADS = 4              # torch's intra-op threads on the host
WARMUP_BLOCKS = RING_BLOCKS   # set-up streams the ring once
TOLERANCE = {"deg": 1e-3, "m": 10.0}   # telemetry against its truth


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def caches(root: str) -> None:
    """The program's build and kernel caches at fixed paths in the
    checkout: its nvcc and g++ outputs go to build/sondetpu_torch/ by
    itself; PyTorch's extension and Triton caches are pointed there too."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def p95(xs):
    if len(xs) == 1:
        return xs[0]
    return statistics.quantiles(xs, n=100, method="inclusive")[94]


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def telemetry_check(decoded, truths, tol=TOLERANCE) -> dict:
    """The program's host-decoded telemetry of sampled rows against the
    truths their rows carry: a serial that differs, or a position off by
    more than ``tol`` (degrees, metres), is a mismatch."""
    bad, units = 0, 0
    for _, row, t in decoded:
        truth = truths.get(row)
        if truth is None:
            continue
        units += 1
        if t.get("serial") and t["serial"] != truth["serial"]:
            bad += 1
            continue
        for key, lim in (("lat", tol["deg"]), ("lon", tol["deg"]),
                         ("alt", tol["m"])):
            v = t.get(key)
            if v and abs(float(v) - truth[key]) > lim:
                bad += 1
                break
    return {"telemetry_mismatch": bad, "telemetry_units": units}


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit, kind)]): ``max`` numbers may not
    exceed their limit, ``min`` numbers may not fall below it."""
    rows, ok = [], True
    for name, spec in limits.items():
        v = numbers.get(name)
        lim, kind = spec["limit"], spec["kind"]
        good = (v is not None and not math.isnan(v)
                and (v <= lim if kind == "max" else v >= lim))
        ok &= good
        rows.append((name, v, lim, kind))
    return ok, rows


def keeper(seed: int, every: int):
    """``keep(k)``: whether stream block k keeps its full frames on the
    card for the check, every ``every``-th block from a seeded offset."""
    offset = int(numpy_rng(seed ^ 0xB10C).integers(every))
    return lambda k: k % every == offset


def host_side(system, ref, rows: dict, frames: dict):
    """The first half of the check, while the program lives: its host
    decode of the sampled rows of each block whose full frames were kept
    (``rows``: stream index -> sampled packed rows; ``frames``: stream
    index -> the program's frame tensors), and host copies of those rows'
    full frames. Empties ``frames``; returns (decoded, kept)."""
    decoded, kept = [], {}
    for k, fr in sorted(frames.items()):
        sel = [(g.local, r) for g, r in zip(ref.groups, rows[k])]
        decoded += [(g, ref.groups[g].rows[i], t)
                    for g, i, t in _local(system.host_decode(sel, fr), ref)]
        kept[k] = ref.select_frames(fr)
    frames.clear()
    return decoded, kept


def judge(ref, ring, rows: dict, kept: dict, decoded, track=False) -> dict:
    """The second half, once the program is freed: the reference follows
    the sampled rows through blocks 0 .. len(rows) - 1 of the stream and
    judges what the program read back, and the host decode is held to the
    truths. Every compared number, by name."""
    numbers = ref.run(len(rows), program=[rows[k] for k in range(len(rows))],
                      full=kept, track=track)
    numbers.update(telemetry_check(decoded, ring.truths))
    numbers["blocks_checked"] = len(rows)
    return numbers


def main(argv=None, t_start=None, check_device=True, root=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    root = root or catalog.ROOT
    caches(root)
    cell = catalog.Cell(args.workload, root)
    import torch

    if check_device:
        if not torch.cuda.is_available():
            print("benchmark: torch.cuda.is_available() is false; this "
                  "benchmark runs on an NVIDIA GPU only", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"benchmark: {cell.name} needs {cell.chips} GPUs, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(HOST_THREADS)

    # -- set-up -------------------------------------------------------------
    ring = cell.generator().make(torch, cell.config, cell.traffic,
                                 args.seed, device)
    system = cell.system().build(torch, cell.config, device, ring)
    ref = cell.reference().build(cell.config, cell.traffic, ring, args.seed,
                                 device)
    warm = WARMUP_BLOCKS
    kept_rows = {}
    for k in range(warm):
        packed, frames = system.step(ring.blocks[k % len(ring.blocks)])
        kept_rows[k] = ref.select(packed.cpu().numpy())
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
    setup_s = time.perf_counter() - t_start

    # -- the window -----------------------------------------------------------
    keep = keeper(args.seed, int(cell.traffic["check"]["keep_every"]))
    w = window.run(torch, system, ring, warm, args.seconds, ref.select, keep,
                   bool(args.trace))
    if device.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    kept_rows.update(w.rows)

    # -- after the window: the traced run's record, host decode, the check --
    record = None
    if args.trace:
        record = trace.record_of(w.prof, cell, w.traced)
        w.prof = None
    held = sum(t.numel() * t.element_size()
               for fr in w.frames.values() for t in fr)
    decoded, kept = host_side(system, ref, kept_rows, w.frames)
    del system
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = judge(ref, ring, kept_rows, kept, decoded)
    t_check = time.perf_counter() - t_check
    ok, rows = verdict(numbers, cell.limits)
    bad = forbidden_modules()
    if bad:
        print("benchmark: forbidden modules loaded in this process: "
              + ", ".join(bad), file=sys.stderr)
        return 3

    # -- the result line -------------------------------------------------------
    dev = device_info(torch, cell.chips) if device.type == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 0}
    if device.type == "cuda":
        dev["memory_peak_bytes"] = int(peak)
    metrics = {}
    if not args.trace:
        block_s = _block_seconds(cell.config)
        values = {
            "rt_channels": _channels(cell.config) * block_s * w.blocks
            / w.seconds,
            "block_ms_p95": p95(w.latencies()) * 1e3,
            "setup_s": setup_s,
        }
        if device.type == "cuda":
            values["peak_mem_gib"] = (peak - ring.nbytes - held) / 2 ** 30
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        # host time in the entry, from the window's blocks after the
        # profiler stopped: the profiler's own cost per operation would
        # dominate it inside the traced part
        record["dispatch_s"] = w.dispatch[w.traced:] or w.dispatch
        for m in cell.per_layer:
            v = catalog.metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = trace.busy_us(record) / 1e6
        dev["window_s"] = (record["end_us"] - record["start_us"]) / 1e6
    result = {"correct": bool(ok), "attempted": w.blocks, "failed": 0,
              "metrics": metrics, "device": dev}
    if args.trace:
        result["breakdown"] = trace.breakdown(record)
    result["detail"] = {"blocks": w.blocks, "window_s": w.seconds,
                        "warmup_blocks": warm, "ring_bytes": ring.nbytes,
                        "held_bytes": held,
                        "traffic": {k: v for k, v in ring.info.items()
                                    if k != "tuning"},
                        "check_s": t_check,
                        "dispatch_ms_untraced": _mean_ms(
                            w.dispatch[w.traced:] if args.trace else
                            w.dispatch),
                        "base_bytes": base_bytes if device.type == "cuda"
                        else 0}
    result["check"] = {name: {"value": v, "limit": lim, "kind": kind}
                       for name, v, lim, kind in rows}
    for name, v, lim, kind in rows:
        print(f"check {name} = {v} ({kind} {lim})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def _mean_ms(xs):
    return sum(xs) / len(xs) * 1e3 if xs else None


def _local(decoded, ref):
    """Host-decode results (group, row within the group, telemetry) to
    (group, index among the group's sampled rows, telemetry)."""
    out = []
    for g, row, t in decoded:
        local = list(ref.groups[g].local)
        if row in local:
            out.append((g, local.index(row), t))
    return out


def _block_seconds(config) -> float:
    c = config.get("pipeline") or config.get("fleet")
    return c["block_len"] / c.get("fs", c.get("fs_chan"))


def _channels(config) -> int:
    if "pipeline" in config:
        return int(config["pipeline"]["channels"])
    return int(config["fleet"]["n_bins"])
