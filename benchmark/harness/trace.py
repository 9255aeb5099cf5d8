"""The traced run's record: device operations and the benchmark's spans.

The profiler's Chrome trace is written to the run's temporary directory,
read and deleted. Device operations are the events of the categories
``kernel``, ``gpu_memcpy`` and ``gpu_memset``; spans are the benchmark's
own ``record_function`` ranges (``bench.dispatch`` around the entry call,
``bench.readback`` around the packed buffer's copy to the host). All
times are in microseconds on the trace's one clock.
"""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def record_of(prof, cell, blocks: int) -> dict:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    device, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((cat, e["name"], float(e["ts"]), float(e["dur"])))
        elif cat == "user_annotation" and e["name"].startswith("bench."):
            spans.append((e["name"], float(e["ts"]), float(e["dur"])))
    dispatch = [s for s in spans if s[0] == "bench.dispatch"]
    start = min(s[1] for s in dispatch) if dispatch else 0.0
    ends = [s[1] + s[2] for s in spans] + [d[2] + d[3] for d in device]
    end = max(ends) if ends else start
    return {"device": device, "spans": spans, "start_us": start,
            "end_us": end, "blocks": len(dispatch) or blocks,
            "config": cell.config}


def busy_intervals(device):
    """The union of the device operations' intervals, merged, sorted."""
    iv = sorted((ts, ts + dur) for _, _, ts, dur in device)
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_us(record) -> float:
    lo, hi = record["start_us"], record["end_us"]
    return sum(max(0.0, min(b, hi) - max(a, lo))
               for a, b in busy_intervals(record["device"]))


def breakdown(record, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by the benchmark span the host was in when each began."""
    by_name = {}
    for _, name, _, dur in record["device"]:
        by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    merged = busy_intervals(record["device"])
    gaps = []
    prev_end = record["start_us"]
    for a, b in merged + [[record["end_us"], record["end_us"]]]:
        if a > prev_end:
            gaps.append((prev_end, a - prev_end))
        prev_end = max(prev_end, b)
    spans = record["spans"]

    def host_at(t):
        for name, ts, dur in spans:
            if ts <= t < ts + dur:
                return name
        return "bench.loop"

    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n[:200], d / 1e6] for n, d in ops],
            "idle_gaps": [[host_at(t), d / 1e6] for t, d in gaps[:top]]}
