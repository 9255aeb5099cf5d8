"""The program's own spans in a traced run: which stage launched each
device operation, which stage made the host wait, and which stage the
host was in when the card went idle.

The program opens a ``record_function`` range named ``sondetpu.<stage>``
around each stage of its step whenever a profiler runs (vocabulary:
``sondetpu_torch/runtime/metrics.py`` and the modules that call its
``span``):

- the entries: ``sondetpu.step`` (``Pipeline.step``) and
  ``sondetpu.fleet.step`` (``FleetSession.step``), inside which
  ``sondetpu.fleet.pfb``, one ``sondetpu.group.<sonde>`` per group and
  ``sondetpu.fleet.pack``;
- the pipeline's stages, in the order of its ``profile_stop`` stages:
  ``sondetpu.ingest``, ``.ddc``, ``.frontend``, ``.afc``, ``.timing``,
  ``.sample``, ``.ring``, ``.corr``, ``.peaks``, ``.gather``,
  ``.syndrome``, ``.pack``;
- the session's block: ``sondetpu.session.step``, ``.readback``,
  ``.decode``, ``.fetch``.

:func:`program_keys` reads them from the profiler's Chrome trace events,
with the CUDA runtime and driver calls and the correlation id of each
device operation, as three keys that sit beside the record of
``harness.trace.record_of``. On those keys:

- **Attribution.** A device operation belongs to the innermost program
  span that encloses its launch call on the host; its launch call is the
  runtime event with the same correlation id. A span's *chain* names it
  with the spans it nests in, outermost first:
  ``sondetpu.fleet.step>sondetpu.group.m10>sondetpu.corr``.
- **Synchronizing calls** are the runtime calls in :data:`SYNC_CALLS`;
  **launches** the calls in :data:`LAUNCH_CALLS`.
- :func:`stages`: one row per chain, per block (the longest by device or
  host ms, and every row with a synchronizing call): the host ms of the chain's
  own time (its spans' time less that of the program spans nested in
  them, so that the rows add up to the entry's time), the device ms of
  the operations it launched, its launches, its synchronizing calls and
  the host ms inside them, and the idle ms of the card's gaps that opened
  while the host was in it.
- :func:`idle_gaps`: the longest gaps, each labelled by the benchmark
  span and the program chain the host was in when the gap began
  (``bench.dispatch>sondetpu.step>sondetpu.timing``).

Times are microseconds on the trace's one clock, as in ``trace``.
"""

from __future__ import annotations

import bisect

from benchmark.harness.trace import DEVICE_CATS, busy_intervals

PREFIX = "sondetpu."
ENTRY_SPANS = ("sondetpu.step", "sondetpu.fleet.step")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy", "cudaFree"})
LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel", "cuLaunchKernelEx"})
SEP = ">"


def program_keys(events) -> dict:
    """From the Chrome trace's events: ``program_spans`` [(name, ts, dur,
    tid, chain)], ``runtime`` [(cat, name, ts, dur, correlation, tid)], and
    ``device_correlation``, the correlation id of each device operation in
    the order of the record's ``device`` list (None where it has none)."""
    raw, runtime, corr = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            corr.append(args.get("correlation"))
        elif cat == "user_annotation" and e["name"].startswith(PREFIX):
            raw.append((e["name"], float(e["ts"]), float(e["dur"]),
                        e.get("tid")))
        elif cat in RUNTIME_CATS:
            runtime.append((cat, e["name"], float(e["ts"]), float(e["dur"]),
                            args.get("correlation"), e.get("tid")))
    return {"program_spans": _nest(raw), "runtime": runtime,
            "device_correlation": corr}


def _nest(raw):
    """(name, ts, dur, tid) -> (name, ts, dur, tid, chain): each span's
    chain through the spans of its thread that enclose it."""
    out = []
    for tid, spans in _by_tid(raw).items():
        stack = []      # (end, chain) of the open spans
        for name, ts, dur, _ in spans:
            end = _push(stack, ts, ts + dur)
            chain = stack[-1][1] + SEP + name if stack else name
            stack.append((end, chain))
            out.append((name, ts, dur, tid, chain))
    return out


def _by_tid(spans):
    """Each thread's spans, by start and, at one start, the longest first."""
    by_tid = {}
    for s in spans:
        by_tid.setdefault(s[3], []).append(s)
    for sp in by_tid.values():
        sp.sort(key=lambda s: (s[1], -s[2]))
    return by_tid


def _push(stack, ts, end):
    """Close the spans of ``stack`` that ended by ``ts``; returns ``end``
    cut to the innermost open span's end (the trace rounds each time on
    its own, so a child may seem to outlast its parent)."""
    while stack and stack[-1][0] <= ts:
        stack.pop()
    return min(end, stack[-1][0]) if stack else end


class Index:
    """The innermost program chain the host was in at a time, per thread:
    each thread's spans flattened into disjoint segments."""

    def __init__(self, spans):
        self.threads = {}
        for tid, sp in _by_tid(spans).items():
            segs = []
            stack = []      # (end, chain) of the open spans
            t = None        # where the innermost open span's segment began
            for name, ts, dur, _, chain in sp:
                while stack and stack[-1][0] <= ts:
                    t = _close(segs, stack, t)
                if stack and ts > t:
                    segs.append((t, ts, stack[-1][1]))
                stack.append((_push(stack, ts, ts + dur), chain))
                t = ts
            while stack:
                t = _close(segs, stack, t)
            self.threads[tid] = ([s[0] for s in segs], segs)
        # the thread of the entry spans (the host's main thread)
        counts = {}
        for name, ts, dur, tid, chain in spans:
            if name in ENTRY_SPANS:
                counts[tid] = counts.get(tid, 0) + 1
        self.main = max(counts, key=counts.get) if counts else None

    def at(self, tid, t):
        """The chain at time ``t`` on thread ``tid`` (the entry thread
        where ``tid`` is None), or None outside every span."""
        found = self.threads.get(self.main if tid is None else tid)
        if found is None:
            return None
        starts, segs = found
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and segs[i][0] <= t < segs[i][1]:
            return segs[i][2]
        return None


def _close(segs, stack, t):
    """Close the innermost open span: its last segment runs from ``t``
    to its end. Returns where the next segment begins."""
    end, chain = stack.pop()
    if end > t:
        segs.append((t, end, chain))
    return max(t, end)


def has_program_spans(record) -> bool:
    return bool(record.get("program_spans"))


def in_stage(chain, stage) -> bool:
    """Whether the chain lies inside a span named ``stage`` (or one of
    ``stage``, a tuple of names)."""
    names = (stage,) if isinstance(stage, str) else stage
    return chain is not None and any(n in names for n in chain.split(SEP))


def runtime_chains(record):
    """[(runtime event, its innermost program chain or None)]."""
    ix = Index(record["program_spans"])
    return [(r, ix.at(r[5], r[2])) for r in record["runtime"]]


def device_chains(record):
    """[(device operation, the chain of its launch call or None)]."""
    launch = {}
    for r, chain in runtime_chains(record):
        if r[4] is not None:
            launch[r[4]] = chain
    corr = record.get("device_correlation") or []
    return [(d, launch.get(c)) for d, c in zip(record["device"], corr)]


def gaps(record):
    """Every idle gap of the card in the traced window: (start, length),
    in the order of time, as ``trace.breakdown`` finds them."""
    out = []
    prev_end = record["start_us"]
    merged = busy_intervals(record["device"])
    for a, b in merged + [[record["end_us"], record["end_us"]]]:
        if a > prev_end:
            out.append((prev_end, a - prev_end))
        prev_end = max(prev_end, b)
    return out


def bench_span_at(record, t) -> str:
    """The benchmark span the host was in at ``t`` (``bench.loop`` between
    them), as ``trace.breakdown`` labels a gap."""
    for name, ts, dur in record["spans"]:
        if ts <= t < ts + dur:
            return name
    return "bench.loop"


def gap_label(record, index, t) -> str:
    chain = index.at(None, t)
    bench = bench_span_at(record, t)
    return bench + SEP + chain if chain else bench


def idle_gaps(record, top: int = 10):
    """The ``top`` longest idle gaps as [label, seconds]."""
    ix = Index(record["program_spans"])
    longest = sorted(gaps(record), key=lambda g: -g[1])[:top]
    return [[gap_label(record, ix, t), d / 1e6] for t, d in longest]


def stages(record, top: int = 15):
    """One row per program chain, per block, sorted by device ms: the
    ``top`` rows by device ms, the ``top`` rows by host ms, and every row
    with a synchronizing call."""
    blocks = record["blocks"]
    rows = {}

    def row(chain):
        if chain not in rows:
            rows[chain] = {"stage": chain, "host_ms": 0.0, "device_ms": 0.0,
                           "launches": 0.0, "syncs": 0.0, "sync_ms": 0.0,
                           "idle_ms": 0.0}
        return rows[chain]

    spans = record["program_spans"]
    child_us = {}
    for name, ts, dur, tid, chain in spans:
        parent = chain.rpartition(SEP)[0]
        if parent:
            key = (tid, parent)
            child_us[key] = child_us.get(key, 0.0) + dur
    for name, ts, dur, tid, chain in spans:
        row(chain)["host_ms"] += dur
    for (tid, chain), us in child_us.items():
        if chain in rows:
            rows[chain]["host_ms"] -= us
    for r, chain in runtime_chains(record):
        if chain is None:
            continue
        if r[1] in LAUNCH_CALLS:
            row(chain)["launches"] += 1
        elif r[1] in SYNC_CALLS:
            row(chain)["syncs"] += 1
            row(chain)["sync_ms"] += r[3]
    for d, chain in device_chains(record):
        if chain is not None:
            row(chain)["device_ms"] += d[3]
    ix = Index(spans)
    for t, d in gaps(record):
        chain = ix.at(None, t)
        if chain is not None:
            row(chain)["idle_ms"] += d
    out = []
    for r in rows.values():
        for k in ("host_ms", "device_ms", "sync_ms", "idle_ms"):
            r[k] = r[k] / blocks / 1e3
        r["launches"] /= blocks
        r["syncs"] /= blocks
        out.append(r)
    by_host = {id(r) for r in sorted(out, key=lambda r: -r["host_ms"])[:top]}
    out.sort(key=lambda r: -r["device_ms"])
    return [r for i, r in enumerate(out)
            if i < top or id(r) in by_host or r["syncs"] > 0]


def entry_calls(record, names):
    """The runtime calls named in ``names`` that the host made inside an
    entry span (``ENTRY_SPANS``)."""
    return [r for r, chain in runtime_chains(record)
            if r[1] in names and in_stage(chain, ENTRY_SPANS)]


def stage_device_ms(record, stage):
    """Device ms a block of the operations launched inside ``stage``, or
    None where the record holds no such span."""
    if not any(in_stage(s[4], stage) for s in record["program_spans"]):
        return None
    us = sum(d[3] for d, chain in device_chains(record)
             if in_stage(chain, stage))
    return us / record["blocks"] / 1e3
