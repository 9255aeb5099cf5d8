"""The measured window: one closed-loop stream through the card.

Block k is handed to the entry as soon as the loop comes round; then block
k - 1's packed buffer is read back to the host, which waits for the card
to finish block k as well (the copy is queued behind it on one stream).
A block's latency runs from handing it to the entry to its packed buffer
being in host memory. The loop ends with the first block that would start
after ``seconds``; the last buffer is then read back, and the window ends
there.
"""

from __future__ import annotations

import contextlib
import time

TRACE_SECONDS = 3.0   # the profiler runs over the window's first seconds


class Window:
    def __init__(self):
        self.hand = []        # host clock when block i was handed over
        self.done = []        # ... when its packed buffer was on the host
        self.dispatch = []    # seconds inside the entry call
        self.first = 0        # stream index of the window's first block
        self.rows = {}        # stream index -> sampled rows of its buffer
        self.frames = {}      # stream index -> kept full-frame tensors
        self.traced = 0       # blocks handed over while the profiler ran
        self.prof = None

    @property
    def blocks(self) -> int:
        return len(self.done)

    @property
    def seconds(self) -> float:
        return self.done[-1] - self.hand[0]

    def latencies(self):
        return [d - h for h, d in zip(self.hand, self.done)]


def run(torch, system, ring, first: int, seconds: float, select, keep,
        trace: bool = False) -> Window:
    """Stream ring blocks from stream index ``first`` for ``seconds``;
    ``select(host_packed)`` picks the rows the check keeps, ``keep(k)``
    says whether block k's full frames stay on the card for it. With
    ``trace``, ``torch.profiler`` runs over the window's first
    ``TRACE_SECONDS`` and spans mark the entry call and the readback."""
    w = Window()
    w.first = first
    blocks = ring.blocks
    nring = len(blocks)
    tracing = trace
    if tracing:
        act = torch.profiler.ProfilerActivity
        acts = [act.CPU] + ([act.CUDA] if torch.cuda.is_available() else [])
        w.prof = torch.profiler.profile(activities=acts)
        w.prof.start()

    def span(name):
        if tracing:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    k = first
    prev = None
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        t = time.perf_counter()
        if t >= deadline:
            break
        w.hand.append(t)
        with span("bench.dispatch"):
            packed, frames = system.step(blocks[k % nring])
        w.dispatch.append(time.perf_counter() - t)
        if keep(k):
            w.frames[k] = frames
        if prev is not None:
            with span("bench.readback"):
                host = prev[1].cpu().numpy()
            w.done.append(time.perf_counter())
            w.rows[prev[0]] = select(host)
        prev = (k, packed)
        k += 1
        if tracing and time.perf_counter() - t0 >= TRACE_SECONDS:
            tracing = False
            _sync(torch)
            w.prof.stop()
            w.traced = k - first
    host = prev[1].cpu().numpy()
    w.done.append(time.perf_counter())
    w.rows[prev[0]] = select(host)
    if tracing:
        _sync(torch)
        w.prof.stop()
        w.traced = k - first
    return w


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
