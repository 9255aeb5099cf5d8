"""The window's arithmetic: the rate is all the work over all the time,
the tail is the 95th percentile over every block."""

import statistics
import time

import numpy as np
import torch

from benchmark.harness import main as hmain
from benchmark.harness import window


class _Ring:
    def __init__(self):
        self.blocks = [(torch.zeros(4),) for _ in range(4)]


class _SlowSystem:
    """Every 10th block takes 30 ms on the 'device', the rest 2 ms: the
    latency of a block is read when its buffer reaches the host."""

    def __init__(self):
        self.k = 0

    def step(self, planes):
        self.k += 1
        t = 0.030 if self.k % 10 == 0 else 0.002
        return _Buf(t), [torch.zeros(1)]


class _Buf:
    def __init__(self, t):
        self.t = t

    def cpu(self):
        time.sleep(self.t)
        return self

    def numpy(self):
        return np.zeros(4, np.uint8)


def test_window_counts_every_block_and_all_the_time():
    w = window.run(torch, _SlowSystem(), _Ring(), 4, 0.5,
                   lambda host: host, lambda k: k % 7 == 0)
    assert w.blocks == len(w.hand) == len(w.done) >= 10
    assert sorted(w.rows) == list(range(4, 4 + w.blocks))
    assert all(k % 7 == 0 for k in w.frames)
    lat = w.latencies()
    assert all(x > 0 for x in lat)
    # the window runs from the first hand-over to the last buffer home
    assert w.seconds == w.done[-1] - w.hand[0]
    assert w.seconds >= 0.5
    rate = 8 * 4.0 * w.blocks / w.seconds
    assert abs(rate - 32.0 * w.blocks / w.seconds) < 1e-9


def test_p95_over_every_block():
    lat = [1.0] * 95 + [10.0] * 5
    assert hmain.p95(lat) == statistics.quantiles(
        lat, n=100, method="inclusive")[94]
    assert 1.0 <= hmain.p95(lat) <= 10.0
    assert hmain.p95([3.0]) == 3.0
    # a slow tail of more than 5% of the blocks sets the percentile
    assert hmain.p95([1.0] * 90 + [10.0] * 10) == 10.0


def test_verdict_holds_each_number_to_its_limit():
    lim = {"a": {"limit": 1e-3, "kind": "max"},
           "n": {"limit": 1, "kind": "min"}}
    assert hmain.verdict({"a": 1e-4, "n": 3}, lim)[0]
    assert not hmain.verdict({"a": 2e-3, "n": 3}, lim)[0]
    assert not hmain.verdict({"a": 1e-4, "n": 0}, lim)[0]
    assert not hmain.verdict({"a": float("nan"), "n": 3}, lim)[0]
    assert not hmain.verdict({"n": 3}, lim)[0]
