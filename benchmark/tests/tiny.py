"""A tiny copy of the benchmark's cells for CPU tests.

``tiny_root(path)`` writes BENCHMARK.json and the cells' configuration,
traffic and limit files under ``path`` with the sizes cut to what a CPU
test holds (8 channels or 16 bins, 1 s blocks, a 4 s period, a few sampled
rows); the harness's code is the real one. Torch runs one thread, in the
harness too.
"""

from __future__ import annotations

import json
import os

import torch

from benchmark.harness import main as harness

os.environ["OMP_NUM_THREADS"] = "1"
torch.set_num_threads(1)
harness.HOST_THREADS = 1

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ("rs41-2048.ongrid", "fleet-2048.bench-mix", "rs41-2048.offgrid-afc")


def _load(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return json.load(f)


def tiny_root(path) -> str:
    path = str(path)
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(path, "benchmark", d), exist_ok=True)
    bench = _load("BENCHMARK.json")
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cfg = _load("benchmark", "configs", "rs41-2048.json")
    cfg["pipeline"].update(channels=8, block_len=48000)
    fleet = _load("benchmark", "configs", "fleet-2048.json")
    fleet["fleet"].update(n_bins=16, block_len=48000)
    for name, c in (("rs41-2048", cfg), ("fleet-2048", fleet)):
        with open(os.path.join(path, "benchmark", "configs", name + ".json"),
                  "w") as f:
            json.dump(c, f)
    t = _load("benchmark", "traffic", "ongrid.json")
    t.update(period_s=4.0, truths=4)
    t["check"].update(sample_rows=4, keep_every=2)
    w = _load("benchmark", "traffic", "bench-mix.json")
    w.update(period_s=4.0, carriers={"rs41": 1, "m10": 1, "dfm": 1})
    w["check"].update(sample_noise_bins={"rs41": 1, "m10": 1, "dfm": 1},
                      keep_every=2)
    o = _load("benchmark", "traffic", "offgrid-afc.json")
    o.update(period_s=4.0, truths=4)
    o["tuning"]["offset_step_hz"] = 0.25     # whole cycles in 4 s
    o["check"].update(sample_rows=4, keep_every=2)
    for name, x in (("ongrid", t), ("bench-mix", w), ("offgrid-afc", o)):
        with open(os.path.join(path, "benchmark", "traffic", name + ".json"),
                  "w") as f:
            json.dump(x, f)
    for cell in CELLS:
        lim = _load("benchmark", "limits", cell + ".json")
        with open(os.path.join(path, "benchmark", "limits", cell + ".json"),
                  "w") as f:
            json.dump(lim, f)
    return path


def run_cell(root, cell, seed, seconds=1.0, trace=0, capsys=None):
    """One CPU run of a tiny cell through the real harness; the result
    line as a dict."""
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds",
               str(seconds), "--trace", str(trace)], check_device=False,
              root=root)
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
