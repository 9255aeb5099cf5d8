"""The plain-op route's cell (``rs41-2048-plain.ongrid``) on the CPU: its
plain reference (``benchmark/reference/pipeline_plain.py``) against the
port's plain-op path through the harness's own check, the control, the
kernel route's reference in the plain reference's place, and the cell's
per-layer metric ``frontend_bound_share_pct`` on a hand-built record.

The tiny root is ``benchmark/tests/tiny.py``'s (8 channels, 1-s blocks, a
4-s period, 4 sampled rows), with the cell's configuration and limits
added beside it."""

import json
import os

import pytest
import torch

from benchmark.control import control_side, program_side
from benchmark.frozen.roofline import frontend_s
from benchmark.harness import catalog
from benchmark.harness.main import verdict
from benchmark.tests.tiny import REPO, tiny_root
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

CELL = "rs41-2048-plain.ongrid"
BLOCKS = 8


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tiny_root(tmp_path_factory.mktemp("tiny_plain"))
    here = os.path.join(path, "benchmark")
    with open(os.path.join(REPO, "benchmark", "configs",
                           "rs41-2048-plain.json")) as f:
        cfg = json.load(f)
    cfg["pipeline"].update(channels=8, block_len=48000)
    with open(os.path.join(here, "configs", "rs41-2048-plain.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(REPO, "benchmark", "limits", CELL + ".json")) as f:
        lim = json.load(f)
    with open(os.path.join(here, "limits", CELL + ".json"), "w") as f:
        json.dump(lim, f)
    return path


def _setup(root, seed, reference=None):
    c = catalog.Cell(CELL, root)
    dev = torch.device("cpu")
    ring = c.generator().make(torch, c.config, c.traffic, seed, dev)
    mod = c.reference() if reference is None else catalog.module(
        "reference", reference)
    return c, ring, mod.build(c.config, c.traffic, ring, seed, dev), dev


def test_the_cell_runs_the_plain_route(root):
    c = catalog.Cell(CELL, root)
    p = c.config["pipeline"]
    assert (p["use_pallas"], p["compute_dtype"], p["input_dtype"]) == (
        False, "f32", "i16")
    assert c.config["reference"] == "pipeline_plain"
    assert [m["name"] for m in c.per_layer if "workloads" in m] == [
        "frontend_bound_share_pct"]


def test_plain_reference_equals_the_port_on_the_cpu(root):
    c, ring, ref, dev = _setup(root, 31)
    nums = program_side(torch, c, ring, ref, BLOCKS, dev, 31)
    assert nums["slots_compared"] > 0 and nums["telemetry_units"] > 0
    for k in ("soft_rms_gap", "soft_rms_gap_first", "chip_gap",
              "valid_mismatch", "rs_flag_mismatch", "telemetry_mismatch"):
        assert nums[k] == 0, (k, nums)
    assert verdict(nums, c.limits)[0]


def test_the_control_is_caught(root):
    c, ring, ref, dev = _setup(root, 32)
    nums = control_side(torch, c, ring, ref, BLOCKS)
    nums.update(telemetry_mismatch=0, telemetry_units=1)
    ok, rows = verdict(nums, c.limits)
    assert not ok, rows


def test_the_kernel_route_reference_fails_the_plain_program(root):
    """``RefStep`` (K1's polynomial discriminator, HALO tails, no
    ``fm_prev`` or matched-FIR carry) in the plain reference's place."""
    c, ring, ref, dev = _setup(root, 33, reference="pipeline")
    nums = program_side(torch, c, ring, ref, BLOCKS, dev, 33)
    ok, rows = verdict(nums, c.limits)
    assert not ok, rows
    assert nums["soft_rms_gap"] > c.limits["soft_rms_gap"]["limit"]


# --- frontend_bound_share_pct on a hand-built record ------------------------

PIPE = {"sonde": "rs41", "channels": 2048, "fs": 48000.0,
        "block_len": 192000, "ntaps": 41, "compute_dtype": "f32"}


def _record(device, config=None):
    return {"device": device, "spans": [], "start_us": 0.0,
            "end_us": 400000.0, "blocks": 2,
            "config": {"pipeline": PIPE} if config is None else config}


def test_frontend_bound_share_on_known_busy_intervals():
    read = catalog.metric_reader("frontend_bound_share_pct")
    # busy 0-150 ms (two overlapping kernels) and 300-350 ms (a copy):
    # 200 ms over 2 blocks, 100 ms a block
    dev = [("kernel", "void at::native::mul", 0.0, 100000.0),
           ("kernel", "void at::native::add", 50000.0, 100000.0),
           ("gpu_memcpy", "Memcpy DtoH", 300000.0, 50000.0)]
    bound = frontend_s(2048, 192000, 2, 41, 4)
    assert read(_record(dev)) == pytest.approx(100.0 * bound / 0.1)
    assert read(_record(dev)) == pytest.approx(1.5904706865671642)


@pytest.mark.parametrize("case", ["no_device_events", "fleet_config"])
def test_frontend_bound_share_reads_nothing_without_its_inputs(case):
    read = catalog.metric_reader("frontend_bound_share_pct")
    dev = [("kernel", "void at::native::mul", 0.0, 100000.0)]
    if case == "no_device_events":
        assert read(_record([])) is None
    else:
        assert read(_record(dev, {"fleet": {"n_bins": 2048}})) is None
