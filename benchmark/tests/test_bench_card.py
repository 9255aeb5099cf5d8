"""The benchmark's command on the card: a short run of each cell comes out
correct with a result line of the contract's keys. Needs an NVIDIA GPU;
without one it skips (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.tiny import CELLS, REPO


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card "
                    "and has no CPU mode")


@pytest.mark.parametrize("cell", CELLS)
def test_card_run_is_correct(cuda_device, cell):
    r = subprocess.run(
        [sys.executable, os.path.join("benchmark", "run.py"), "--workload",
         cell, "--seed", "2147483999", "--seconds", "2", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["check"]
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert res["device"]["platform"] == "gpu"


def test_no_card_exits_nonzero_without_result():
    """With no GPU visible the command exits non-zero and prints no
    result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, os.path.join("benchmark", "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_benchmark_alone_exits_nonzero(cuda_device, tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/ (no
    program), the command exits non-zero and prints no result line."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run(
        [sys.executable, os.path.join("benchmark", "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
