"""The port's command line against the JAX package's, family by family.

For each of the eight families, ``synth`` writes the same IQ in both
packages, and ``decode`` of one synth file gives the same JSONL lines
(exactly: the telemetry comes from the frame bytes) and byte-equal GPX and
PTU files in both, the port on the CPU (``--device cpu``). Without a card
and without ``--device cpu`` the port's ``decode`` and ``fer`` stop with a
non-zero code and name the missing device. The other paths of ``decode``
are in ``tests/test_torch_cli_paths.py``.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from sondetpu.cli import main as jcli
from sondetpu.sondes import SUPPORTED_TYPES as JAX_TYPES
from sondetpu_torch.cli import main as tcli
from sondetpu_torch.sondes import SUPPORTED_TYPES
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)
from torch_cli_cases import assert_same, decode_both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("rs41", "rs41x", "m10", "dfm", "ims100", "imet4", "c50", "mrzn1")


def test_the_port_registers_the_original_families():
    assert SUPPORTED_TYPES == JAX_TYPES
    assert sorted(FAMILIES) == list(SUPPORTED_TYPES)


def test_types_prints_the_original_table(capsys):
    assert tcli.main(["types"]) == 0
    port = capsys.readouterr().out
    assert jcli.main(["types"]) == 0
    assert port == capsys.readouterr().out


@pytest.mark.parametrize("fmt", ["cf32", "cs16", "cs8"])
def test_synth_writes_the_original_bytes(tmp_path, fmt):
    out = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        out[name] = str(tmp_path / f"{name}.{fmt}")
        assert cli.main(["synth", "--sonde", "m10", "--frames", "3",
                         "--format", fmt, "--out", out[name]]) == 0
    assert open(out["jax"], "rb").read() == open(out["port"], "rb").read()


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_equals_the_original(tmp_path, family):
    iq = str(tmp_path / f"{family}.cf32")
    assert tcli.main(["synth", "--sonde", family, "--frames", "6",
                      "--out", iq]) == 0
    jax, port = decode_both(["--iq", iq, "--sonde", family], tmp_path)
    lines = assert_same(jax, port, min_lines=2)
    rec = json.loads(lines[-1])
    assert rec["type"] == family and rec["channel"] == 0
    assert jax["ptu"].count(b"\n") == len(lines) + 1


def test_decode_without_a_card_names_the_device(tmp_path):
    """The port runs on the CPU only when asked: --device cuda (the
    default) without a card exits non-zero and says which device is
    missing."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    iq = str(tmp_path / "x.cf32")
    assert tcli.main(["synth", "--frames", "2", "--out", iq]) == 0
    for argv in (["decode", "--iq", iq], ["fer", "--frames", "2"]):
        res = subprocess.run([sys.executable, "-m", "sondetpu_torch.cli.main",
                              *argv], capture_output=True, text=True,
                             timeout=300, cwd=REPO)
        assert res.returncode == 2, res.stderr
        assert "--device cuda: no CUDA device" in res.stderr
        assert res.stdout == ""


def test_fer_command_equals_the_original(capsys):
    argv = ["fer", "--sonde", "m10", "--snrs", "8,12", "--frames", "4",
            "--seed", "2"]
    assert jcli.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == want


def test_the_parser_has_no_scan_auto_or_bench():
    parser = tcli.build_parser()
    for argv in (["scan", "--iq", "x", "--fs-wide", "1"], ["bench"],
                 ["decode", "--iq", "x", "--auto"]):
        with pytest.raises(SystemExit):
            parser.parse_args(argv)
