"""The port's oracle harness (``sondetpu_torch/bench/oracle.py``) against
the JAX package's (``tools/oracle_crosscheck.py``, loaded from its file
and called, not edited), on the CPU.

The self-test's report of each family must equal the original's entry
exactly (frames decoded, bit-exact frames, expected frames, frame diffs,
``ok`` and the telemetry diff), and every family must be ``ok``. The
readiness report, its JSON, the WAV the sondedump path feeds, and a
``--iq`` decode of a 50 kHz capture (the resampler branch) must be equal
too; ``--device cuda`` without a card exits 2 and names the device.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from sondetpu_torch.bench import oracle
from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_original():
    spec = importlib.util.spec_from_file_location(
        "oracle_crosscheck", os.path.join(ROOT, "tools", "oracle_crosscheck.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def original():
    return _load_original()


@pytest.fixture(scope="module")
def original_selftest(original):
    report = {}
    original.selftest(report)
    return report


def _text(obj) -> str:
    return json.dumps(obj, sort_keys=True)


@pytest.mark.parametrize("fam", list(oracle.FAMILIES))
def test_selftest_entry_equals_the_original(fam, original_selftest):
    got = oracle.selftest_entry(fam, "cpu")
    want = original_selftest[fam]
    assert _text(got) == _text(want)
    assert got["ok"] is True
    assert got["frames_decoded"] > 0
    if "frames_expected" in got:
        assert got["frames_bit_exact"] == got["frames_expected"] > 0
        assert got["frame_diffs"] == []


def test_families_and_tolerances_equal_the_original(original):
    assert list(oracle.FAMILIES) == list(original.FAMILIES)
    for fam, entry in oracle.FAMILIES.items():
        o = original.FAMILIES[fam]
        assert entry[0] == o[0].replace("sondetpu.", "sondetpu_torch.", 1)
        assert entry[1:] == o[1:]
    assert oracle.FIELD_TOL == original.FIELD_TOL


def _run_original(original, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["oracle_crosscheck.py"] + argv)
    return original.main()


def test_readiness_report_equals_the_original(original, tmp_path,
                                              monkeypatch, capsys):
    rc_o = _run_original(original, ["--out", str(tmp_path / "o.json")],
                         monkeypatch)
    out_o = capsys.readouterr().out.splitlines()
    rc_p = oracle.main(["--out", str(tmp_path / "p.json")])
    out_p = capsys.readouterr().out.splitlines()
    assert rc_o == rc_p == 0
    assert out_p[:-1] == out_o[:-1] and len(out_p) == 9
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "o.json").read_text()


def _rs41_capture(fs):
    return RS41Modulator().modulate([RS41Truth(frame_no=10 + i)
                                     for i in range(6)], fs=fs)


def test_fm_wav_bytes_equal_the_original(original, tmp_path):
    iq = _rs41_capture(48000.0)
    original._write_fm_wav(iq, str(tmp_path / "o.wav"))
    oracle._write_fm_wav(iq, str(tmp_path / "p.wav"))
    data = (tmp_path / "p.wav").read_bytes()
    assert len(data) > 44 + 2 * (iq.size - 2)
    assert data == (tmp_path / "o.wav").read_bytes()


def test_iq_at_50k_equals_the_original(original, tmp_path, monkeypatch,
                                       capsys):
    iq = _rs41_capture(50000.0)
    path = str(tmp_path / "cap.cf32")
    iq.astype(np.complex64).tofile(path)
    frames_o, _ = original._decode("rs41", iq, fs=50000.0)
    frames_p, _ = oracle._decode("rs41", iq, fs=50000.0, device="cpu")
    assert len(frames_p) == len(frames_o) >= 4
    for a, b in zip(frames_p, frames_o):
        np.testing.assert_array_equal(a, b)
    argv = ["--iq", f"rs41={path}:50000"]
    rc_o = _run_original(original, argv + ["--out", str(tmp_path / "o.json")],
                         monkeypatch)
    rc_p = oracle.main(argv + ["--device", "cpu",
                               "--out", str(tmp_path / "p.json")])
    capsys.readouterr()
    assert rc_o == rc_p == 0
    report = (tmp_path / "p.json").read_text()
    assert report == (tmp_path / "o.json").read_text()
    assert json.loads(report)["rs41"]["iq"]["telemetry"]["serial"] == \
        "S1234567"


def test_device_cuda_without_a_card_exits_2(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = oracle.main(["--selftest", "--device", "cuda",
                      "--out", str(tmp_path / "o.json")])
    err = capsys.readouterr().err
    assert rc == 2
    assert "--device cuda" in err and "no CUDA device" in err
    assert not (tmp_path / "o.json").exists()
