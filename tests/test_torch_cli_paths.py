"""The other paths of the port's ``decode`` against the JAX package's.

Each case runs both command lines in this process on one input file, the
port with ``--device cpu``, and holds the JSONL lines equal (exactly) and
the GPX and PTU files byte-equal: ``--stream`` through the native reader,
``--rate 50000`` through the device resampler, a cs8 file with
``device_dequant``, ``--sonde auto``, ``--wideband --bins 8`` with the
off-grid rs41 carrier of ``tests/test_runtime_aux.py``, ``--channels 8``
with ``use_pallas`` (the kernels' plain twins here, Pallas in interpret
mode in JAX), ``--checkpoint`` then ``--resume``, where the port also
resumes from the JAX package's checkpoint, and ``--status``, ``--table``,
``--watchdog``, ``--host-workers`` with ``--afc``. ``--trace`` writes a
``torch.profiler`` Chrome trace (the original's is a ``jax.profiler`` one).
"""

import json

import numpy as np
import pytest

from sondetpu_torch.cli.config import ChannelConfig, FrameworkConfig
from sondetpu_torch.io import iq as tiq
from sondetpu_torch.io.iq import write_iq
from sondetpu_torch.sondes.modulate import freq_shift, gfsk_modulate
from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)
from torch_cli_cases import assert_same, decode, decode_both


def _rs41(path, fs=48000.0, frames=8, fmt="cf32", noise=0.05, seed=3):
    """An rs41 capture at ``fs`` with seeded complex noise of std
    ``noise``, written as ``fmt``."""
    iq = RS41Modulator().modulate(
        [RS41Truth(frame_no=30 + i) for i in range(frames)], fs=fs)
    rng = np.random.default_rng(seed)
    iq = iq + (noise * (rng.normal(size=iq.size)
                        + 1j * rng.normal(size=iq.size)))
    write_iq(str(path), iq.astype(np.complex64), fmt)
    return str(path)


def _config(path, **kw):
    cfg = FrameworkConfig(**kw)
    cfg.save(str(path))
    return str(path)


@pytest.mark.parametrize("fmt", ["cf32", "cs16"])
def test_stream_equals_the_original_and_the_file_read(tmp_path, fmt):
    iq = _rs41(tmp_path / f"x.{fmt}", fmt=fmt)
    tiq.reset_readers()
    jax, port = decode_both(["--iq", iq, "--sonde", "rs41", "--stream"],
                            tmp_path)
    assert tiq.readers.get("native:iqs_read", 0) > 0, tiq.readers
    lines = assert_same(jax, port, min_lines=5)
    whole = decode("port", ["--iq", iq, "--sonde", "rs41"],
                   str(tmp_path / "whole"))
    assert whole["jsonl"].decode().splitlines() == lines


def test_rate_50k_equals_the_original(tmp_path):
    iq = _rs41(tmp_path / "cap50k.cf32", fs=50000.0)
    jax, port = decode_both(["--iq", iq, "--sonde", "rs41", "--rate",
                             "50000"], tmp_path)
    lines = assert_same(jax, port, min_lines=4)
    assert json.loads(lines[-1])["serial"] == "S1234567"


@pytest.mark.parametrize("stream", [False, True], ids=["file", "stream"])
def test_cs8_device_dequant_equals_the_original(tmp_path, stream):
    iq = _rs41(tmp_path / "x.cs8", fmt="cs8")
    cfg = _config(tmp_path / "cfg.json", device_dequant=True)
    tiq.reset_readers()
    jax, port = decode_both(["--iq", iq, "--sonde", "rs41", "--config", cfg]
                            + (["--stream"] if stream else []), tmp_path)
    want = "native:iqs_read_raw" if stream \
        else "numpy:interleaved_to_int_planes"
    assert tiq.readers.get(want, 0) > 0, tiq.readers
    assert_same(jax, port, min_lines=5)


def test_sonde_auto_equals_the_original(tmp_path):
    iq = str(tmp_path / "m10.cf32")
    from sondetpu_torch.cli import main as tcli
    assert tcli.main(["synth", "--sonde", "m10", "--frames", "8",
                      "--out", iq]) == 0
    jax, port = decode_both(["--iq", iq, "--sonde", "auto"], tmp_path)
    lines = assert_same(jax, port, min_lines=2)
    assert json.loads(lines[-1])["type"] == "m10"


def test_wideband_off_grid_equals_the_original(tmp_path):
    """The off-grid rs41 carrier of tests/test_runtime_aux.py (bin 2 +
    3 kHz of 8 bins) through --wideband --bins 8, from the file and with
    --stream."""
    n_bins, fs_chan = 8, 48000.0
    fs_wide = n_bins * fs_chan
    mod = RS41Modulator()
    bits = mod.frames_to_bits(np.stack(
        [mod.build_frame(RS41Truth(frame_no=20 + i)) for i in range(3)]))
    iq = gfsk_modulate(bits, fs_wide / 4800.0, 2400.0 / fs_wide, bt=0.5)
    f_center = 2 * fs_chan + 3000.0
    iq = freq_shift(iq, f_center / fs_wide)
    w = n_bins * 48000
    iq = np.pad(iq, (0, (-iq.size) % w))
    iqf = str(tmp_path / "wide.cf32")
    write_iq(iqf, iq)
    cfg = FrameworkConfig()
    cfg.channel_map = [ChannelConfig(center_freq=f_center, sonde="rs41")]
    cfg.save(str(tmp_path / "cfg.json"))
    argv = ["--iq", iqf, "--wideband", "--bins", str(n_bins), "--config",
            str(tmp_path / "cfg.json")]
    jax, port = decode_both(argv, tmp_path)
    lines = assert_same(jax, port, min_lines=1)
    assert json.loads(lines[-1])["serial"] == "S1234567"
    streamed = decode("port", argv + ["--stream"], str(tmp_path / "stream"))
    assert streamed["jsonl"].decode().splitlines() == lines


def test_eight_channels_on_the_kernel_path_equal_the_original(tmp_path):
    iq = _rs41(tmp_path / "x.cf32", frames=6)
    cfg = _config(tmp_path / "cfg.json", use_pallas=True)
    jax, port = decode_both(["--iq", iq, "--sonde", "rs41", "--channels", "8",
                             "--config", cfg], tmp_path)
    lines = assert_same(jax, port, min_lines=8)
    assert {json.loads(x)["channel"] for x in lines} == set(range(8))


def test_checkpoint_then_resume_equals_the_original(tmp_path):
    """Decode the first blocks with --checkpoint and the rest with
    --resume: the port's JSONL equals the JAX package's, and the port
    resumes from the JAX package's checkpoint to the same lines."""
    whole = _rs41(tmp_path / "whole.cs16", frames=12, fmt="cs16")
    raw = np.fromfile(whole, np.int16)
    cut = 2 * 48000 * 3                   # three blocks of I/Q pairs
    first, rest = str(tmp_path / "a.cs16"), str(tmp_path / "b.cs16")
    raw[:cut].tofile(first)
    raw[cut:].tofile(rest)
    cfg = _config(tmp_path / "cfg.json", afc=True)
    base = ["--sonde", "rs41", "--config", cfg]
    out = {}
    for who in ("jax", "port"):
        ck = str(tmp_path / f"{who}.ckpt")
        a = decode(who, ["--iq", first, "--checkpoint", ck] + base,
                   str(tmp_path / f"{who}_a"))
        b = decode(who, ["--iq", rest, "--resume", ck] + base,
                   str(tmp_path / f"{who}_b"))
        out[who] = (a, b)
    assert_same(out["jax"][0], out["port"][0], min_lines=4)
    lines = assert_same(out["jax"][1], out["port"][1], min_lines=4)
    cross = decode("port", ["--iq", rest, "--resume",
                            str(tmp_path / "jax.ckpt")] + base,
                   str(tmp_path / "cross"))
    assert cross["jsonl"].decode().splitlines() == lines


def test_status_table_watchdog_workers_and_afc_equal_the_original(tmp_path):
    iq = _rs41(tmp_path / "x.cf32", frames=10)
    jax, port = decode_both(["--iq", iq, "--sonde", "rs41", "--channels", "2",
                             "--status", "1", "--table", "2", "--watchdog",
                             "3", "--host-workers", "2", "--afc"], tmp_path)
    assert_same(jax, port, min_lines=10)


def test_trace_writes_a_chrome_trace(tmp_path):
    iq = _rs41(tmp_path / "x.cf32", frames=3)
    trace = tmp_path / "trace"
    out = decode("port", ["--iq", iq, "--sonde", "rs41", "--trace",
                          str(trace)], str(tmp_path / "port"))
    assert out["jsonl"]
    with open(trace / "trace.json") as f:
        assert json.load(f)["traceEvents"]
