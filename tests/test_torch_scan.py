"""The port's spectrum scan (sondetpu_torch/dsp/scan.py) against the JAX
package's (sondetpu/dsp/scan.py), on the same planes.

Tolerances: the PSD is one float32 FFT here and the original's mixed-radix
einsum DFT there, which round differently (about 1e-6 relative), so the
PSDs agree within 1e-5 of max(psd) and a carrier's power-weighted centre
within 1 Hz (its SNR within 0.01 dB). The fixtures' carriers stand clear of
the detection threshold, so the runs of bins, and with them every
carrier's bandwidth and power rank, are the same. Classification decodes
frames, whose counts are equal exactly.
"""

import json

import numpy as np
import pytest

from sondetpu.cli import main as jcli
from sondetpu.dsp import scan as jscan
from sondetpu_torch.cli import main as tcli
from sondetpu_torch.dsp import scan as tscan
from sondetpu_torch.io.iq import write_iq
from sondetpu_torch.sondes.imet4 import IMET4Modulator, IMET4Truth
from sondetpu_torch.sondes.m10 import M10Modulator, M10Truth
from sondetpu_torch.sondes.modulate import freq_shift, gfsk_modulate
from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

FS_WIDE = 8 * 48000.0


def _tone(n, f_norm, amp=1.0):
    return (amp * np.exp(2j * np.pi * f_norm * np.arange(n))
            ).astype(np.complex64)


def _noise(n, rng, amp=0.05):
    return (amp * (rng.normal(size=n) + 1j * rng.normal(size=n))
            ).astype(np.complex64)


def _planes(x):
    return (np.ascontiguousarray(x.real.astype(np.float32)),
            np.ascontiguousarray(x.imag.astype(np.float32)))


def _fm_noise(n, rng, f_center, dev_hz):
    """A wide FM emission (a random walk of the instantaneous frequency
    within +/-dev_hz) at f_center: a carrier whose spectrum spans a few
    kHz, so near +/-fs/2 it straddles the wrap."""
    f = np.clip(np.cumsum(rng.normal(size=n)) * 40.0, -dev_hz, dev_hz)
    ph = 2 * np.pi * np.cumsum(f_center + f) / FS_WIDE
    return np.exp(1j * ph).astype(np.complex64)


def _rs41(f_center, n, first=40, frames=12):
    mod = RS41Modulator()
    bits = mod.frames_to_bits(np.stack(
        [mod.build_frame(RS41Truth(frame_no=first + i))
         for i in range(frames)]))
    sig = freq_shift(gfsk_modulate(bits, FS_WIDE / 4800.0, 2400.0 / FS_WIDE),
                     f_center / FS_WIDE)
    return np.pad(sig[:n], (0, max(0, n - sig.size)))


def _m10(f_center, n):
    mod = M10Modulator()
    chips = mod.frames_to_chips(np.stack(
        [mod.build_frame(M10Truth(frame_no=8 + i)) for i in range(24)]))
    sig = freq_shift(
        gfsk_modulate(chips, FS_WIDE / 9600.0, 12000.0 / FS_WIDE, bt=0.7),
        f_center / FS_WIDE)
    return np.pad(sig[:n], (0, max(0, n - sig.size)))


def _imet4(f_center, n):
    sig = IMET4Modulator().modulate(
        [IMET4Truth(frame_no=20 + i) for i in range(40)], fs=FS_WIDE)
    sig = freq_shift(sig, f_center / FS_WIDE)
    return np.pad(sig[:n], (0, max(0, n - sig.size)))


@pytest.mark.parametrize("nfft", [1024, 4096])
def test_welch_psd_equals_the_original(nfft):
    rng = np.random.default_rng(0)
    n = 1 << 16
    x = _tone(n, 0.1) + 0.3 * _tone(n, -0.27) + _noise(n, rng)
    jb, jp = jscan.welch_psd(*_planes(x), nfft=nfft)
    tb, tp = tscan.welch_psd(*_planes(x), nfft=nfft, device="cpu")
    assert tp.dtype == np.float32 and tp.shape == (nfft,)
    np.testing.assert_array_equal(tb, jb)
    assert np.max(np.abs(tp - jp)) <= 1e-5 * np.max(jp)


def _carrier_fields(cars):
    return [(c.bw_hz, c.sonde, c.frames, c.scores) for c in cars]


def _assert_same_carriers(port, jax):
    """Same carriers in the same (power) order: bandwidth and the other
    fields equal, centre within 1 Hz, SNR within 0.01 dB, power within the
    PSD's tolerance."""
    assert len(port) == len(jax) > 0
    assert _carrier_fields(port) == _carrier_fields(jax)
    for p, j in zip(port, jax):
        assert abs(p.center_hz - j.center_hz) < 1.0
        assert abs(p.snr_db - j.snr_db) < 0.01
        assert p.power == pytest.approx(j.power, rel=1e-4)


def _edge_pair(rng, n):
    """Two distinct tones near opposite Nyquist edges (7 kHz apart across
    the fold): two carriers, not merged (tests/test_scan.py:161)."""
    return (_tone(n, (FS_WIDE / 2 - 3500.0) / FS_WIDE)
            + 0.7 * _tone(n, (-FS_WIDE / 2 + 3500.0) / FS_WIDE)
            + _noise(n, rng))


def _edge_wrap(rng, n):
    """One wide emission centred on +fs/2 and a weaker tone: the emission's
    runs on both edges of the shifted PSD merge into ONE carrier."""
    return (_fm_noise(n, rng, FS_WIDE / 2, 3000.0)
            + 0.5 * _tone(n, 60000.0 / FS_WIDE) + _noise(n, rng))


def _two_tones(rng, n):
    return (_tone(n, 60000.0 / FS_WIDE) + 0.6 * _tone(n, -130000.0 / FS_WIDE)
            + _noise(n, rng))


@pytest.mark.parametrize("case, want", [(_two_tones, 2), (_edge_pair, 2),
                                        (_edge_wrap, 2)])
@pytest.mark.parametrize("form", ["complex", "planes"])
def test_detect_carriers_equals_the_original(case, want, form):
    rng = np.random.default_rng(7)
    x = case(rng, 1 << 18)
    port_in = x if form == "complex" else _planes(x)
    jax = jscan.detect_carriers(x, FS_WIDE, min_bw_hz=0.0)
    port = tscan.detect_carriers(port_in, FS_WIDE, min_bw_hz=0.0,
                                 device="cpu")
    assert len(jax) == want
    _assert_same_carriers(port, jax)
    if case is _edge_wrap:
        # the wrap merge: one carrier at +/-fs/2, wider than either edge run
        edge = min(jax, key=lambda c: abs(abs(c.center_hz) - FS_WIDE / 2))
        assert abs(abs(edge.center_hz) - FS_WIDE / 2) < 2000.0


def test_detect_carriers_pure_noise_finds_nothing():
    rng = np.random.default_rng(1)
    x = _noise(1 << 18, rng)
    assert tscan.detect_carriers(x, FS_WIDE, device="cpu") == []
    assert jscan.detect_carriers(x, FS_WIDE) == []


def _mixed(n):
    """rs41 at bin 1 + 2 kHz, m10 at bin -2 + 3 kHz, imet4 at bin 3 + 2 kHz
    of 8 bins, in noise."""
    rng = np.random.default_rng(2)
    return (_rs41(50000.0, n) + _m10(-93000.0, n) + _imet4(146000.0, n)
            + _noise(n, rng, 0.02))


@pytest.fixture(scope="module")
def classified():
    """Detection and classification of the mixed capture by both
    packages: (jax carriers, port carriers)."""
    wide = _mixed(3 * 8 * 48000)
    fams = ["rs41", "m10", "imet4", "dfm"]
    jcars = jscan.classify_carriers(
        wide, FS_WIDE, jscan.detect_carriers(wide, FS_WIDE), families=fams)
    tcars = tscan.classify_carriers(
        _planes(wide), FS_WIDE,
        tscan.detect_carriers(_planes(wide), FS_WIDE, device="cpu"),
        families=fams, device="cpu")
    return jcars, tcars


def test_classify_carriers_equals_the_original(classified):
    jcars, tcars = classified
    _assert_same_carriers(tcars, jcars)
    got = {c.sonde: c for c in tcars}
    assert set(got) == {"rs41", "m10", "imet4"}
    for sonde, f in (("rs41", 50000.0), ("m10", -93000.0),
                     ("imet4", 146000.0)):
        assert abs(got[sonde].center_hz - f) < 1500.0
        assert got[sonde].frames >= 1
        assert "dfm" not in got[sonde].scores


def test_scan_to_config_equals_the_original(classified):
    jcars, tcars = classified
    jcfg = jscan.scan_to_config(jcars, fs_wide=FS_WIDE).to_dict()
    tcfg = tscan.scan_to_config(tcars, fs_wide=FS_WIDE).to_dict()
    for a, b in zip(tcfg["channel_map"], jcfg["channel_map"]):
        assert abs(a.pop("center_freq") - b.pop("center_freq")) < 1.0
    assert tcfg == jcfg
    assert tcfg["wide_bins"] == 8 and tcfg["wideband"]


def test_classify_refuses_what_the_original_refuses():
    car = [tscan.Carrier(0.0, 5000.0, 10.0)]
    with pytest.raises(ValueError, match="integer multiple"):
        tscan.classify_carriers(np.zeros(1000, np.complex64), 100000.0, car,
                                device="cpu")
    with pytest.raises(ValueError, match="too short"):
        tscan.classify_carriers(np.zeros(1000, np.complex64), FS_WIDE, car,
                                device="cpu")
    with pytest.raises(ValueError, match="nfft"):
        tscan.welch_psd(np.zeros(100, np.float32), np.zeros(100, np.float32),
                        device="cpu")
    assert tscan.classify_carriers(np.zeros(10, np.complex64), FS_WIDE, [],
                                   device="cpu") == []


def test_cli_scan_writes_the_original_channel_map(tmp_path, capsys):
    """``scan --out`` of one capture: the carrier list on stdout and the
    channel map equal the JAX CLI's (the list rounds to 0.1)."""
    wide = _mixed(2 * 8 * 48000)
    path = str(tmp_path / "wide.cf32")
    write_iq(path, wide)
    out = {}
    for name, cli, extra in (("jax", jcli, []),
                             ("port", tcli, ["--device", "cpu"])):
        cfg = str(tmp_path / f"{name}.json")
        assert cli.main(["scan", "--iq", path, "--fs-wide", str(FS_WIDE),
                         "--families", "rs41,m10,imet4", "--probe-secs",
                         "2", "--out", cfg] + extra) == 0
        listed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        with open(cfg) as f:
            out[name] = (listed, json.load(f))
    (jlist, jcfg), (tlist, tcfg) = out["jax"], out["port"]
    assert [{k: v for k, v in c.items() if k != "center_hz"} for c in tlist] \
        == [{k: v for k, v in c.items() if k != "center_hz"} for c in jlist]
    for t, j in zip(tlist, jlist):
        assert abs(t["center_hz"] - j["center_hz"]) <= 1.0
    for a, b in zip(tcfg["channel_map"], jcfg["channel_map"]):
        assert abs(a.pop("center_freq") - b.pop("center_freq")) < 1.0
    assert tcfg == jcfg
    assert sorted(e["sonde"] for e in tcfg["channel_map"]) \
        == ["imet4", "m10", "rs41"]


def test_cli_scan_without_a_card_stops(tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    path = str(tmp_path / "wide.cf32")
    write_iq(path, np.zeros(8192, np.complex64))
    assert tcli.main(["scan", "--iq", path, "--fs-wide", str(FS_WIDE)]) == 2
    assert "no CUDA device" in capsys.readouterr().err
