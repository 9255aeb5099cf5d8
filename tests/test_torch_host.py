"""The port's host copies equal their JAX-package originals.

sondetpu_torch imports nothing of sondetpu, so it carries copies of the
host modules it needs (sync/coding, dsp/fir design, sondes/base, geo,
modulate, rs41, fec/syndrome matrices, fec gf256/crc/rs/hamming/bch and
the native C++ FEC, telemetry, physics, c64_to_planes, PipelineConfig,
unpack_block_output, Metrics). Each is held here to its original on the
same NumPy inputs.
"""

import dataclasses
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sondetpu import physics as jphysics
from sondetpu import telemetry as jtelemetry
from sondetpu.dsp import fir as jfir
from sondetpu.fec import bch as jbch
from sondetpu.fec import crc as jcrc
from sondetpu.fec import gf256 as jgf256
from sondetpu.fec import hamming as jhamming
from sondetpu.fec import rs as jrs
from sondetpu.fec import syndrome as jsyn
from sondetpu.runtime import metrics as jmetrics
from sondetpu.runtime import pipeline as jpipe
from sondetpu.sondes import geo as jgeo
from sondetpu.sondes import modulate as jmodulate
from sondetpu.sondes import rs41 as jrs41
from sondetpu.sync import coding as jcoding
from sondetpu.io import iq as jiq
from sondetpu.sync import correlator as jcorrelator
from sondetpu_torch import physics as tphysics
from sondetpu_torch import telemetry as ttelemetry
from sondetpu_torch.dsp import fir as tfir
from sondetpu_torch.fec import bch as tbch
from sondetpu_torch.fec import crc as tcrc
from sondetpu_torch.fec import gf256 as tgf256
from sondetpu_torch.fec import hamming as thamming
from sondetpu_torch.fec import native as tnative
from sondetpu_torch.fec import rs as trs
from sondetpu_torch.fec import syndrome as tsyn
from sondetpu_torch.runtime import metrics as tmetrics
from sondetpu_torch.runtime import pipeline as tpipe
from sondetpu_torch.sondes import geo as tgeo
from sondetpu_torch.sondes import modulate as tmodulate
from sondetpu_torch.sondes import rs41 as trs41
from sondetpu_torch.sondes.base import get_sonde
from sondetpu_torch.sync import coding as tcoding
from sondetpu_torch.sync import correlator as tcorrelator
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

SPECS = [(jrs41.SPEC, trs41.SPEC), (jrs41.SPEC_EXT, trs41.SPEC_EXT)]


@pytest.mark.parametrize("jspec,tspec", SPECS, ids=["rs41", "rs41x"])
def test_spec_fields_equal(jspec, tspec):
    for f in dataclasses.fields(jspec):
        if f.name != "extra":
            assert getattr(tspec, f.name) == getattr(jspec, f.name), f.name
    assert sorted(tspec.extra) == sorted(jspec.extra)
    np.testing.assert_array_equal(tspec.extra["whitening"],
                                  jspec.extra["whitening"])
    np.testing.assert_array_equal(tspec.extra["wire_columns"],
                                  jspec.extra["wire_columns"])
    assert tspec.extra["rs"] == jspec.extra["rs"]
    assert tspec.dev == jspec.dev
    assert tspec.chips_per_frame == jspec.chips_per_frame
    np.testing.assert_array_equal(tspec.sync_chip_template(),
                                  jspec.sync_chip_template())
    assert get_sonde(tspec.name)["spec"] is tspec


def test_frame_layout_constants_equal():
    for name in ("WHITENING_MASK", "WIRE_COLUMNS", "WIRE_COLUMNS_EXT"):
        np.testing.assert_array_equal(getattr(trs41, name),
                                      getattr(jrs41, name))
    for name in ("SYNCWORD", "FRAME_BYTES", "FRAME_BYTES_EXT", "DATA_START",
                 "_BLOCK_OFFSETS", "_BLOCK_OFFSETS_EXT"):
        assert getattr(trs41, name) == getattr(jrs41, name), name
    rng = np.random.default_rng(0)
    fr = rng.integers(0, 256, size=(4, 320), dtype=np.uint8)
    np.testing.assert_array_equal(trs41.scramble(fr), jrs41.scramble(fr))
    np.testing.assert_array_equal(tcorrelator.syncword_to_chips(b"\x10\xb6", True),
                                  jcorrelator.syncword_to_chips(b"\x10\xb6", True))


@pytest.mark.parametrize("lsb_first", [False, True])
def test_bit_packing_equal(lsb_first):
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=(3, 40), dtype=np.uint8)
    bits = tcoding.np_bytes_to_bits(data, lsb_first)
    np.testing.assert_array_equal(bits, jcoding.np_bytes_to_bits(data, lsb_first))
    np.testing.assert_array_equal(tcoding.np_bits_to_bytes(bits, lsb_first),
                                  jcoding.np_bits_to_bytes(bits, lsb_first))


@pytest.mark.parametrize("fb,layout", [
    (320, jrs41.SPEC.extra["rs"]), (518, jrs41.SPEC_EXT.extra["rs"])],
    ids=["rs41", "rs41x"])
def test_frame_syndrome_matrix_equal(fb, layout):
    args = (fb, layout["data_start"], layout["parity_start"], layout["nroots"],
            layout["interleave"], layout["fcr"], layout["prim"])
    np.testing.assert_array_equal(tsyn.frame_syndrome_matrix(*args),
                                  jsyn.frame_syndrome_matrix(*args))
    np.testing.assert_array_equal(tsyn.layout_matrix(fb, layout),
                                  jsyn.frame_syndrome_matrix(*args))
    np.testing.assert_array_equal(tsyn.syndrome_matrix(40, 8),
                                  jsyn.syndrome_matrix(40, 8))


def test_filter_design_equal():
    np.testing.assert_array_equal(tfir.design_lowpass(2640.0, 24000.0, 41),
                                  jfir.design_lowpass(2640.0, 24000.0, 41))
    np.testing.assert_array_equal(tfir.gaussian_taps(0.5, 10.0),
                                  jfir.gaussian_taps(0.5, 10.0))
    with pytest.raises(ValueError):
        tfir.design_lowpass(1000.0, 48000.0, 40)


@pytest.mark.parametrize("stride", [1, 2])
def test_apply_windows_matches_jax(stride):
    """The torch streaming FIR equals the JAX package's conv within float
    summation order."""
    rng = np.random.default_rng(2)
    xp = rng.normal(size=(8, 1000 + 40)).astype(np.float32)
    taps = jfir.design_lowpass(5000.0, 48000.0, 41)
    want = np.asarray(jfir._apply_windows(jnp.asarray(xp), jnp.asarray(taps),
                                          stride=stride))
    got = tfir.apply_windows(torch.from_numpy(xp), taps, stride=stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    kern = rng.normal(size=9).astype(np.float32)
    want = np.asarray(jfir._conv1d(jnp.asarray(xp), jnp.asarray(kern), stride))
    got = tfir.conv1d(torch.from_numpy(xp), kern, stride)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def _truths(serial="S1234567", n=3, o3=None):
    return [jrs41.RS41Truth(serial=serial, frame_no=40 + i, o3_mpa=o3)
            for i in range(n)]


@pytest.mark.parametrize("extended", [False, True])
def test_modulator_iq_bit_identical(extended):
    jm = jrs41.RS41XModulator() if extended else jrs41.RS41Modulator()
    tm = trs41.RS41XModulator() if extended else trs41.RS41Modulator()
    truths = _truths(o3=12.5)
    np.testing.assert_array_equal(tm.modulate(truths), jm.modulate(truths))
    np.testing.assert_array_equal(tm.build_frame(truths[0], extended),
                                  jm.build_frame(truths[0], extended))
    iq = jm.modulate(truths)
    np.testing.assert_array_equal(
        tmodulate.add_awgn(iq, 6.0, np.random.default_rng(5)),
        jmodulate.add_awgn(iq, 6.0, np.random.default_rng(5)))
    np.testing.assert_array_equal(tmodulate.freq_shift(iq, 0.01),
                                  jmodulate.freq_shift(iq, 0.01))


def _frag_dicts(frags):
    # repr: NaN fields (PTU before calibration) compare equal as text
    return [(int(ch), repr(dataclasses.asdict(f))) for ch, f in frags]


def test_decoder_telemetry_equal():
    """Both decoders give the same fragments on the same frames, with clean,
    RS-repairable and unrepairable rows, through the byte and chip entry
    points."""
    mod = jrs41.RS41Modulator()
    frames = np.stack([mod.build_frame(t) for t in _truths(n=6, o3=3.25)])
    frames[1, 100] ^= 0x5A                  # repairable
    frames[2, 60:90] ^= 0xFF                # beyond the RS capacity
    chans = np.array([0, 0, 1, 1, 2, 3])
    clean = np.array([True, False, False, True, True, True])
    jd, td = jrs41.RS41Decoder(), trs41.RS41Decoder()
    for kw in ({}, {"rs_clean": clean}):
        want = _frag_dicts(jd.decode_byte_frames(frames, chans, **kw))
        got = _frag_dicts(td.decode_byte_frames(frames, chans, **kw))
        assert got == want
    chips = jcoding.np_bytes_to_bits(jrs41.scramble(frames), lsb_first=True)
    assert (_frag_dicts(td.decode_chip_frames(chips, chans))
            == _frag_dicts(jd.decode_chip_frames(chips, chans)))
    assert len(want) > 0
    x, y, z = jgeo.geodetic_to_ecef(45.0, 9.0, 12000.0)
    for a, b in zip(tgeo.ecef_to_geodetic(x, y, z),
                    jgeo.ecef_to_geodetic(x, y, z)):
        assert a == b
    assert tgeo.utc_to_ymd_sod(1.7e9) == jgeo.utc_to_ymd_sod(1.7e9)


CONFIGS = [
    dict(sonde="rs41", channels=8, block_len=48000, use_pallas=True),
    dict(sonde="rs41", channels=2048, block_len=192000, use_pallas=True,
         input_dtype="i16"),
    dict(sonde="rs41x", channels=16, block_len=96000, use_pallas=True),
    dict(sonde="rs41", channels=8, fs=96000.0, block_len=96000,
         max_frames=5, input_dtype="i8"),
]
PROPS = ["decim", "fs_proc", "sps", "chips_per_block", "chip_cap",
         "frame_chips", "min_frame_chips", "k_slots", "buf_len", "wire_ncols",
         "chase_m", "chase_spans", "chase_total", "packed_row_bytes"]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(
    f"{v}" for v in kw.values()))
def test_pipeline_config_equal(kw):
    jc, tc = jpipe.PipelineConfig(**kw), tpipe.PipelineConfig(**kw)
    for p in PROPS:
        assert getattr(tc, p) == getattr(jc, p), p
    np.testing.assert_array_equal(tc.wire_columns, jc.wire_columns)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


def test_pipeline_config_validation_equal():
    for bad in (dict(input_dtype="u4"), dict(ntaps=40),
                dict(compute_dtype="f16"), dict(block_len=48001)):
        with pytest.raises(ValueError):
            jpipe.PipelineConfig(**bad)
        with pytest.raises(ValueError):
            tpipe.PipelineConfig(**bad)
    for pipe in (jpipe, tpipe):
        with pytest.raises(KeyError, match="unknown sonde type 'rs92'"):
            pipe.PipelineConfig(sonde="rs92")


@pytest.mark.parametrize("chase_m", [0, 3])
def test_unpack_block_output_equal(chase_m):
    rng = np.random.default_rng(4)
    k, fb, c = 3, 11, 5
    row = k * fb + 2 * k + 4 + 2 * k * chase_m
    packed = rng.integers(0, 256, size=c * row, dtype=np.uint8)
    want = jpipe.unpack_block_output(packed, k, fb, chase_m)
    got = tpipe.unpack_block_output(packed, k, fb, chase_m)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_metrics_equal():
    jm = jmetrics.Metrics(channels=4, fs=48000.0)
    tm = tmetrics.Metrics(channels=4, fs=48000.0)
    rms = np.array([0.1, 0.5, 0.9, 0.2], np.float32)
    for m in (jm, tm):
        m.on_block(48000, 0.5, 10, 8, 6, rms)
        m.on_block(48000, 0.25, 4, 4, 2)
    assert tm.to_dict() == jm.to_dict()
    assert tm.status_line() == jm.status_line()


# --- the host copies of fec, telemetry, physics and io ---------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=["native", "numpy"])
def fec_backend(request, monkeypatch):
    """Both packages on their native C++ FEC, or both on NumPy."""
    if request.param == "numpy":
        monkeypatch.setenv("SONDETPU_NO_NATIVE", "1")
        monkeypatch.setattr(tnative, "available", lambda: False)
    else:
        assert tnative.available(), "the port's native FEC did not build"
    return request.param


@pytest.mark.parametrize("n", [1, 7, 64, 318])
def test_crc16_equal(n, fec_backend):
    rng = np.random.default_rng(100 + n)
    data = rng.integers(0, 256, size=(9, n), dtype=np.uint8)
    for init in (0xFFFF, 0x0000, 0x1D0F):
        np.testing.assert_array_equal(tcrc.crc16_ccitt_batch(data, init),
                                      jcrc.crc16_ccitt_batch(data, init))
        for row in data[:3]:
            assert (tcrc.crc16_ccitt(row, init)
                    == jcrc.crc16_ccitt(row, init)
                    == tcrc.crc16_ccitt(bytes(row), init))
    assert tcrc.crc16_ccitt(b"123456789") == 0x29B1


@pytest.mark.parametrize("n", [255, 131])
def test_rs_decode_equal(n, fec_backend):
    """Codewords with 0 to 12 byte errors (RS(255,231) corrects up to 12)
    and some with 13-20: the same corrections, counts and verdicts."""
    rng = np.random.default_rng(n)
    code_t, code_j = trs.ReedSolomon(24), jrs.ReedSolomon(24)
    nerrs = np.concatenate([np.arange(13), np.arange(13), np.arange(13),
                            [13, 14, 16, 20]])
    msg = rng.integers(0, 256, size=(len(nerrs), n - 24))
    cw = code_t.encode(msg)
    np.testing.assert_array_equal(cw, code_j.encode(msg))
    recv = cw.copy()
    for r, k in enumerate(nerrs):
        pos = rng.choice(n, size=k, replace=False)
        recv[r, pos] ^= rng.integers(1, 256, size=k).astype(np.uint8)
    got, want = code_t.decode(recv), code_j.decode(recv)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    fixed = nerrs <= 12
    assert got[2][fixed].all()
    np.testing.assert_array_equal(got[0][fixed], cw[fixed])
    np.testing.assert_array_equal(got[1][fixed], nerrs[fixed])


def test_bch_63_51_equal(fec_backend):
    """BCH(63,51) t=2: the generator, systematic encoding, and decoding of
    words with 0 to 4 bit errors (t = 2 corrects up to 2) and of random
    words: the same corrections, counts and verdicts, on the native decoder
    and on NumPy."""
    tc, jc = tbch.BCH_63_51, jbch.BCH_63_51
    assert (tc.n, tc.k, tc.t) == (jc.n, jc.k, jc.t) == (63, 51, 2)
    np.testing.assert_array_equal(tc.genpoly, jc.genpoly)
    np.testing.assert_array_equal(tc.gf.exp, jc.gf.exp)
    rng = np.random.default_rng(63)
    nerrs = np.repeat(np.arange(5), 12)
    msg = rng.integers(0, 2, size=(nerrs.size, 51), dtype=np.uint8)
    cw = tc.encode(msg)
    np.testing.assert_array_equal(cw, jc.encode(msg))
    recv = cw.copy()
    for r, k in enumerate(nerrs):
        recv[r, rng.choice(63, size=k, replace=False)] ^= 1
    recv = np.concatenate([recv, rng.integers(0, 2, size=(20, 63),
                                              dtype=np.uint8)])
    got, want = tc.decode(recv), jc.decode(recv)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    fixed = np.concatenate([nerrs <= 2, np.zeros(20, bool)])
    assert got[2][fixed].all()
    np.testing.assert_array_equal(got[0][fixed], cw[nerrs <= 2])
    np.testing.assert_array_equal(got[1][fixed], nerrs[nerrs <= 2])


def test_gf256_tables_equal():
    tg, jg = tgf256.GF256(), jgf256.GF256()
    np.testing.assert_array_equal(tg.exp, jg.exp)
    np.testing.assert_array_equal(tg.log, jg.log)
    a, b = np.meshgrid(np.arange(256), np.arange(1, 256))
    np.testing.assert_array_equal(tg.mul(a, b), jg.mul(a, b))
    np.testing.assert_array_equal(tg.div(a, b), jg.div(a, b))


def test_native_fec_source_is_the_original():
    """The port's C++ FEC is the original's code; only the header comment
    differs."""
    def code(path):
        with open(os.path.join(REPO, path)) as f:
            lines = f.read().splitlines()
        while lines[0].startswith("//") or not lines[0]:
            lines.pop(0)
        return lines
    assert (code("sondetpu_torch/csrc/sondefec.cpp")
            == code("sondetpu/native/sondefec.cpp"))


def test_hamming84_equal_over_all_bytes():
    nib = np.arange(16)
    np.testing.assert_array_equal(thamming.hamming84_encode(nib),
                                  jhamming.hamming84_encode(nib))
    cw = np.arange(256, dtype=np.uint8)
    for a, b in zip(thamming.hamming84_decode(cw),
                    jhamming.hamming84_decode(cw)):
        np.testing.assert_array_equal(a, b)


def _fragments(mod, seed):
    rng = np.random.default_rng(seed)
    F = mod.Fields
    frags = []
    for k in range(40):
        flags = F(int(rng.integers(0, 256)))
        frags.append(mod.TelemetryFragment(
            fields=flags, seq=k, lat=float(rng.uniform(-90, 90)),
            lon=float(rng.uniform(-180, 180)),
            alt=float(rng.uniform(-500, 90000)),
            speed=float(rng.uniform(0, 80)), heading=float(rng.uniform(0, 360)),
            climb=float(rng.normal()), time=1.7e9 + k,
            calib_percent=float(rng.choice([50.0, 100.0])),
            temp=float(rng.uniform(-80, 40)), rh=float(rng.uniform(-5, 100)),
            pressure=float(rng.choice([0.0, -1.0, 850.0])),
            serial=f"S{k:07d}", shutdown=int(rng.integers(-1, 9000)),
            o3_mpa=float(rng.uniform(0, 20))))
    return frags


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_telemetry_merge_equal(seed):
    """The same fragments merged into both packages' SondeTelemetry give
    the same to_dict after every merge (compared as repr: NaN dew points
    then compare equal)."""
    tt, jt = ttelemetry.SondeTelemetry(), jtelemetry.SondeTelemetry()
    for ft, fj in zip(_fragments(ttelemetry, seed),
                      _fragments(jtelemetry, seed)):
        assert repr(dataclasses.asdict(ft)) == repr(dataclasses.asdict(fj))
        assert tt.merge(ft) == jt.merge(fj)
        assert repr(tt.to_dict()) == repr(jt.to_dict())
        assert repr(tt.snapshot().to_dict()) == repr(tt.to_dict())
    tt.reset()
    jt.reset()
    assert repr(tt.to_dict()) == repr(jt.to_dict())


def test_telemetry_fields_equal():
    tf, jf = ttelemetry.Fields, jtelemetry.Fields
    assert [(m.name, int(m)) for m in tf] == [(m.name, int(m)) for m in jf]
    assert tf.POS | tf.PTU == jf.POS | jf.PTU     # IntFlags compare as ints
    assert [f.name for f in dataclasses.fields(ttelemetry.SondeTelemetry)] \
        == [f.name for f in dataclasses.fields(jtelemetry.SondeTelemetry)]


@pytest.mark.parametrize("seed", [0, 1])
def test_physics_equal(seed):
    rng = np.random.default_rng(seed)
    for alt in np.concatenate([rng.uniform(-1000, 100000, 200),
                               [0.0, 11000.0, 20000.0, 77000.0, 90000.0]]):
        assert (tphysics.altitude_to_pressure(float(alt))
                == jphysics.altitude_to_pressure(float(alt)))
    for t, rh in zip(rng.uniform(-90, 45, 200), rng.uniform(-10, 100, 200)):
        a = tphysics.dewpt(float(t), float(rh))
        b = jphysics.dewpt(float(t), float(rh))
        assert a == b or (math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("shape", [(7,), (3, 100), (8, 48000)])
def test_c64_to_planes_equal(shape):
    rng = np.random.default_rng(len(shape))
    iq = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)
    got, want = tpipe.c64_to_planes(iq), jiq.c64_to_planes(iq)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.flags.c_contiguous
        np.testing.assert_array_equal(a, b)
