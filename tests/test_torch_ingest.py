"""The port's IQ ingest and resampler against the JAX package's.

Every source of ``sondetpu_torch/io/iq.py`` (whole-file reads, the block
framers, the streaming reader with float and raw integer planes) yields
exactly the samples or planes of its original, for cf32, cs16, cs8 and
wav, through the native C++ helpers and through NumPy (the port builds its
own helpers from ``csrc/``; the original loads its prebuilt ones). The
device resampler is held to the JAX one over three blocks within
``max|y_port - y_jax| <= 1e-6 * max|y_jax|``: both sum each output over the
same taps in the same order, but XLA may fuse a product into its sum (one
rounding instead of two), which moves an output by an ulp or so of the
running sum; 1e-6 of the peak is ~8 float32 ulps of it.
"""

import wave

import numpy as np
import pytest
import torch

from sondetpu.dsp import resample as jresample
from sondetpu.io import iq as jiq
from sondetpu_torch.dsp import resample as tresample
from sondetpu_torch.io import iq as tiq
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

CPU = torch.device("cpu")
N = 12345                       # complex samples: no block size divides it
BLOCK = 4096


def _signal(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return (0.6 * (rng.normal(size=n) + 1j * rng.normal(size=n))
            ).clip(-0.99 - 0.99j, 0.99 + 0.99j).astype(np.complex64)


def _write_wav(path, iq, width):
    """A 2-channel (I, Q) wav of ``width`` bytes per sample."""
    if width == 2:
        inter = np.empty(2 * iq.size, np.int16)
        inter[0::2] = np.round(iq.real * 32767)
        inter[1::2] = np.round(iq.imag * 32767)
    else:
        inter = np.empty(2 * iq.size, np.uint8)
        inter[0::2] = np.round(iq.real * 127 + 127.5)
        inter[1::2] = np.round(iq.imag * 127 + 127.5)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(width)
        w.setframerate(48000)
        w.writeframes(inter.tobytes())


@pytest.fixture
def files(tmp_path):
    iq = _signal()
    out = {}
    for fmt in ("cf32", "cs16", "cs8"):
        out[fmt] = str(tmp_path / f"x.{fmt}")
        jiq.write_iq(out[fmt], iq, fmt)
    out["wav"] = str(tmp_path / "x.wav")
    _write_wav(out["wav"], iq, 2)
    out["wav8"] = str(tmp_path / "x8.wav")
    _write_wav(out["wav8"], iq, 1)
    return out


@pytest.fixture(params=["native", "numpy"])
def reader(request, monkeypatch):
    """Both packages on their native helpers, or both on NumPy."""
    if request.param == "numpy":
        for mod in (jiq, tiq):
            monkeypatch.setattr(mod, "_native", False)
            monkeypatch.setattr(mod, "_iqstream", False)
    else:
        assert tiq._load_native() and tiq._load_iqstream(), \
            "the port's native IQ helpers did not build"
        assert jiq._load_native() and jiq._load_iqstream()
    tiq.reset_readers()
    yield request.param
    # the int-plane split has no native helper in either package
    ran = {k.split(":")[0] for k in tiq.readers
           if k != "numpy:interleaved_to_int_planes"}
    assert ran <= {request.param}, tiq.readers


def _eq(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", ["cf32", "cs16", "cs8", "wav", "wav8"])
def test_iq_from_file_equal(files, reader, fmt):
    path = files[fmt]
    for count in (None, 1000):
        _eq(tiq.iq_from_file(path, count=count),
            jiq.iq_from_file(path, count=count))
    if fmt.startswith("wav"):
        return
    _eq(tiq.iq_from_file(path, fmt), jiq.iq_from_file(path, fmt))


@pytest.mark.parametrize("fmt", ["cf32", "cs16", "cs8", "wav"])
def test_file_sources_equal(files, reader, fmt):
    path = files[fmt]
    got = list(tiq.IQFileSource(path, BLOCK).blocks())
    want = list(jiq.IQFileSource(path, BLOCK).blocks())
    assert [v for _, v in got] == [v for _, v in want]
    for (a, _), (b, _) in zip(got, want):
        _eq(a, b)
        for pa, pb in zip(tiq.c64_to_planes(a), jiq.c64_to_planes(b)):
            _eq(pa, pb)
    if fmt in ("cs16", "cs8"):
        got = list(tiq.IntIQFileSource(path, BLOCK).blocks())
        want = list(jiq.IntIQFileSource(path, BLOCK).blocks())
        assert len(got) == len(want) == -(-N // BLOCK)
        for a, b in zip(got, want):
            _eq(a[0], b[0])
            _eq(a[1], b[1])
            assert a[2] == b[2]


@pytest.mark.parametrize("fmt", ["cf32", "cs16", "cs8"])
@pytest.mark.parametrize("raw", [False, True], ids=["planes", "raw"])
def test_streaming_source_equal(files, reader, fmt, raw):
    if raw and fmt == "cf32":
        with pytest.raises(ValueError):
            tiq.StreamingIQSource(files[fmt], BLOCK, raw_planes=True)
        return
    got = list(tiq.StreamingIQSource(files[fmt], BLOCK,
                                     raw_planes=raw).blocks())
    want = list(jiq.StreamingIQSource(files[fmt], BLOCK,
                                      raw_planes=raw).blocks())
    assert len(got) == len(want) == -(-N // BLOCK)
    for a, b in zip(got, want):
        _eq(a[0], b[0])
        _eq(a[1], b[1])
        assert a[2] == b[2]
    kind = "native:iqs_read" + ("_raw" if raw else "") \
        if reader == "native" else "numpy:stream" + ("_raw" if raw else "")
    assert tiq.readers.get(kind) == len(got), tiq.readers


@pytest.mark.parametrize("fmt", ["cf32", "cs16", "cs8"])
def test_stream_equals_file_across_a_boundary_and_a_truncation(
        files, reader, fmt, tmp_path):
    """The streaming reader's planes equal the file source's across block
    boundaries, and on a file cut mid-sample."""
    for path in (files[fmt], str(tmp_path / f"cut.{fmt}")):
        if "cut" in path:
            raw = open(files[fmt], "rb").read()
            open(path, "wb").write(raw[:len(raw) - 2 * BLOCK - 3])
        stream = list(tiq.StreamingIQSource(path, BLOCK).blocks())
        blocks = list(tiq.IQFileSource(path, BLOCK).blocks())
        assert len(stream) == len(blocks) >= 2
        for (pi, pq, n), (b, v) in zip(stream, blocks):
            assert n == v
            bi, bq = tiq.c64_to_planes(b)
            _eq(pi, bi)
            _eq(pq, bq)


def test_no_native_switch_takes_numpy(files, monkeypatch):
    """SONDETPU_NO_NATIVE=1 takes the NumPy reader, as in the original."""
    monkeypatch.setenv("SONDETPU_NO_NATIVE", "1")
    monkeypatch.setattr(tiq, "_native", None)
    monkeypatch.setattr(tiq, "_iqstream", None)
    tiq.reset_readers()
    list(tiq.StreamingIQSource(files["cs16"], BLOCK).blocks())
    tiq.iq_from_file(files["cs16"])
    assert set(tiq.readers) == {"numpy:stream", "numpy:convert_to_c64"}


# --- the resampler -------------------------------------------------------------

def _device_input(rng, n, dtype):
    x = rng.normal(scale=0.3, size=(2, n))
    if dtype == "f32":
        return x.astype(np.float32)
    scale = 32767 if dtype == "i16" else 127
    return np.clip(np.round(x * scale), -scale - 1, scale).astype(
        np.int16 if dtype == "i16" else np.int8)


@pytest.mark.parametrize("dtype", ["f32", "i16", "i8"])
@pytest.mark.parametrize("fs_in,fs_out,out_len", [(50000.0, 48000.0, 4800),
                                                  (2048000.0, 384000.0, 7680)])
def test_device_resampler_matches_jax(dtype, fs_in, fs_out, out_len):
    t = tresample.DeviceStreamingResampler(fs_in, fs_out, out_len, CPU,
                                           input_dtype=dtype)
    j = jresample.DeviceStreamingResampler(fs_in, fs_out, out_len,
                                           input_dtype=dtype)
    assert (t.up, t.down, t.nph, t.in_len) == (j.up, j.down, j.nph, j.in_len)
    rng = np.random.default_rng(2)
    ts, js = t.init_state(), j.init_state()
    for _ in range(3):
        x = _device_input(rng, t.in_len, dtype)
        ts, ti, tq = t(ts, x[0], x[1])
        js, ji, jq = j(js, x[0].copy(), x[1].copy())
        for a, b in ((ti, ji), (tq, jq)):
            b = np.asarray(b)
            assert a.dtype == torch.float32 and tuple(a.shape) == (out_len,)
            err = float(np.max(np.abs(a.numpy() - b)))
            assert err <= 1e-6 * float(np.max(np.abs(b))), err
        for a, b in zip(ts, js):
            _eq(a.numpy(), np.asarray(b))


def test_device_resampler_chunked_equals_unchunked():
    """Three blocks through the carried history equal one block three
    times as long, bit for bit (each output's sum has the same terms in
    the same order)."""
    short = tresample.DeviceStreamingResampler(50000.0, 48000.0, 4800, CPU)
    long = tresample.DeviceStreamingResampler(50000.0, 48000.0, 14400, CPU)
    x = _device_input(np.random.default_rng(3), 3 * short.in_len, "f32")
    st = short.init_state()
    parts = []
    for k in range(3):
        sl = slice(k * short.in_len, (k + 1) * short.in_len)
        st, yi, yq = short(st, x[0, sl], x[1, sl])
        parts.append((yi, yq))
    _, yi, yq = long(long.init_state(), x[0], x[1])
    assert torch.equal(torch.cat([p[0] for p in parts]), yi)
    assert torch.equal(torch.cat([p[1] for p in parts]), yq)
    host = tresample.StreamingResampler(50000.0, 48000.0, channels=2)
    np.testing.assert_allclose(host.process(x), np.stack([yi, yq]),
                               atol=1e-5)


def test_device_resampler_rejects_unaligned_blocks():
    for out_len in (1000, 4801):
        for mod, args in ((tresample, (CPU,)), (jresample, ())):
            with pytest.raises(ValueError):
                mod.DeviceStreamingResampler(50000.0, 48000.0, out_len,
                                             *args)
    rs = tresample.DeviceStreamingResampler(50000.0, 48000.0, 4800, CPU)
    with pytest.raises(ValueError):
        rs(rs.init_state(), np.zeros(4999, np.float32),
           np.zeros(4999, np.float32))
