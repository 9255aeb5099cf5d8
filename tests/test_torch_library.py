"""The port's public DSP, timing, coding and physics API against the JAX
package's, on the same seeded NumPy inputs (8-16 channels, a few thousand
samples).

Limits: the coding functions and ``symbol_sample``'s ``valid`` are integer
or boolean results and must be equal exactly. Every float result is held
by ``assert_close``: the largest difference at most ``rel`` times the
largest magnitude of the JAX result, with ``rel`` < 1, so an all-zero
output always fails. The sums of the port run in a fixed order and XLA's
in its own (and XLA on the CPU fuses some multiply-adds), so float results
part by a few float32 ulps of their scale: 1e-5 holds the FIR, the
demodulators, the AGC and the resamplers, 2e-5 the AFSK discriminator
(cos and sin of phases up to ~4e3 rad round differently in the two
libraries) and the float32 physics (pow, exp and log). ``symbol_sample``
forms the next block's phase as ``start + n_fit*sps - n`` in float32, so
one ulp of ``start`` can move it by one ulp of ``n`` (2.4e-4 at 3000
samples): its phase is held within two ulps of n, and the next block's
soft samples, which move by the signal's slope times that, within 2e-4
of their scale. Within the port,
chunked ``fir_apply`` and ``fm_apply`` equal the unchunked functions
exactly (``torch.equal``). A JAX state taken to NumPy after k chunks
continues in the port as it does in JAX, within the same limits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sondetpu.dsp as jdsp
import sondetpu.physics as jphys
import sondetpu.sync as jsync
from sondetpu.dsp import agc as jagc
from sondetpu.dsp.resample import make_rational_resampler
import sondetpu_torch.dsp as tdsp
import sondetpu_torch.physics as tphys
import sondetpu_torch.sync as tsync
from sondetpu_torch.dsp import agc as tagc
from sondetpu_torch.runtime import pipeline as tpipe
from sondetpu_torch.sync import timing as ttiming
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

CPU = torch.device("cpu")


def assert_close(got, want, rel):
    """max|got - want| <= rel * max|want|, rel < 1 (a zero output fails)."""
    assert 0 < rel < 1
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.max(np.abs(want)))
    assert scale > 0
    err = float(np.max(np.abs(got.astype(want.dtype) - want)))
    assert err <= rel * scale, (err, rel * scale)


def t(a):
    return torch.from_numpy(np.array(a))


def nrz_signal(bits, sps, tau=0.0):
    """tests/test_sync.py's matched-filtered NRZ (triangular eye)."""
    x = np.repeat(bits.astype(np.float32) * 2 - 1, sps)
    x = np.convolve(x, np.ones(sps, np.float32) / sps)[: x.size]
    if tau:
        idx = np.arange(x.size - 1)
        x = x[idx] * (1 - tau) + x[idx + 1] * tau
    return x.astype(np.float32)


# ---------------------------------------------------------------- coding


@pytest.mark.parametrize("lsb_first", [False, True])
def test_bit_byte_round_trip_equals_jax(lsb_first):
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=(3, 4, 17), dtype=np.uint8)
    bits = tsync.bytes_to_bits(t(data), lsb_first=lsb_first)
    want = np.asarray(jsync.bytes_to_bits(jnp.asarray(data),
                                          lsb_first=lsb_first))
    assert bits.dtype == torch.uint8
    np.testing.assert_array_equal(bits.numpy(), want)
    back = tsync.bits_to_bytes(bits, lsb_first=lsb_first)
    np.testing.assert_array_equal(back.numpy(), data)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jsync.bits_to_bytes(jnp.asarray(want), lsb_first=lsb_first)))


@pytest.mark.parametrize("with_prev", [False, True])
def test_nrzs_decode_equals_jax(with_prev):
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, size=(16, 2560), dtype=np.uint8)
    prev = rng.integers(0, 2, size=16, dtype=np.uint8) if with_prev else None
    got = tsync.nrzs_decode(t(bits), None if prev is None else t(prev))
    want = jsync.nrzs_decode(jnp.asarray(bits),
                             None if prev is None else jnp.asarray(prev))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mask_len", [1, 64, 333])
def test_descramble_xor_equals_jax(mask_len):
    rng = np.random.default_rng(7)
    mask = rng.integers(0, 256, size=mask_len, dtype=np.uint8)
    data = rng.integers(0, 256, size=(2, 8, 320), dtype=np.uint8)
    got = tsync.descramble_xor(t(data), mask)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsync.descramble_xor(jnp.asarray(data), mask)))
    np.testing.assert_array_equal(tsync.descramble_xor(got, mask).numpy(),
                                  data)


# ---------------------------------------------------------------- FIR


@pytest.mark.parametrize("ntaps,dtype", [(21, "f32"), (41, "f32"),
                                         (41, "bf16"), (1, "f32")])
def test_fir_filter_equals_jax(ntaps, dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 3000)).astype(np.float32)
    taps = (jdsp.design_lowpass(0.2, 1.0, ntaps) if ntaps > 1
            else np.array([0.75], np.float32))
    xt, xj = t(x), jnp.asarray(x)
    if dtype == "bf16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    got = tdsp.fir_filter(xt, taps)
    assert got.dtype == torch.float32
    assert_close(got, jdsp.fir_filter(xj, jnp.asarray(taps)), 1e-5)
    if dtype == "f32":
        want = np.stack([np.convolve(r, taps)[:3000] for r in x])
        assert_close(got, want, 1e-5)


def test_fir_complex_filters_each_plane():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(8, 2048)) + 1j * rng.normal(size=(8, 2048))
         ).astype(np.complex64)
    taps = jdsp.design_lowpass(0.25, 1.0, 21)
    got = tdsp.fir_filter(t(x), taps)
    assert got.dtype == torch.complex64
    want = np.asarray(jdsp.fir_filter(jnp.asarray(x), jnp.asarray(taps)))
    assert_close(got.real, want.real, 1e-5)
    assert_close(got.imag, want.imag, 1e-5)


@pytest.mark.parametrize("block", [50, 100, 150, 300, 600])
@pytest.mark.parametrize("complex_in", [False, True])
def test_fir_apply_chunked_equals_unchunked(block, complex_in):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 600)).astype(np.float32)
    if complex_in:
        x = (x + 1j * rng.normal(size=x.shape)).astype(np.complex64)
    taps = tdsp.design_lowpass(0.15, 1.0, 41)
    full = tdsp.fir_filter(t(x), taps)
    st = tdsp.fir_init(8, 41, dtype=t(x).dtype, device=CPU)
    outs = []
    for i in range(0, 600, block):
        st, y = tdsp.fir_apply(st, t(x[:, i:i + block]), taps)
        outs.append(y)
    assert torch.equal(torch.cat(outs, dim=1), full)
    assert st.tail.dtype == t(x).dtype and st.tail.shape == (8, 40)


@pytest.mark.parametrize("complex_in", [False, True])
def test_fir_jax_state_carries_into_the_port(complex_in):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 1200)).astype(np.float32)
    if complex_in:
        x = (x + 1j * rng.normal(size=x.shape)).astype(np.complex64)
    taps = jdsp.design_lowpass(0.15, 1.0, 41)
    st = jdsp.fir_init(8, 41, dtype=jnp.asarray(x).dtype)
    for i in range(0, 800, 200):
        st, _ = jdsp.fir_apply(st, jnp.asarray(x[:, i:i + 200]), taps)
    tst = tdsp.FIRState(tail=t(np.asarray(st.tail)))
    for i in range(800, 1200, 200):
        st, yj = jdsp.fir_apply(st, jnp.asarray(x[:, i:i + 200]), taps)
        tst, yt = tdsp.fir_apply(tst, t(x[:, i:i + 200]), taps)
        yj = np.asarray(yj)
        assert_close(yt.real, yj.real, 1e-5)
        if complex_in:
            assert_close(yt.imag, yj.imag, 1e-5)


def test_boxcar_taps_equal_the_original():
    from sondetpu.dsp.fir import boxcar_taps as jbox
    from sondetpu_torch.dsp.fir import boxcar_taps as tbox

    for sps in (1, 5, 10, 20, 40):
        np.testing.assert_array_equal(tbox(sps), jbox(sps))


# ---------------------------------------------------------------- demod


def fm_signal(rng, c=8, n=3000):
    phase = np.cumsum(rng.normal(size=(c, n)) * 0.3, axis=1)
    amp = 1.0 + 0.1 * rng.normal(size=(c, n))
    return (amp * np.exp(1j * phase)).astype(np.complex64)


def test_fm_demod_recovers_tone_as_jax():
    fs, dev = 48000.0, 2400.0
    tt = np.arange(4800) / fs
    iq = np.tile(np.exp(2j * np.pi * dev * tt).astype(np.complex64), (8, 1))
    got = tdsp.fm_demod(t(iq), fs, dev)
    np.testing.assert_allclose(got[:, 10:].numpy(), 1.0, atol=1e-3)
    assert_close(got, jdsp.fm_demod(jnp.asarray(iq), fs, dev), 1e-5)


def test_fm_demod_equals_jax():
    iq = fm_signal(np.random.default_rng(4))
    got = tdsp.fm_demod(t(iq), 48000.0, 2400.0)
    assert got.dtype == torch.float32
    assert_close(got, jdsp.fm_demod(jnp.asarray(iq), 48000.0, 2400.0), 1e-5)


@pytest.mark.parametrize("block", [250, 1000, 1500])
def test_fm_apply_chunked_equals_unchunked(block):
    iq = fm_signal(np.random.default_rng(5))
    full = tdsp.fm_demod(t(iq), 48000.0, 2400.0)
    st = tdsp.fm_init(8, device=CPU)
    outs = []
    for i in range(0, 3000, block):
        st, y = tdsp.fm_apply(st, t(iq[:, i:i + block]), 48000.0, 2400.0)
        outs.append(y)
    assert torch.equal(torch.cat(outs, dim=1), full)
    assert st.prev.dtype == torch.complex64


def test_fm_jax_state_carries_into_the_port():
    iq = fm_signal(np.random.default_rng(6))
    st = jdsp.fm_init(8)
    for i in range(0, 1500, 500):
        st, _ = jdsp.fm_apply(st, jnp.asarray(iq[:, i:i + 500]), 48000.0,
                              2400.0)
    tst = tdsp.FMState(prev=t(np.asarray(st.prev)))
    assert tst.prev.dtype == torch.complex64
    assert torch.count_nonzero(tst.prev.imag) > 0
    for i in range(1500, 3000, 500):
        st, yj = jdsp.fm_apply(st, jnp.asarray(iq[:, i:i + 500]), 48000.0,
                               2400.0)
        tst, yt = tdsp.fm_apply(tst, t(iq[:, i:i + 500]), 48000.0, 2400.0)
        assert_close(yt, yj, 1e-5)


@pytest.mark.parametrize("tones", [(1200.0, 2200.0, 1200.0),
                                   (2400.0, 4800.0, 2400.0)])
def test_afsk_discriminate_equals_jax(tones):
    f_mark, f_space, baud = tones
    fs = 48000.0
    rng = np.random.default_rng(7)
    n_sym = 400
    sym = rng.integers(0, 2, size=(8, n_sym))
    sps = int(fs / baud)
    f = np.where(np.repeat(sym, sps, axis=1) > 0, f_mark, f_space)
    audio = (np.sin(2 * np.pi * np.cumsum(f, axis=1) / fs)
             + 0.05 * rng.normal(size=f.shape)).astype(np.float32)
    got = tdsp.afsk_discriminate(t(audio), fs, f_mark, f_space, baud)
    want = np.asarray(jdsp.afsk_discriminate(jnp.asarray(audio), fs, f_mark,
                                             f_space, baud))
    assert_close(got, want, 2e-5)
    # the sign at each symbol's end is its tone
    ends = np.arange(1, n_sym) * sps - 1
    np.testing.assert_array_equal(got.numpy()[:, ends] > 0,
                                  sym[:, :n_sym - 1] > 0)


# ---------------------------------------------------------------- AGC


def test_agc_tracks_level_as_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 1000)).astype(np.float32)
    sj, st = jagc.agc_init(8), tagc.agc_init(8, device=CPU)
    for k in range(60):
        level = 5.0 if k < 40 else 0.2          # attack, then decay
        sj, yi, yq, gj = jagc.agc_apply(sj, jnp.asarray(x * level),
                                        jnp.asarray(x * level))
        st, ti, tq, gt = tagc.agc_apply(st, t(x * level), t(x * level))
        assert_close(gt, gj, 1e-5)
        assert_close(st.env, sj.env, 1e-5)
    assert_close(ti, yi, 1e-5)
    assert_close(tq, yq, 1e-5)
    rms = float(np.sqrt(np.mean(ti.numpy() ** 2 + tq.numpy() ** 2)))
    assert rms == pytest.approx(
        float(np.sqrt(np.mean(np.asarray(yi) ** 2 + np.asarray(yq) ** 2))),
        rel=1e-5)


def test_agc_jax_state_carries_into_the_port():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 1000)).astype(np.float32) * 3.0
    sj = jagc.agc_init(8)
    for _ in range(5):
        sj, *_ = jagc.agc_apply(sj, jnp.asarray(x), jnp.asarray(x))
    st = tagc.AGCState(env=t(np.asarray(sj.env)))
    for _ in range(5):
        sj, yi, _, gj = jagc.agc_apply(sj, jnp.asarray(x), jnp.asarray(x))
        st, ti, _, gt = tagc.agc_apply(st, t(x), t(x))
        assert_close(gt, gj, 1e-5)
        assert_close(ti, yi, 1e-5)


# ---------------------------------------------------------------- resample


@pytest.mark.parametrize("factor", [2, 5])
@pytest.mark.parametrize("complex_in", [False, True])
def test_polyphase_decimate_equals_jax(factor, complex_in):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(8, 4800)).astype(np.float32)
    if complex_in:
        x = (x + 1j * rng.normal(size=x.shape)).astype(np.complex64)
    got = tdsp.polyphase_decimate(t(x), factor, fs=48000.0)
    want = np.asarray(jdsp.polyphase_decimate(jnp.asarray(x), factor,
                                              fs=48000.0))
    assert got.shape == (8, 4800 // factor)
    assert_close(got.real, want.real, 1e-5)
    if complex_in:
        assert_close(got.imag, want.imag, 1e-5)


def test_polyphase_decimate_keeps_the_tone():
    fs = 48000.0
    x = np.cos(2 * np.pi * 1000.0 * np.arange(4800) / fs
               ).astype(np.float32)[None, :]
    y = tdsp.polyphase_decimate(t(x), 5, fs=fs).numpy()
    spec = np.abs(np.fft.rfft(y[0, 100:900]))
    assert abs(np.fft.rfftfreq(800, d=5 / fs)[np.argmax(spec)] - 1000.0) < 30


@pytest.mark.parametrize("rates", [(20000.0, 48000.0), (48000.0, 50000.0),
                                   (50000.0, 48000.0)])
@pytest.mark.parametrize("complex_in", [False, True])
def test_rational_resample_equals_jax(rates, complex_in):
    up, down, taps = make_rational_resampler(*rates)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(8, 2400)).astype(np.float32)
    if complex_in:
        x = (x + 1j * rng.normal(size=x.shape)).astype(np.complex64)
    got = tdsp.rational_resample(t(x), up, down, taps)
    want = np.asarray(jdsp.rational_resample(jnp.asarray(x), up, down, taps))
    assert got.shape == (8, 2400 * up // down)
    assert_close(got.real, want.real, 1e-5)
    if complex_in:
        assert_close(got.imag, want.imag, 1e-5)


# ---------------------------------------------------------------- timing


def test_oerder_meyr_tau_takes_the_original_signature():
    """Called as the original is, (x, sps): the tables are built on x's
    device."""
    rng = np.random.default_rng(0)
    x = np.stack([nrz_signal(rng.integers(0, 2, size=600), 10)[s:s + 4000]
                  for s in range(0, 16)])
    got = tsync.oerder_meyr_tau(t(x), 10)
    want = np.asarray(jsync.oerder_meyr_tau(jnp.asarray(x), 10))
    err = (got.numpy() - want + 5.0) % 10.0 - 5.0     # wrap-aware
    assert np.max(np.abs(err)) <= 1e-4 * 10.0, err
    assert np.ptp(want) > 1.0                          # the shifts show


def test_pipeline_passes_its_cached_tables(monkeypatch):
    """The pipeline's timing call keeps passing the tables it built once,
    so the step builds none."""
    from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth

    pipe = tpipe.Pipeline(tpipe.PipelineConfig(sonde="rs41", channels=8,
                                               block_len=48000), CPU)
    built, seen = [], []

    def no_tables(*a, **k):
        built.append(a)
        raise AssertionError("spectral_line_tables called by the step")

    def spy(x, sps, cos_w=None, sin_w=None):
        seen.append((cos_w is pipe._cos_w, sin_w is pipe._sin_w))
        return ttiming.oerder_meyr_tau(x, sps, cos_w, sin_w)

    monkeypatch.setattr(ttiming, "spectral_line_tables", no_tables)
    monkeypatch.setattr(tpipe, "spectral_line_tables", no_tables)
    monkeypatch.setattr(tpipe, "oerder_meyr_tau", spy)
    iq = RS41Modulator().modulate([RS41Truth(frame_no=i) for i in range(3)],
                                  fs=48000.0)[:48000]
    pipe.step(pipe.init_state(), np.tile(iq[None, :], (8, 1)))
    assert seen == [(True, True)] and not built


def assert_timing_close(st, sj, soft_t, soft_j, valid_t, valid_j, n):
    """valid exactly; the carried phase within two ulps of n, the soft
    samples within 2e-4 of their scale (see the module's docstring)."""
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    assert valid_t.numpy().any()
    assert_close(soft_t, soft_j, 2e-4)
    lim = 2 * float(np.spacing(np.float32(n)))
    assert np.max(np.abs(st.pos.numpy() - np.asarray(sj.pos))) <= lim
    np.testing.assert_array_equal(st.locked.numpy(), np.asarray(sj.locked))


def test_symbol_sample_recovers_bits_over_chunks_as_jax():
    rng = np.random.default_rng(1)
    sps, block = 10, 3000
    bits = rng.integers(0, 2, size=1200)
    x = np.tile(nrz_signal(bits, sps)[None, :], (8, 1))
    x = (x + rng.normal(scale=0.1, size=x.shape)).astype(np.float32)
    cap = block // sps + 2
    sj, st = jsync.timing_init(8), tsync.timing_init(8, device=CPU)
    got = []
    for i in range(0, x.shape[1] - block + 1, block):
        sj, soft_j, valid_j = jsync.symbol_sample(
            sj, jnp.asarray(x[:, i:i + block]), sps, cap)
        st, soft_t, valid_t = tsync.symbol_sample(
            st, t(x[:, i:i + block]), sps, cap)
        assert_timing_close(st, sj, soft_t, soft_j, valid_t, valid_j, block)
        got.append(soft_t[0].numpy()[valid_t[0].numpy()])
    sliced = (np.concatenate(got) > 0).astype(np.uint8)
    best = max((sliced[lag:lag + m] == bits[:m]).mean()
               for lag in range(4) for m in [min(sliced.size - lag, bits.size)])
    assert best > 0.995, best


def test_symbol_sample_jax_state_carries_into_the_port():
    rng = np.random.default_rng(2)
    sps, block = 5, 2000
    x = np.stack([nrz_signal(rng.integers(0, 2, size=2000), sps, tau=0.1 * c)
                  [:8000] for c in range(8)])
    x = (x + rng.normal(scale=0.05, size=x.shape)).astype(np.float32)
    cap = block // sps + 2
    sj = jsync.timing_init(8)
    for i in (0, block):
        sj, _, _ = jsync.symbol_sample(sj, jnp.asarray(x[:, i:i + block]),
                                       sps, cap)
    st = tsync.TimingState(pos=t(np.asarray(sj.pos)),
                           locked=t(np.asarray(sj.locked)))
    for i in (2 * block, 3 * block):
        sj, soft_j, valid_j = jsync.symbol_sample(
            sj, jnp.asarray(x[:, i:i + block]), sps, cap)
        st, soft_t, valid_t = tsync.symbol_sample(st, t(x[:, i:i + block]),
                                                  sps, cap)
        assert_timing_close(st, sj, soft_t, soft_j, valid_t, valid_j, block)


@pytest.mark.parametrize("sps,tau", [(10, 0.3), (5, 0.7)])
def test_gardner_scan_recovers_bits_as_jax(sps, tau):
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, size=500)
    x = np.tile(nrz_signal(bits, sps, tau=tau)[None, :], (8, 1))
    x = (x + rng.normal(scale=0.05, size=x.shape)).astype(np.float32)
    n_sym = 520                       # past the stream: the tail is invalid
    soft_t, valid_t = tsync.gardner_scan(t(x), float(sps), n_sym)
    soft_j, valid_j = jsync.gardner_scan(jnp.asarray(x), float(sps), n_sym)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    assert not valid_t.numpy().all()
    assert_close(soft_t, soft_j, 1e-5)
    sliced = (soft_t[0].numpy() > 0).astype(np.uint8)[:480]
    accs = [(sliced[:480] == bits[lag:lag + 480]).mean() for lag in range(3)]
    assert max(accs) > 0.98, accs


# ---------------------------------------------------------------- physics


def test_isa_layers_equal_jax():
    alts = np.array([-50.0, 0.0, 5000.0, 11000.0, 25000.0, 40000.0, 47000.0,
                     51000.0, 60000.0, 77000.0, 80000.0, 95000.0])
    got = tphys.altitude_to_pressure_torch(alts, device=CPU)
    assert got.dtype == torch.float32
    assert_close(got, jphys.altitude_to_pressure_jnp(alts), 2e-5)
    want = np.array([tphys.altitude_to_pressure(a) for a in alts])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    rng = np.random.default_rng(4)
    a = rng.uniform(-500.0, 90000.0, size=(16, 64)).astype(np.float32)
    assert_close(tphys.altitude_to_pressure_torch(t(a)),
                 jphys.altitude_to_pressure_jnp(jnp.asarray(a)), 2e-5)


def test_dewpt_equals_jax():
    rng = np.random.default_rng(5)
    temp = rng.uniform(-60.0, 40.0, size=(16, 64)).astype(np.float32)
    rh = rng.uniform(1.0, 100.0, size=(16, 64)).astype(np.float32)
    got = tphys.dewpt_torch(t(temp), t(rh))
    assert_close(got, jphys.dewpt_jnp(jnp.asarray(temp), jnp.asarray(rh)),
                 2e-5)
    one = tphys.dewpt_torch(20.0, 60.0, device=CPU)
    assert float(one) == pytest.approx(tphys.dewpt(20.0, 60.0), rel=1e-3)
    assert float(one) == pytest.approx(float(jphys.dewpt_jnp(20.0, 60.0)),
                                       rel=2e-5)
    assert torch.isnan(tphys.dewpt_torch(t(temp[:1, :1]), t(np.zeros(
        (1, 1), np.float32)))).all()


def test_the_original_physics_names_resolve():
    assert tphys.dewpt_jnp is tphys.dewpt_torch
    assert tphys.altitude_to_pressure_jnp is tphys.altitude_to_pressure_torch
