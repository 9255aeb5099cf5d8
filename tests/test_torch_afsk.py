"""The port's AFSK families (imet4, c50) and its last two kernels against
the JAX package: the plain syncword correlation, the AFSK tone kernel
(K8) and its LO tables, the r4 demod+FIR front end (K9), the lane
experiment's FIR (K10), the imet4/c50 pipelines on the kernel path, their
sessions, and an 8-bin fleet with AFSK bins.

On the CPU every wrapper runs its plain torch twin; the JAX Pallas kernels
run in interpret mode (the JAX pipelines take them on their own with
use_pallas=True). Inputs are made from numpy seeds and go to both packages.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sondetpu.dsp.fir import _apply_windows, design_lowpass
from sondetpu.pallas.corr import corr_kernel as jax_corr_kernel
from sondetpu.pallas.frontend import frontend_chunk
from sondetpu.pallas.frontend import fused_afsk_frontend as jax_afsk
from sondetpu.pallas.frontend import fused_demod_fir as jax_demod_fir
from sondetpu.runtime import pipeline as jpipe
from sondetpu.runtime.fleet import FleetChannel as JaxChannel
from sondetpu.runtime.fleet import FleetSession as JaxFleet
from sondetpu.runtime.session import DecoderSession as JaxSession
from sondetpu.sondes import c50 as jc50
from sondetpu.sondes import imet4 as jimet4
from sondetpu.sondes import m10 as jm10
from sondetpu.sync import correlator as jcorrelator
from sondetpu_torch.dsp.fir import conv1d
from sondetpu_torch.kernels import cuda
from sondetpu_torch.kernels.afsk import (HALO, afsk_tables,
                                         fused_afsk_frontend,
                                         fused_afsk_frontend_plain)
from sondetpu_torch.kernels.corr import corr_kernel, corr_plain
from sondetpu_torch.kernels.frontend import fused_demod_fir
from sondetpu_torch.kernels.lane_fir import lane_fir, lane_fir_plain
from sondetpu_torch.runtime import pipeline as tpipe
from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession
from sondetpu_torch.runtime.session import DecoderSession
from sondetpu_torch.sondes import c50 as tc50
from sondetpu_torch.sondes import imet4 as timet4
from sondetpu_torch.sondes.modulate import afsk_modulate, freq_shift
from sondetpu_torch.sync import correlator as tcorrelator
from sondetpu_torch.sync.coding import np_bytes_to_bits
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

T = torch.from_numpy
CPU = torch.device("cpu")
C, BLOCK, FS = 8, 48000, 48000.0
# family -> (win, mark/fs, space/fs): one symbol of boxcar, Bell-202 and
# C50 tones at 48 kHz
AFSK = {"imet4": (40, 1200.0 / FS, 2200.0 / FS),
        "c50": (20, 2400.0 / FS, 4800.0 / FS)}


# --- the plain correlation ---------------------------------------------------

def _templates():
    m10 = jm10.SPEC.sync_chip_template()
    spec = jimet4.SPEC
    imet = [spec.sync_chip_template()] + [
        spec.sync_chip_template(bits=np.asarray(b))
        for b in spec.extra["alt_sync_bits"]]
    return [("m10", m10)] + [(f"imet4-{k}", t) for k, t in enumerate(imet)]


@pytest.mark.parametrize("name,tmpl", _templates(),
                         ids=[n for n, _ in _templates()])
def test_correlate_syncword_divides_by_l(name, tmpl):
    """+/-1 chips, so every window sum is an exact integer: the port's
    plain correlation equals JAX correlate_syncword exactly (m10's L = 80,
    imet4's three L = 20 templates). For m10 a multiply by float32(1/L)
    rounds some of them differently; for L = 20 the sums that do (18, 13,
    9) are rare on random chips, so the next test builds them."""
    rng = np.random.default_rng(len(tmpl) + int(tmpl[:8].sum()))
    chips = (rng.integers(0, 2, size=(8, 1921)) * 2 - 1).astype(np.float32)
    want = np.asarray(jcorrelator.correlate_syncword(jnp.asarray(chips),
                                                     tmpl))
    got = tcorrelator.correlate_syncword(T(chips), tmpl).numpy()
    np.testing.assert_array_equal(got, want)
    if name == "m10":
        sums = conv1d(T(chips), tmpl).numpy()
        assert np.any(sums * np.float32(1.0 / len(tmpl)) != want)


def test_correlate_syncword_rounds_window_sums_18_13_9():
    """A hand-built buffer whose L = 20 window sums are 18, 13 and 9: each
    comes out as float32(s) / 20, the JAX value (not s * float32(1/20))."""
    tmpl = jimet4.SPEC.sync_chip_template()
    wins = []
    for flip, zero in ((1, 0), (3, 1), (5, 1)):       # 20-2, 20-6-1, 20-10-1
        w = tmpl.copy()
        w[:flip] *= -1
        w[flip:flip + zero] = 0.0
        wins.append(w)
    buf = np.concatenate(wins)[None, :].astype(np.float32)
    got = tcorrelator.correlate_syncword(T(buf), tmpl).numpy()[0, ::20]
    want = np.float32([18, 13, 9]) / np.float32(20)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jcorrelator.correlate_syncword(jnp.asarray(buf),
                                                       tmpl))[0, ::20])
    assert np.all(np.float32([18, 13, 9]) * np.float32(1 / 20) != want)


@pytest.mark.parametrize("L", [20, 80])
def test_corr_plain_keeps_the_kernel_scaling(L):
    """K2's twin still multiplies by float32(1/L), as the Pallas correlator
    does: equal to it in interpret mode and to corr_kernel's CPU route."""
    rng = np.random.default_rng(L)
    buf = rng.normal(size=(8, 2048)).astype(np.float32)
    tmpl = (rng.integers(0, 2, size=L) * 2 - 1).astype(np.float32)
    want = np.asarray(jax_corr_kernel(jnp.asarray(buf), jnp.asarray(tmpl[None]),
                                      interpret=True))
    got = corr_plain(T(buf), T(tmpl)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(corr_kernel(T(buf), T(tmpl)).numpy(), got)


# --- K8: the AFSK tone kernel --------------------------------------------------

def _afsk_inputs(seed, c=C, n=BLOCK):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(c, n)).astype(np.float32),
            rng.normal(size=(c, HALO)).astype(np.float32))


@pytest.mark.parametrize("family", ["imet4", "c50"])
def test_afsk_twin_matches_pallas(family):
    """K8's twin against the Pallas kernel in interpret mode at 8 x 48000:
    soft within 1e-6 (the same operations in the same order), the new audio
    tail exact."""
    win, fm, fsp = AFSK[family]
    audio, atail = _afsk_inputs(win)
    want = jax_afsk(jnp.asarray(audio), jnp.asarray(atail), win=win,
                    chunk=frontend_chunk(BLOCK), fmark_over_fs=fm,
                    fspace_over_fs=fsp, interpret=True)
    tabs = [T(t) for t in afsk_tables(BLOCK, fm, fsp)]
    got = fused_afsk_frontend(T(audio), T(atail), tabs, win)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("family", ["imet4", "c50"])
def test_afsk_tables_equal_the_pallas_chunk_tables(family):
    """Every position of the Pallas kernel's per-chunk LO windows
    (frontend.py:702-713, chunks of frontend_chunk(48000)) holds the value
    afsk_tables has for that position."""
    _, fm, fsp = AFSK[family]
    tabs = afsk_tables(BLOCK, fm, fsp)
    chunk = frontend_chunk(BLOCK)
    pos = np.arange(-HALO, chunk, dtype=np.int64)
    for jc in range(-(-BLOCK // chunk)):
        g = jc * chunk + pos
        keep = g < BLOCK
        p = g % BLOCK
        for k, fof in enumerate((fm, fsp)):
            frac = np.mod(p.astype(np.float64) * float(fof), 1.0)
            for trig, tab in ((np.cos, tabs[2 * k]), (np.sin, tabs[2 * k + 1])):
                want = trig(2.0 * np.pi * frac).astype(np.float32)
                np.testing.assert_array_equal(tab[HALO + g[keep]], want[keep])


def test_afsk_stream_continuity():
    """Two blocks with the carried audio tail equal one call over both,
    given the block-periodic tables the L | n gate guarantees."""
    win, fm, fsp = AFSK["imet4"]
    n = 4800
    audio, atail = (T(x) for x in _afsk_inputs(3, C, 2 * n))
    tabs = [T(t) for t in afsk_tables(n, fm, fsp)]
    long_tabs = [torch.cat([t, t[HALO:]]) for t in tabs]
    whole = fused_afsk_frontend_plain(audio, atail, long_tabs, win)
    a = fused_afsk_frontend_plain(audio[:, :n], atail, tabs, win)
    b = fused_afsk_frontend_plain(audio[:, n:], a[1], tabs, win)
    assert torch.equal(torch.cat([a[0], b[0]], -1), whole[0])
    assert torch.equal(b[1], whole[1])
    with pytest.raises(ValueError, match="LO tables"):
        fused_afsk_frontend_plain(audio, atail, tabs, win)


# --- K9 and K10 ----------------------------------------------------------------

# (rows, block, taps): the shapes of tests/test_pallas.py (8 x 4800, 41
# taps), the run-time body's tap count on a block no tile of the kernel
# divides, one row, and a block of T - 1 samples; each with and without the
# DC. The first shape keeps its ids "True" and "False".
_DEMOD_CASES = [
    pytest.param(8, 4800, 41, dc, id=label + str(dc))
    for label, (c, n, t) in (("", (8, 4800, 41)),) for dc in (True, False)
] + [
    pytest.param(c, n, t, dc, id=f"{label}-{dc}")
    for label, (c, n, t) in (("t33-ragged", (8, 2 * 5376 + 7, 33)),
                             ("one-row", (1, 3000, 41)),
                             ("n-t-minus-1", (8, 40, 41)))
    for dc in (True, False)]


@pytest.mark.parametrize("rows,n,ntaps,dc_block", _DEMOD_CASES)
def test_demod_fir_twin_matches_pallas(rows, n, ntaps, dc_block):
    """K9's twin against the Pallas kernel in interpret mode: filtered
    audio and tail within 2e-5 on audio of magnitude ~10 (the two round
    the DC sum in their own order). The Pallas kernel takes rows in groups
    of 8: one row goes to it as the first of 8."""
    rng = np.random.default_rng(n + ntaps)
    i, q = (rng.normal(size=(8, n)).astype(np.float32) for _ in range(2))
    prev = rng.normal(size=(8, 2)).astype(np.float32)
    atail = rng.normal(size=(8, ntaps - 1)).astype(np.float32)
    taps = design_lowpass(2640.0, FS, ntaps)
    scale = np.float32(FS / (2 * np.pi * 2400.0))
    want = jax_demod_fir(jnp.asarray(i), jnp.asarray(q), jnp.asarray(prev),
                         jnp.asarray(atail), jnp.asarray(taps[None]),
                         jnp.asarray([[scale]]), ntaps=ntaps,
                         dc_block=dc_block, interpret=True)
    got = fused_demod_fir(T(i[:rows]), T(q[:rows]), T(prev[:rows]),
                          T(atail[:rows]), taps, float(scale), dc_block)
    assert got[0].shape == (rows, n) and got[1].shape == (rows, ntaps - 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:rows], rtol=0,
                                   atol=2e-5)


def test_lane_fir_twin_is_the_experiment_formula():
    """K10's twin equals a NumPy loop of y[m] = sum_t x[m+t] h[t] (t
    ascending, the first product not added to zero) exactly, and JAX
    _apply_windows for the experiment's symmetric taps within 1e-5."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(6, 3000 + 40)).astype(np.float32)
    h = design_lowpass(0.1, 1.0, 41)
    n = x.shape[1] - 40
    want = x[:, 0:n] * h[0]
    for t in range(1, 41):
        want = want + x[:, t:t + n] * h[t]
    got = lane_fir(T(x), h).numpy()
    np.testing.assert_array_equal(got, want)
    conv = np.asarray(_apply_windows(jnp.asarray(x), jnp.asarray(h)))
    np.testing.assert_allclose(got, conv, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="shorter"):
        lane_fir_plain(T(x[:, :30]), h)


@pytest.mark.parametrize("ntaps", [1, 64])
def test_lane_fir_twin_edge_taps(ntaps):
    """K10's twin at the kernel's tap limits (one tap, 64 taps) equals the
    NumPy loop bit for bit, the sign of a zero included: tap 0's product is
    not added to zero, so -0.0 * h0 stays -0.0 where no later tap adds."""
    rng = np.random.default_rng(8 + ntaps)
    x = rng.normal(size=(3, 2001 + ntaps - 1)).astype(np.float32)
    x[:, ::4] = 0.0
    x[:, 1::8] = -0.0
    h = rng.normal(size=ntaps).astype(np.float32)
    n = x.shape[1] - ntaps + 1
    want = x[:, 0:n] * h[0]
    for t in range(1, ntaps):
        want = want + x[:, t:t + n] * h[t]
    got = lane_fir(T(x), h).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if ntaps == 1:
        assert np.signbit(got[x[:, :n] == 0]).any()


# --- the pipelines on the kernel path ------------------------------------------

def _truths(family, k, count):
    if family == "imet4":
        return [timet4.IMET4Truth(frame_no=1 + j, lat=40.0 + k,
                                  temp=-58.0 + k) for j in range(count)]
    return [tc50.C50Truth(serial_num=12345 + k, frame_no=1 + j,
                          lat=46.8 + k) for j in range(count)]


def _afsk_planes(family, n_blocks, seed=0, noise=0.04):
    """int16 (i, q) [C, n_blocks * BLOCK]: channel ch carries truth set
    ch % 3 with its own offset into the stream and its own noise."""
    n = n_blocks * BLOCK
    mod = timet4.IMET4Modulator() if family == "imet4" else tc50.C50Modulator()
    per = 20800 if family == "imet4" else 10080     # samples per truth
    rows = []
    for k in range(3):
        iq = mod.modulate(_truths(family, k, n // per + 2))[37 * k:37 * k + n]
        rng = np.random.default_rng(seed + k)
        iq = iq + noise * (rng.normal(size=n) + 1j * rng.normal(size=n))
        rows.append((np.clip(iq.real * 32767, -32768, 32767).astype(np.int16),
                     np.clip(iq.imag * 32767, -32768, 32767).astype(np.int16)))
    return (np.stack([rows[ch % 3][0] for ch in range(C)]),
            np.stack([rows[ch % 3][1] for ch in range(C)]))


def _config(family, **kw):
    return {**dict(sonde=family, channels=C, block_len=BLOCK, use_pallas=True,
                   compute_dtype="f32", input_dtype="i16"), **kw}


@pytest.mark.parametrize("family", ["imet4", "c50"])
def test_afsk_pipeline_matches_jax(family):
    """3 blocks at C = 8 on the kernel path: validity, valid-slot bytes and
    the packed buffer's valid rows equal the JAX use_pallas=True pipeline
    (its _pallas_afsk path); the carried audio tail within 1e-5 of JAX's;
    the sessions' telemetry is identical."""
    qi, qq = _afsk_planes(family, 3)
    jsess = JaxSession(jpipe.PipelineConfig(**_config(family)))
    jp = jsess.pipeline            # one compiled step for both comparisons
    tp = tpipe.Pipeline(tpipe.PipelineConfig(**_config(family)), CPU)
    assert jp._pallas_afsk and tp._afsk
    cfg = tp.config
    js, ts = jp.init_state(), tp.init_state()
    assert [a.shape for a in ts.aux] == [np.asarray(a).shape for a in js.aux]
    frames = 0
    for b in range(3):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        js, jo = jp.step(js, (qi[:, sl], qq[:, sl]))
        ts, to = tp.step(ts, (qi[:, sl], qq[:, sl]))
        jv = np.asarray(jo.frame_valid)
        tv = to.frame_valid.numpy()
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(to.frames.numpy()[tv],
                                      np.asarray(jo.frames)[jv])
        np.testing.assert_allclose(ts.aux[0].numpy(), np.asarray(js.aux[0]),
                                   rtol=0, atol=1e-5)
        tu = tpipe.unpack_block_output(to.packed.numpy(), cfg.k_slots,
                                       cfg.wire_ncols)
        ju = jpipe.unpack_block_output(np.asarray(jo.packed), cfg.k_slots,
                                       cfg.wire_ncols)
        np.testing.assert_array_equal(tu[0][tv], ju[0][jv])
        np.testing.assert_array_equal(tu[1], ju[1])
        frames += int(jv.sum())
    assert frames >= C * 4
    tsess = DecoderSession(tpipe.PipelineConfig(**_config(family)), CPU)
    for b in range(3):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        jsess.process_block((qi[:, sl], qq[:, sl]))
        tsess.process_block((qi[:, sl], qq[:, sl]))
    assert sorted(tsess.telemetry) == sorted(jsess.telemetry) == list(range(C))
    for ch in range(C):
        assert (json.dumps(tsess.telemetry[ch].to_dict(), sort_keys=True)
                == json.dumps(jsess.telemetry[ch].to_dict(), sort_keys=True))
    t = tsess.telemetry[0]
    if family == "imet4":
        assert t.serial == "" and t.lat == pytest.approx(40.0, abs=1e-5)
        assert t.temp == pytest.approx(-58.0, abs=0.01)
        assert t.aux_data.startswith("O3=")
        assert tsess.telemetry[1].lat == pytest.approx(41.0, abs=1e-5)
    else:
        assert t.serial == "C50-12345"
        assert tsess.telemetry[2].serial == "C50-12347"
    assert (tsess.metrics.frames_decoded == jsess.metrics.frames_decoded
            > 0)


def test_afsk_gate_refuses_blocks_the_tone_period_does_not_divide():
    """imet4's tones repeat every L = 240 samples; with use_pallas=True a
    48040-sample block (whole symbols, L does not divide it) fails the
    AFSK kernel's gate, and both packages' sessions run the jnp AFSK front
    end: 3 blocks, per block validity and valid-slot bytes equal and the
    LO phase counter equal; then identical telemetry."""
    block = 48040
    kw = _config("imet4", block_len=block)
    jsess = JaxSession(jpipe.PipelineConfig(**kw))
    tsess = DecoderSession(tpipe.PipelineConfig(**kw), CPU)
    jp, tp = jsess.pipeline, tsess.pipeline
    assert not jp._pallas_afsk and tp._route is None and tp._afsk
    recs = ([], [])
    for pipe, rec in zip((jp, tp), recs):
        def wrapped(state, iq, step=pipe.step, rec=rec):
            state, out = step(state, iq)     # copied at once: JAX donates
            rec.append([np.array(np.asarray(x)) for x in
                        (out.frame_valid, out.frames, state.aux[4])])
            return state, out
        pipe.step = wrapped
    qi, qq = _afsk_planes("imet4", 4)
    for b in range(3):
        sl = slice(b * block, (b + 1) * block)
        jsess.process_block((qi[:, sl], qq[:, sl]))
        tsess.process_block((qi[:, sl], qq[:, sl]))
    assert len(recs[0]) == len(recs[1]) == 3
    frames = 0
    for b, ((jv, jf, jn), (tv, tf, tn)) in enumerate(zip(*recs)):
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf[jv], jf[jv])
        np.testing.assert_array_equal(tn, jn)
        assert int(tn[0]) == (b + 1) * block % 240
        frames += int(jv.sum())
    assert frames >= C * 4
    assert ({ch: json.dumps(t.to_dict(), sort_keys=True)
             for ch, t in tsess.telemetry.items()}
            == {ch: json.dumps(t.to_dict(), sort_keys=True)
                for ch, t in jsess.telemetry.items()})
    assert sorted(tsess.telemetry) == list(range(C))


# --- the fleet with AFSK bins ---------------------------------------------------

N_BINS = 8
FS_WIDE = N_BINS * FS


def _afsk_wideband(centers):
    """imet4 in bin 2 and c50 in bin 5 of an 8-bin stream, modulated at the
    wideband rate, 3 blocks of one second."""
    mod = timet4.IMET4Modulator()
    packets = []
    for t in _truths("imet4", 0, 7):
        packets += [mod.build_ptu(t), mod.build_gps(t), mod.build_xdata(t)]
    sig = [freq_shift(afsk_modulate(
        mod.packets_to_bits(packets), FS_WIDE / 1200.0, 1200.0, 2200.0,
        FS_WIDE, deviation_norm=3000.0 / FS_WIDE), centers[2] / FS_WIDE)]
    cmod = tc50.C50Modulator()
    frames = np.concatenate([cmod.build_frame(t)
                             for t in _truths("c50", 1, 15)])
    sig.append(freq_shift(afsk_modulate(
        np_bytes_to_bits(frames[None]).reshape(-1), FS_WIDE / 2400.0, 2400.0,
        4800.0, FS_WIDE, deviation_norm=3000.0 / FS_WIDE),
        centers[5] / FS_WIDE))
    w = N_BINS * int(FS)
    wide = np.zeros(3 * w, np.complex64)
    for s in sig:
        wide[:min(s.size, wide.size)] += s[:wide.size]
    return wide, w


def test_fleet_with_afsk_bins_matches_jax_fleet():
    """An 8-bin fleet with one imet4 and one c50 bin: the same updates and
    telemetry per logical channel as the JAX FleetSession(use_pallas=True),
    block by block."""
    plan = ((2, "imet4"), (5, "c50"))
    port = FleetSession([FleetChannel(b, s) for b, s in plan], N_BINS, "cpu")
    wide, w = _afsk_wideband(port.pfb.center_freqs(FS_WIDE))
    jfleet = JaxFleet([JaxChannel(b, s) for b, s in plan], N_BINS,
                      use_pallas=True)
    assert all(sess.pipeline._pallas_afsk
               for _, sess in jfleet.groups.values())
    assert all(sess.pipeline._afsk for _, sess in port.groups.values())
    for i in range(0, wide.size, w):
        assert port.process_wideband(wide[i:i + w]) == \
            jfleet.process_wideband(wide[i:i + w])
        assert ({k: json.dumps(t.to_dict(), sort_keys=True)
                 for k, t in port.telemetry.items()}
                == {k: json.dumps(t.to_dict(), sort_keys=True)
                    for k, t in jfleet.telemetry.items()})
    telem = port.telemetry
    assert set(telem) == {0, 1}
    assert telem[0].lat == pytest.approx(40.0, abs=1e-5)
    assert telem[1].serial == "C50-12346"


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs these on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("family", ["imet4", "c50"])
def test_cuda_afsk_matches_twin(cuda_device, family):
    win, fm, fsp = AFSK[family]
    audio, atail = (T(x).to(cuda_device) for x in _afsk_inputs(5, 16))
    tabs = [T(t).to(cuda_device) for t in afsk_tables(BLOCK, fm, fsp)]
    before = cuda.launches["fused_afsk_frontend"]
    got = fused_afsk_frontend(audio, atail, tabs, win)
    want = fused_afsk_frontend_plain(audio, atail, tabs, win)
    assert cuda.launches["fused_afsk_frontend"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name,tmpl", _templates(),
                         ids=[n for n, _ in _templates()])
def test_cuda_correlate_syncword_divides_by_l(cuda_device, name, tmpl):
    """On the card the plain correlation also divides by L: on +/-1 chips
    each output is the window sum s over L correctly rounded (float64
    division rounded to float32), and equals the CPU's, not
    s * float32(1/L)."""
    rng = np.random.default_rng(len(tmpl))
    chips = (rng.integers(0, 2, size=(64, 9600)) * 2 - 1).astype(np.float32)
    got = tcorrelator.correlate_syncword(T(chips).to(cuda_device), tmpl).cpu()
    want = (conv1d(T(chips), tmpl).double() / len(tmpl)).float()
    assert torch.equal(got, want)
    assert torch.equal(got, tcorrelator.correlate_syncword(T(chips), tmpl))
