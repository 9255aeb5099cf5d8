"""The port's m10, dfm, ims100 and mrzn1 families against the JAX package:
the dual-tone front end, line decoding, frame gather, rational-sps
sampling, the host copies of the families, their pipelines on the kernel
path (ims100 and mrzn1 on K7's channel-filter body with midpoint DC, with
and without AFC), the FM-discriminator fallback of a dual-tone family, and
the session's hand-off of the Chase weak bits.

On the CPU every wrapper runs its plain torch twin; the JAX Pallas kernels
run in interpret mode (the JAX pipelines take them on their own with
use_pallas=True, as tests/test_sonde_families.py runs them). Inputs are made
from numpy seeds and go to both packages.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sondetpu.dsp.fir import design_lowpass
from sondetpu.pallas.frontend import frontend_chunk
from sondetpu.pallas.frontend import fused_dualtone_frontend as jax_dualtone
from sondetpu.runtime import pipeline as jpipe
from sondetpu.runtime.session import DecoderSession as JaxSession
from sondetpu.sondes import c50 as jc50
from sondetpu.sondes import dfm as jdfm
from sondetpu.sondes import imet4 as jimet4
from sondetpu.sondes import ims100 as jims100
from sondetpu.sondes import m10 as jm10
from sondetpu.sondes import mrzn1 as jmrzn1
from sondetpu.sync import coding as jcoding
from sondetpu.sync import correlator as jcorrelator
from sondetpu_torch.kernels.dualtone import (HALO, dualtone_body,
                                             fused_dualtone_frontend,
                                             fused_dualtone_plain,
                                             mixer_tables)
from sondetpu_torch.runtime import pipeline as tpipe
from sondetpu_torch.runtime.session import DecoderSession
from sondetpu_torch.sondes import c50 as tc50
from sondetpu_torch.sondes import dfm as tdfm
from sondetpu_torch.sondes import imet4 as timet4
from sondetpu_torch.sondes import ims100 as tims100
from sondetpu_torch.sondes import m10 as tm10
from sondetpu_torch.sondes import mrzn1 as tmrzn1
from sondetpu_torch.sondes.base import get_sonde
from sondetpu_torch.sync import coding as tcoding
from sondetpu_torch.sync import correlator as tcorrelator
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

T = torch.from_numpy
CPU = torch.device("cpu")
C, BLOCK = 8, 48000
FS, DEV = 48000.0, 12000.0     # m10: 12 kHz deviation, one-chip boxcar of 5


def _dualtone_inputs(seed, c=8, n=48000):
    rng = np.random.default_rng(seed)
    x = [rng.normal(size=(c, n)).astype(np.float32) for _ in range(2)]
    t = [rng.normal(size=(c, HALO)).astype(np.float32) for _ in range(2)]
    return x + t


@pytest.mark.parametrize("want_afc", [False, True])
@pytest.mark.parametrize("skip_chanfilt", [True, False])
def test_dualtone_twin_matches_pallas(skip_chanfilt, want_afc):
    """K7's twin against the Pallas kernel at 8 x 48000 with m10's
    parameters: metric atol 1e-5 (XLA and torch round the chanfilt sums
    differently), dc and rotation sums 1e-5 of their largest value, tails
    exact."""
    planes = _dualtone_inputs(int(skip_chanfilt) + 2 * int(want_afc))
    taps = design_lowpass(0.45 * FS, FS, 41)
    want = jax_dualtone(*(jnp.asarray(p) for p in planes),
                        jnp.asarray(taps[None]), ntaps=41, nb=5,
                        chunk=frontend_chunk(BLOCK), dev_over_fs=DEV / FS,
                        want_afc=want_afc, skip_chanfilt=skip_chanfilt,
                        interpret=True)
    tabs = [T(t) for t in mixer_tables(BLOCK, DEV / FS)]
    got = fused_dualtone_frontend(*(T(p) for p in planes), taps, *tabs, 5,
                                  want_afc, skip_chanfilt)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-5)
    for k in (1, 2):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in (3, 4, 5):
        w = np.asarray(want[k])
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-5 * scale)
    if not want_afc:
        assert not got[4].any() and not got[5].any()


def test_dualtone_stream_continuity():
    """Two blocks with the carried tail equal one block of twice the length
    wherever the mixer tables agree (dev * n / fs integer for both)."""
    x_i, x_q, t_i, t_q = (T(p) for p in _dualtone_inputs(9, 8, 9600))
    taps = design_lowpass(0.45 * FS, FS, 41)
    whole = fused_dualtone_plain(x_i, x_q, t_i, t_q, taps,
                                 *(T(t) for t in mixer_tables(9600, 0.25)), 5,
                                 skip_chanfilt=False)
    tabs = [T(t) for t in mixer_tables(4800, 0.25)]
    a = fused_dualtone_plain(x_i[:, :4800], x_q[:, :4800], t_i, t_q, taps,
                             *tabs, 5)
    b = fused_dualtone_plain(x_i[:, 4800:], x_q[:, 4800:], a[1], a[2], taps,
                             *tabs, 5)
    torch.testing.assert_close(torch.cat([a[0], b[0]], -1), whole[0],
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="mixer tables"):
        fused_dualtone_plain(x_i, x_q, t_i, t_q, taps, *tabs, 5)


@pytest.mark.parametrize("nb,skip,afc,want", [
    (5, True, False, "skip_nb5"), (5, True, True, "skip_nb5_afc"),
    (7, True, False, "skip_runtime_nb"), (2, True, True,
                                          "skip_runtime_nb_afc"),
    (5, False, False, "chanfilt"), (7, False, True, "chanfilt_afc"),
])
def test_dualtone_body(nb, skip, afc, want):
    """The dual-tone body for the arguments: m10's nb = 5 compiled in when
    the channel filter is skipped, nb at run time otherwise."""
    assert dualtone_body(nb, skip, afc) == want


def test_line_decoders_match_jax():
    rng = np.random.default_rng(3)
    chips = rng.integers(0, 2, size=(4, 3, 96), dtype=np.uint8)
    for invert in (False, True):
        np.testing.assert_array_equal(
            tcoding.manchester_decode(T(chips), invert).numpy(),
            np.asarray(jcoding.manchester_decode(jnp.asarray(chips), invert)))
    np.testing.assert_array_equal(
        tcoding.biphase_m_decode(T(chips)).numpy(),
        np.asarray(jcoding.biphase_m_decode(jnp.asarray(chips))))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_gather_frames_matches_jax(dtype):
    """One contiguous slice per (channel, slot), starts clamped, the same
    validity; including a stream shorter than a frame."""
    rng = np.random.default_rng(4)
    stream = (rng.normal(size=(5, 300)) * 4).astype(dtype)
    starts = rng.integers(-20, 320, size=(5, 6)).astype(np.int32)
    ok = rng.random((5, 6)) < 0.7
    for frame_len in (40, 301):
        want = jcorrelator.gather_frames(jnp.asarray(stream),
                                         jnp.asarray(starts), jnp.asarray(ok),
                                         frame_len)
        got = tcorrelator.gather_frames(T(stream), T(starts), T(ok), frame_len)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_rational_sps_sampling_matches_jax():
    """dfm's sps 19.2 = 96/5: the port's two-tap form of the segmented
    contraction against the JAX einsum, atol 1e-6."""
    kw = dict(sonde="dfm", channels=C, block_len=BLOCK, use_pallas=True)
    jp = jpipe.Pipeline(jpipe.PipelineConfig(**kw))
    tp = tpipe.Pipeline(tpipe.PipelineConfig(**kw), CPU)
    cfg = tp.config
    assert cfg.sps == pytest.approx(19.2) and tpipe._rational_sps(cfg) == (96, 5)
    rng = np.random.default_rng(5)
    filt = rng.normal(size=(C, BLOCK)).astype(np.float32)
    start = (rng.random(C) * (cfg.sps - 1e-3)).astype(np.float32)
    start[0], start[1] = 0.0, np.float32(cfg.sps - 1e-3)
    want = jp._sample_symbols(jnp.asarray(filt), jnp.asarray(start), cfg.sps,
                              cfg.chips_per_block)
    got = tp._sample_symbols(T(filt), T(start), cfg.sps, cfg.chips_per_block)
    assert got.shape == (C, cfg.chips_per_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# --- the host copies ---------------------------------------------------------

FAMILIES = {"m10": (jm10, tm10), "dfm": (jdfm, tdfm),
            "imet4": (jimet4, timet4), "c50": (jc50, tc50),
            "ims100": (jims100, tims100), "mrzn1": (jmrzn1, tmrzn1)}
MODULATORS = {"m10": "M10Modulator", "dfm": "DFMModulator",
              "imet4": "IMET4Modulator", "c50": "C50Modulator",
              "ims100": "IMS100Modulator", "mrzn1": "MRZN1Modulator"}
DECODERS = {"m10": "M10Decoder", "dfm": "DFMDecoder",
            "imet4": "IMET4Decoder", "c50": "C50Decoder",
            "ims100": "IMS100Decoder", "mrzn1": "MRZN1Decoder"}


def _truths(mod, family, k=6):
    if family == "m10":
        return [mod.M10Truth(serial="A05-3-54321", frame_no=3 + i,
                             m20=(i == 4)) for i in range(k)]
    if family == "imet4":
        return [mod.IMET4Truth(frame_no=1 + i, lat=40.0 + i,
                               o3_mpa=(3.2 if i % 2 else 0.0))
                for i in range(k)]
    if family == "c50":
        return [mod.C50Truth(serial_num=12345 + i, frame_no=1 + i)
                for i in range(k)]
    if family == "ims100":
        # iMS-100 and RS-11G frames, a southern/western fix, a climb
        return [mod.IMS100Truth(frame_no=4 + i, rs11g=(i >= 4),
                                lat=-35.7 if i == 2 else 35.7,
                                lon=-139.7 if i == 2 else 139.7,
                                alt=18000.0 + 20.0 * i,
                                time_utc=1.7e9 + i)
                for i in range(k)]
    if family == "mrzn1":
        return [mod.MRZN1Truth(serial_lo=40 + i, frame_no=1 + i,
                               lat=55.8 - i, vu=-3.0 if i % 2 else 4.2)
                for i in range(k)]
    return [mod.DFMTruth(serial_num=7654321, frame_no=1 + i)
            for i in range(k)]


def _built_frames(family, modulator, truths):
    """The byte frames the device hands the family's decoder: m10, dfm,
    ims100 (even and odd halves) and mrzn1 frames, c50's 9-byte telegrams,
    or imet4's 80-byte windows of the UART bit stream at each packet
    start."""
    if family in ("m10", "mrzn1"):
        return np.stack([modulator.build_frame(t) for t in truths])
    if family in ("dfm", "ims100"):
        return np.stack([modulator.build_frame(t, k)
                         for k, t in enumerate(truths)])
    if family == "c50":
        return np.concatenate([modulator.build_frame(t)
                               for t in truths]).reshape(-1, 9)
    packets = []
    for t in truths:
        packets += [modulator.build_ptu(t), modulator.build_gps(t)]
        if t.o3_mpa:
            packets.append(modulator.build_xdata(t))
    bits = modulator.packets_to_bits(packets)
    bits = np.concatenate([bits, np.ones(640, np.uint8)])
    starts = np.cumsum([0] + [10 * (len(p) + 1) for p in packets[:-1]])
    return np.stack([tcoding.np_bits_to_bytes(bits[s:s + 640])
                     for s in starts])


def _frag_dicts(frags):
    # repr: NaN fields compare equal as text
    return [(int(ch), repr(dataclasses.asdict(f))) for ch, f in frags]


@pytest.mark.parametrize("family", ["m10", "dfm", "imet4", "c50", "ims100",
                                    "mrzn1"])
def test_family_copies_equal_originals(family):
    """Spec fields, built frames, modulated IQ and decoded fragments (with
    clean, repairable and broken frames) equal the originals; ims100's
    per-channel state (subtype, the climb from successive fixes) too, and
    after reset_channel."""
    jmod, tmod = FAMILIES[family]
    js, ts = jmod.SPEC, tmod.SPEC
    for f in dataclasses.fields(js):
        tv, jv = getattr(ts, f.name), getattr(js, f.name)
        if f.name == "extra":
            # imet4's holds arrays (its sync bits): compared element-wise
            np.testing.assert_equal(tv, jv)
        else:
            assert tv == jv, f.name
    assert get_sonde(family)["spec"] is ts
    np.testing.assert_array_equal(ts.sync_chip_template(),
                                  js.sync_chip_template())
    jm, tm = (getattr(m, MODULATORS[family])() for m in (jmod, tmod))
    jt, tt = _truths(jmod, family), _truths(tmod, family)
    jf = _built_frames(family, jm, jt)
    tf = _built_frames(family, tm, tt)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tm.modulate(tt), jm.modulate(jt))
    frames = np.concatenate([jf, jf])
    fb = frames.shape[1]
    frames[len(jf), 20 % fb] ^= 0x10     # one flipped bit
    frames[len(jf) + 1, 10 % fb:30] ^= 0xFF   # broken
    chans = np.arange(frames.shape[0]) % 3
    port_dec = get_sonde(family)["decoder"]()
    jax_dec = getattr(jmod, DECODERS[family])()
    kw = {}
    if family == "m10":
        bits = frames.shape[1] * 8
        weak = np.tile(np.arange(24) * 7 % bits, (frames.shape[0], 1))
        weak[len(jf)] = [20 * 8 + 3] + list(range(23))
        kw = {"weak_bits": weak}
    want = _frag_dicts(jax_dec.decode_byte_frames(frames, chans, **kw))
    got = _frag_dicts(port_dec.decode_byte_frames(frames, chans, **kw))
    assert got == want and len(want) >= 3
    if family == "ims100":
        assert ({ch: port_dec.subtype(ch) for ch in range(3)}
                == {ch: jax_dec.subtype(ch) for ch in range(3)})
        assert port_dec.subtype(0) in ("iMS-100", "RS-11G")
        for dec in (port_dec, jax_dec):
            dec.reset_channel(0)
        assert port_dec.subtype(0) is None is jax_dec.subtype(0)
        assert (_frag_dicts(port_dec.decode_byte_frames(frames, chans))
                == _frag_dicts(jax_dec.decode_byte_frames(frames, chans)))


# --- the pipelines on the kernel path ----------------------------------------

SERIALS = {"m10": ["910-2-12345", "A05-3-54321", "C12-1-00042"],
           "dfm": [1234567, 1235678, 7654321],
           "ims100": ["2136051", "2136052", "R2136053"],
           "mrzn1": ["MRZ-040", "MRZ-041", "MRZ-042"]}


def _family_iq(family, serial, n):
    """complex [n] at 48 kHz: back-to-back frames of ``family`` carrying
    ``serial`` (an "R" prefix makes ims100 frames RS-11G ones)."""
    if family == "m10":
        return tm10.M10Modulator().modulate(
            [tm10.M10Truth(serial=serial, frame_no=5 + j)
             for j in range(n // 8000 + 2)])
    if family == "ims100":
        return tims100.IMS100Modulator().modulate(
            [tims100.IMS100Truth(serial=serial, frame_no=2 + j,
                                 rs11g=serial.startswith("R"))
             for j in range(n // 11520 + 2)])
    if family == "mrzn1":
        return tmrzn1.MRZN1Modulator().modulate(
            [tmrzn1.MRZN1Truth(serial_lo=int(serial[4:]), frame_no=1 + j)
             for j in range(n // 5120 + 2)])
    return tdfm.DFMModulator().modulate(
        [tdfm.DFMTruth(serial_num=serial, frame_no=2 + j)
         for j in range(n // 10000 + 2)])


def _family_planes(family, n_blocks, seed=0, noise=0.1, block=BLOCK):
    """int16 (i, q) [C, n_blocks * block]: channel ch carries serial
    ch % 3 with its own offset into the frame stream and its own noise."""
    n = n_blocks * block
    rows = []
    for k, serial in enumerate(SERIALS[family]):
        iq = _family_iq(family, serial, n + 37 * k)[37 * k:37 * k + n]
        rng = np.random.default_rng(seed + k)
        iq = iq + noise * (rng.normal(size=n) + 1j * rng.normal(size=n))
        rows.append((np.clip(iq.real * 32767, -32768, 32767).astype(np.int16),
                     np.clip(iq.imag * 32767, -32768, 32767).astype(np.int16)))
    return (np.stack([rows[ch % 3][0] for ch in range(C)]),
            np.stack([rows[ch % 3][1] for ch in range(C)]))


def _config(family, **kw):
    return {**dict(sonde=family, channels=C, block_len=BLOCK, use_pallas=True,
                   compute_dtype="f32", input_dtype="i16"), **kw}


def _steps_equal(jp, tp, qi, qq, n_blocks, block=BLOCK):
    """Steps both pipelines over the blocks: validity, valid-slot bytes and
    the packed buffer's valid rows equal, timing within 5e-3, weak bits
    equal as sets per valid frame. Returns (JAX state, port state, valid
    frames)."""
    cfg = tp.config
    js, ts = jp.init_state(), tp.init_state()
    assert ts.fir.tail.shape == np.asarray(js.fir.tail).shape
    frames = 0
    for b in range(n_blocks):
        sl = slice(b * block, (b + 1) * block)
        js, jo = jp.step(js, (qi[:, sl], qq[:, sl]))
        ts, to = tp.step(ts, (qi[:, sl], qq[:, sl]))
        jv = np.asarray(jo.frame_valid)
        tv = to.frame_valid.numpy()
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(to.frames.numpy()[tv],
                                      np.asarray(jo.frames)[jv])
        np.testing.assert_allclose(ts.timing.pos.numpy(),
                                   np.asarray(js.timing.pos), atol=5e-3)
        tu = tpipe.unpack_block_output(to.packed.numpy(), cfg.k_slots,
                                       cfg.wire_ncols, cfg.chase_total)
        ju = jpipe.unpack_block_output(np.asarray(jo.packed), cfg.k_slots,
                                       cfg.wire_ncols, cfg.chase_total)
        assert len(tu) == len(ju) == (5 if cfg.chase_m else 4)
        np.testing.assert_array_equal(tu[0][tv], ju[0][jv])
        np.testing.assert_array_equal(tu[1], ju[1])
        np.testing.assert_array_equal(tu[2], ju[2])
        if cfg.chase_m:
            for ch, k in zip(*np.nonzero(jv)):
                assert set(tu[4][ch, k]) == set(ju[4][ch, k])
        frames += int(jv.sum())
    return js, ts, frames


def _sessions_equal(cfg, jsess, qi, qq, n_blocks, family, block=BLOCK):
    """The port's DecoderSession over the blocks gives the JAX session's
    telemetry on every channel, each channel its own serial."""
    tsess = DecoderSession(tpipe.PipelineConfig(**cfg), CPU)
    for b in range(n_blocks):
        sl = slice(b * block, (b + 1) * block)
        jsess.process_block((qi[:, sl], qq[:, sl]))
        tsess.process_block((qi[:, sl], qq[:, sl]))
    assert sorted(tsess.telemetry) == sorted(jsess.telemetry) == list(range(C))
    for ch in range(C):
        assert (repr(tsess.telemetry[ch].to_dict())
                == repr(jsess.telemetry[ch].to_dict()))
        assert tsess.telemetry[ch].serial == str(SERIALS[family][ch % 3])
    assert (tsess.metrics.frames_decoded == jsess.metrics.frames_decoded
            > 0)
    return tsess


@pytest.mark.parametrize("family,afc", [
    pytest.param("m10", False, id="m10"), pytest.param("dfm", False, id="dfm"),
    pytest.param("ims100", False, id="ims100"),
    pytest.param("mrzn1", False, id="mrzn1"),
    pytest.param("ims100", True, id="ims100-afc"),
    pytest.param("mrzn1", True, id="mrzn1-afc")])
def test_family_pipeline_matches_jax(family, afc):
    """3 blocks at C=8 on the kernel path: validity, valid-slot bytes and
    the packed buffer's valid rows equal the JAX use_pallas=True pipeline;
    m10's weak bits are equal as sets per valid frame; the sessions'
    telemetry is identical and each channel reports its serial. ims100 and
    mrzn1 run K7's channel-filter body (nb 20) with midpoint DC, and with
    ``afc`` its rotation sums feed the loop: the tracked frequencies within
    0.05 Hz of JAX's (the sums are taken in another order). The ims100
    session's reset_channel clears that channel's subtype."""
    kw = _config(family, afc=afc)
    qi, qq = _family_planes(family, 3)
    jsess = JaxSession(jpipe.PipelineConfig(**kw))
    jp = jsess.pipeline            # one compiled step for both comparisons
    tp = tpipe.Pipeline(tpipe.PipelineConfig(**kw), CPU)
    dualtone = family != "dfm"
    assert (jp._pallas_dualtone, jp._pallas) == (dualtone, not dualtone)
    assert (tp._dualtone, tp._plain) == (dualtone, False)
    assert tp._skip_chanfilt == jp._skip_chanfilt == (family == "m10")
    js, ts, frames = _steps_equal(jp, tp, qi, qq, 3)
    assert frames >= C * 4
    if afc:
        np.testing.assert_allclose(ts.aux[-1].numpy(), np.asarray(js.aux[-1]),
                                   rtol=0, atol=0.05)
    tsess = _sessions_equal(kw, jsess, qi, qq, 3, family)
    if family == "ims100":
        # the session's reset_channel reaches the decoder's per-channel
        # subtype (channel 2 carries RS-11G frames)
        dec = tsess.decoder
        assert (dec.subtype(0), dec.subtype(2)) == ("iMS-100", "RS-11G")
        tsess.reset_channel(2)
        assert dec.subtype(2) is None and 2 not in tsess.telemetry
        assert dec.subtype(0) == "iMS-100" and 0 in tsess.telemetry


@pytest.mark.parametrize("family,use_pallas", [
    ("ims100", True), ("ims100", False), ("m10", True), ("m10", False)])
def test_dualtone_fm_fallback_matches_jax(family, use_pallas):
    """A dual-tone family whose dual-tone gates fail falls back to the FM
    discriminator with the original's warning, word for word. ims100 with
    19 taps (sps 20 > ntaps; a block length cannot fail its gate, since
    its deviation equals its baud rate and dev * block / fs counts the
    block's symbols) runs the plain-op front end with midpoint DC on both
    settings, as the original's jnp path; m10 at a block of 48005 samples
    (dev * block / fs = 12001.25) runs K1 with use_pallas and the plain-op
    front end without. 3 blocks: as test_family_pipeline_matches_jax, and
    the sessions' telemetry on ims100."""
    extra = (dict(ntaps=19) if family == "ims100" else dict(block_len=48005))
    kw = {**_config(family, use_pallas=use_pallas), **extra}
    block = kw["block_len"]
    qi, qq = _family_planes(family, 3, block=block)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jsess = JaxSession(jpipe.PipelineConfig(**kw))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tp = tpipe.Pipeline(tpipe.PipelineConfig(**kw), CPU)
    jmsg = [str(w.message) for w in jw if "fsk_dualtone" in str(w.message)]
    tmsg = [str(w.message) for w in tw]
    assert tmsg == jmsg and len(tmsg) == 1, (tmsg, jmsg)
    assert "falling back to the FM discriminator" in tmsg[0]
    jp = jsess.pipeline
    kernel = use_pallas and family == "m10"
    assert not (jp._dualtone or jp._pallas_dualtone or tp._dualtone)
    assert (jp._pallas, tp._plain) == (kernel, not kernel)
    _, _, frames = _steps_equal(jp, tp, qi, qq, 3, block)
    assert frames >= C * 3
    if family == "ims100":
        _sessions_equal(kw, jsess, qi, qq, 3, family, block)


def test_session_hands_weak_bits_to_the_chase_repair():
    """An m10 packed buffer whose frame fails its checksum by one bit, with
    that bit among the frame's weak bits: the session unpacks the five
    parts of a chase family and hands the weak bits to the decoder, whose
    Chase repair recovers the frame."""
    cfg = tpipe.PipelineConfig(sonde="m10", channels=C, block_len=BLOCK,
                               use_pallas=True)
    sess = DecoderSession(cfg, CPU)
    k, fb, m = cfg.k_slots, cfg.wire_ncols, cfg.chase_total
    frame = tm10.M10Modulator().build_frame(tm10.M10Truth(frame_no=7))
    bad_bit = 0x40 * 8 + 5                       # inside the checksum span
    frame[bad_bit >> 3] ^= 0x80 >> (bad_bit & 7)
    assert sess.decoder.decode_byte_frames(frame[None], [2]) == []
    frames = np.zeros((C, k, fb), np.uint8)
    frames[2, 1] = frame
    valid = np.zeros((C, k), np.uint8)
    valid[2, 1] = 1
    weak = np.tile(np.arange(m, dtype=np.uint16) * 9, (C, k, 1))
    weak[2, 1, 3] = bad_bit
    packed = np.concatenate([frames.reshape(C, -1), valid,
                             np.zeros((C, k), np.uint8),
                             np.ones((C, 1), np.float32).view(np.uint8),
                             weak.view(np.uint8).reshape(C, -1)], axis=1)
    assert packed.shape[1] == cfg.packed_row_bytes
    out = tpipe.BlockOutput(frames=None, frame_valid=None, frame_score=None,
                            soft_rms=None, rs_clean=None,
                            packed=T(packed.reshape(-1)))
    updates, raw, decoded, _ = sess._handle_output(out)
    assert (raw, decoded) == (1, 1)
    assert [ch for ch, _ in updates] == [2]
    assert sess.telemetry[2].serial == "910-2-12345"
