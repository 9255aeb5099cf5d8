"""The port's Pipeline on every config the original accepts, against the
JAX package on the CPU: the kernel gates of the original (a failed gate
takes the jnp front end, which the port's plain-op front end copies), the
jnp AFSK front end and ``_linear_interp``. This file holds the configs
the port refused until it had their pieces, with the channel gate on m10
and the jnp AFSK front end's sessions; the block gate and a JAX state
carried into the jnp AFSK front end are in
tests/test_torch_gate_fallbacks.py, bfloat16 on the
kernel routes in tests/test_torch_bf16_routes.py and ``profile_stop`` in
tests/test_torch_profile_stop.py, which take this file's helpers.

Both packages are built from one JAX PipelineConfig and fed the same
numpy-made IQ (the port's modulators, three truths over the channels, each
with its own seeded noise, quantized to cs16). The JAX Pallas kernels run
in interpret mode, as the JAX package's own tests run them; the port's
wrappers run their plain twins on the CPU. Each config goes through both
packages' DecoderSession; every block's output is recorded on the way.

What must be equal, exactly: validity, the valid slots' frame bytes, the RS
verdicts, the packed buffer's valid rows, and the decoded telemetry of
every channel. The soft chips (the chip ring) are held within
``CHIP_TOL`` of JAX's, plus one bfloat16 rounding step of each chip when
the ring is bfloat16. Why they are not equal: the two packages take their
products and sums in different orders (XLA on the CPU fuses products into
FMAs and runs its convolutions in its own order; in float32 the filter
outputs differ by ~1e-6 of their range), their timing estimates differ by
~1e-4 samples (the original's float32 cos/sin tables against the port's,
rounded once from float64), which moves a sampled chip by that times the
signal's slope, below 1e-4 on these unit-range chips; and the jnp AFSK
front end takes cos and sin of float32 angles up to ~1e4 rad, where XLA's
and PyTorch's float32 trig differ by a few ulp of the argument's range,
~1e-3 relative in a mixed sample. In bfloat16 a sample that lies next to a
rounding boundary is rounded to a neighbouring value by the other package,
and through the matched filter such a flip moves a chip by up to one ulp
of its largest neighbour: hence the extra bfloat16 step.
"""

import warnings

import numpy as np
import pytest
import torch

from sondetpu.runtime import pipeline as jpipe
from sondetpu.runtime.session import DecoderSession as JaxSession
from sondetpu_torch.runtime import pipeline as tpipe
from sondetpu_torch.runtime.session import DecoderSession
from sondetpu_torch.sondes import c50 as tc50
from sondetpu_torch.sondes import dfm as tdfm
from sondetpu_torch.sondes import imet4 as timet4
from sondetpu_torch.sondes import ims100 as tims100
from sondetpu_torch.sondes import m10 as tm10
from sondetpu_torch.sondes import mrzn1 as tmrzn1
from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

CPU = torch.device("cpu")
BLOCK = 48000
CHIP_TOL = 5e-3
# the truths of each family: three per family, channel ch carries ch % 3
SERIALS = {"rs41": ["S1234567", "T7654321", "R0420042"],
           "m10": ["910-2-12345", "A05-3-54321", "C12-1-00042"],
           "ims100": ["2136051", "2136052", "R2136053"],
           "mrzn1": ["MRZ-040", "MRZ-041", "MRZ-042"],
           "dfm": [1234567, 1235678, 7654321]}


def _iq(sonde, k, n, fs):
    """complex [n] at rate fs: back-to-back frames of ``sonde`` carrying
    truth k."""
    if sonde == "rs41":
        return RS41Modulator().modulate(
            [RS41Truth(serial=SERIALS[sonde][k], frame_no=20 + j)
             for j in range(n // 25000 + 2)], fs=fs)
    if sonde == "m10":
        return tm10.M10Modulator().modulate(
            [tm10.M10Truth(serial=SERIALS[sonde][k], frame_no=5 + j)
             for j in range(n // 8000 + 2)], fs=fs)
    if sonde == "ims100":
        s = SERIALS[sonde][k]
        return tims100.IMS100Modulator().modulate(
            [tims100.IMS100Truth(serial=s, frame_no=2 + j,
                                 rs11g=s.startswith("R"))
             for j in range(n // 11000 + 2)], fs=fs)
    if sonde == "mrzn1":
        return tmrzn1.MRZN1Modulator().modulate(
            [tmrzn1.MRZN1Truth(serial_lo=40 + k, frame_no=1 + j)
             for j in range(n // 5000 + 2)], fs=fs)
    if sonde == "dfm":
        return tdfm.DFMModulator().modulate(
            [tdfm.DFMTruth(serial_num=SERIALS[sonde][k], frame_no=2 + j)
             for j in range(n // 10000 + 2)], fs=fs)
    if sonde == "imet4":
        return timet4.IMET4Modulator().modulate(
            [timet4.IMET4Truth(frame_no=1 + j, lat=40.0 + k, temp=-58.0 + k)
             for j in range(n // 20000 + 2)], fs=fs)
    return tc50.C50Modulator().modulate(
        [tc50.C50Truth(serial_num=12345 + k, frame_no=1 + j, lat=46.8 + k)
         for j in range(n // 10000 + 2)], fs=fs)


def _planes(sonde, channels, n, fs=48000.0, seed=0, noise=0.05):
    """int16 (i, q) [channels, n]: channel ch carries truth ch % 3 with its
    own offset into the frame stream and its own noise, cs16."""
    rows = []
    for k in range(3):
        iq = _iq(sonde, k, n + 37 * k, fs)[37 * k:37 * k + n]
        rng = np.random.default_rng(seed + k)
        iq = iq + noise * (rng.normal(size=n) + 1j * rng.normal(size=n))
        rows.append((np.clip(iq.real * 32767, -32768, 32767).astype(np.int16),
                     np.clip(iq.imag * 32767, -32768, 32767).astype(np.int16)))
    return (np.stack([rows[ch % 3][0] for ch in range(channels)]),
            np.stack([rows[ch % 3][1] for ch in range(channels)]))


def _config(**kw):
    return {**dict(sonde="rs41", channels=8, block_len=BLOCK,
                   use_pallas=True, compute_dtype="f32", input_dtype="i16"),
            **kw}


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.array(np.asarray(x), np.float32)


def _record(pipe, rec):
    """Wrap ``pipe.step`` so that every block's output and chip ring land in
    ``rec`` as NumPy arrays (copied at once: the JAX step donates its
    state)."""
    step = pipe.step

    def wrapped(state, iq):
        state, out = step(state, iq)
        rec.append({"valid": np.array(np.asarray(out.frame_valid)),
                    "frames": np.array(np.asarray(out.frames)),
                    "rs": np.array(np.asarray(out.rs_clean)),
                    "packed": np.array(np.asarray(out.packed)),
                    "chipbuf": _np32(state.chipbuf)})
        return state, out

    pipe.step = wrapped


def _telemetry(sess):
    return {ch: repr(t.to_dict()) for ch, t in sess.telemetry.items()}


def _run_both(kw, qi, qq, block=BLOCK, route=None, pipes=(None, None)):
    """Both packages' sessions (on ``pipes`` where given) over the blocks
    of (qi, qq): per block the exact checks and the chip tolerance of the
    module docstring, then equal telemetry on every channel. Returns (JAX
    records, port records, JAX session, port session)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # a dual-tone FM fallback warns
        jsess = JaxSession(jpipe.PipelineConfig(**kw), pipeline=pipes[0])
        tsess = DecoderSession(tpipe.PipelineConfig(**kw), CPU,
                               pipeline=pipes[1])
    cfg = tsess.config
    if route is not None:
        assert tsess.pipeline._route == route
    jrec, trec = [], []
    _record(jsess.pipeline, jrec)
    _record(tsess.pipeline, trec)
    n_blocks = qi.shape[-1] // block
    for b in range(n_blocks):
        sl = slice(b * block, (b + 1) * block)
        jsess.process_block((qi[:, sl], qq[:, sl]))
        tsess.process_block((qi[:, sl], qq[:, sl]))
    bf16 = cfg.compute_dtype == "bf16"
    for b, (j, t) in enumerate(zip(jrec, trec)):
        v = j["valid"]
        np.testing.assert_array_equal(t["valid"], v, err_msg=f"block {b}")
        np.testing.assert_array_equal(t["frames"][v], j["frames"][v])
        np.testing.assert_array_equal(t["rs"], j["rs"])
        tu = tpipe.unpack_block_output(t["packed"], cfg.k_slots,
                                       cfg.wire_ncols, cfg.chase_total)
        ju = jpipe.unpack_block_output(j["packed"], cfg.k_slots,
                                       cfg.wire_ncols, cfg.chase_total)
        np.testing.assert_array_equal(tu[0][v], ju[0][v])
        np.testing.assert_array_equal(tu[1], ju[1])
        np.testing.assert_array_equal(tu[2], ju[2])
        want = j["chipbuf"]
        tol = CHIP_TOL + (2.0 ** -7 * np.abs(want) if bf16 else 0.0)
        d = np.abs(t["chipbuf"] - want)
        assert (d <= tol).all(), (f"block {b}: chips beyond tolerance, "
                                  f"worst {float((d - tol).max())}")
    assert len(jrec) == len(trec) == n_blocks
    assert _telemetry(tsess) == _telemetry(jsess)
    return jrec, trec, jsess, tsess


def _valid(rec):
    return sum(int(r["valid"].sum()) for r in rec)


# --- the nine configs the port refused before --------------------------------

_REFUSED = [
    pytest.param(dict(sonde="ims100", fs=48100.0, block_len=48100,
                      use_pallas=False), None, id="ims100"),
    pytest.param(dict(sonde="imet4", use_pallas=False), None,
                 id="no-pallas"),
    pytest.param(dict(sonde="mrzn1", compute_dtype="bf16",
                      input_dtype="f32"), "dualtone", id="bf16"),
    pytest.param(dict(sonde="mrzn1", fs=48100.0, block_len=48100),
                 "dualtone", id="mrzn1"),
    pytest.param(dict(sonde="m10", compute_dtype="bf16", input_dtype="f32"),
                 "dualtone", id="m10-bf16-kernel"),
    pytest.param(dict(profile_stop="corr"), "fused", id="profile-stop"),
    pytest.param(dict(channels=12), None, id="channels-12"),
    pytest.param(dict(fs=50000.0, block_len=50000), "fused",
                 id="fractional-sps"),
    pytest.param(dict(sonde="m10", block_len=48005, compute_dtype="bf16",
                      input_dtype="f32"), "fused", id="m10-fm-fallback"),
    # beside the nine: the channel gate on a dual-tone family, and the jnp
    # AFSK front end on c50 and with afc (the discriminator-DC loop feeding
    # the DDC)
    pytest.param(dict(sonde="m10", channels=12), None, id="m10-channels-12"),
    pytest.param(dict(sonde="c50", use_pallas=False), None,
                 id="c50-no-pallas"),
    pytest.param(dict(sonde="imet4", use_pallas=False, afc=True), None,
                 id="imet4-afc-no-pallas"),
]


def _f32_planes(qi, qq):
    return (qi.astype(np.float32) / 32768.0, qq.astype(np.float32) / 32768.0)


def _afsk_state_matches(jsess, tsess, afc):
    """The jnp AFSK front end's state has the original's layout (four
    float32 [C, win - 1] mixed tails, the int32 [1] LO phase counter, then
    the DDC's two leaves with afc) and follows JAX's: the counter exactly,
    the tails within 1e-5 of their range, the tracked frequency within
    0.05 Hz."""
    js, ts = jsess.state, tpipe.state_to_numpy(tsess.state)
    win, c = tsess.pipeline._afsk_win, tsess.config.channels
    assert len(ts.aux) == len(js.aux) == 5 + (2 if afc else 0)
    for k in range(4):
        assert ts.aux[k].shape == (c, win - 1)
        assert ts.aux[k].dtype == np.float32
        b = np.asarray(js.aux[k])
        np.testing.assert_allclose(ts.aux[k], b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())
    assert ts.aux[4].dtype == np.int32
    np.testing.assert_array_equal(ts.aux[4], np.asarray(js.aux[4]))
    if afc:
        np.testing.assert_allclose(ts.aux[-1], np.asarray(js.aux[-1]),
                                   rtol=0, atol=0.05)


@pytest.mark.parametrize("kw,route", _REFUSED)
def test_formerly_refused_configs_match_jax(kw, route):
    """The nine configs the port refused until it had their pieces, each
    on the route the original's gates pick: ims100 on the plain-op path and
    mrzn1 on K7 at 48.1 kHz (sps 20.04: linear_interp), imet4's jnp AFSK
    front end, mrzn1 (K7 chanfilt) and m10 (K7 skip) in bfloat16, rs41's
    profile_stop at "corr" (the scalar against JAX's), rs41 at 12 channels
    (the channel gate: the plain-op front end), rs41 at 50 kHz on K1 (sps
    5.208: linear_interp) and m10's FM fallback in bfloat16 (a block of
    48005: K1 with bfloat16 planes, K2 on the bfloat16 ring); besides,
    m10 at 12 channels and the jnp AFSK front end on c50 and on imet4 with
    afc. 3 blocks (1 for profile_stop), as the module docstring says. A
    config on the jnp front end takes no kernel in the original either;
    at 12 channels each channel reports its own truth; an AFSK config's
    state follows JAX's (``_afsk_state_matches``)."""
    kw = _config(**kw)
    fs, block = kw.get("fs", 48000.0), kw["block_len"]
    c = kw["channels"]
    if kw.get("profile_stop"):
        qi, qq = _planes(kw["sonde"], c, block, fs)
        jp = jpipe.Pipeline(jpipe.PipelineConfig(**kw))
        tp = tpipe.Pipeline(tpipe.PipelineConfig(**kw), CPU)
        assert tp._route == route
        want = np.asarray(jp.step(jp.init_state(), (qi, qq)))
        got = tp.step(tp.init_state(), (qi, qq))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
        return
    qi, qq = _planes(kw["sonde"], c, 3 * block, fs)
    if kw["input_dtype"] == "f32":
        qi, qq = _f32_planes(qi, qq)
    jrec, trec, jsess, tsess = _run_both(kw, qi, qq, block, route)
    assert _valid(jrec) >= c * 2
    assert sorted(tsess.telemetry) == list(range(c))
    jp = jsess.pipeline
    if route is None:
        assert not (jp._pallas or jp._pallas_dualtone or jp._pallas_afsk)
    if c == 12:
        assert all(tsess.telemetry[ch].serial
                   == str(SERIALS[kw["sonde"]][ch % 3]) for ch in range(c))
    if kw["sonde"] in ("imet4", "c50"):
        _afsk_state_matches(jsess, tsess, kw.get("afc", False))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("sonde", ["imet4", "c50", "rs41"])
def test_bf16_configs_refused_as_the_original_refuses(sonde, use_pallas):
    """The config copy refuses bfloat16 where the original does: every
    AFSK config, and use_pallas with a family that is not dual-tone. So
    no bfloat16 config reaches K8, and K1 reads bfloat16 only on a
    dual-tone family's FM fallback (test_formerly_refused_configs_match_jax
    [m10-fm-fallback])."""
    kw = dict(sonde=sonde, use_pallas=use_pallas, compute_dtype="bf16")
    refused = sonde != "rs41" or use_pallas
    for pipe in (jpipe, tpipe):
        if refused:
            with pytest.raises(ValueError, match="bf16 compute"):
                pipe.PipelineConfig(**kw)
        else:
            pipe.PipelineConfig(**kw)
