"""The port's plain-op step (use_pallas=False) against the JAX package's jnp
step on the CPU, in float32 and bfloat16: the FM-discriminator families
(rs41, rs41x, dfm) and the dual-tone ones (m10, ims100, mrzn1: the +/-dev
mix, the one-chip boxcar and the envelope metric; ims100 and mrzn1 with
the channel filter and midpoint DC).

Both packages are built from one JAX PipelineConfig and fed the same
numpy-made IQ (the port's modulators, seeded noise, quantized to cs16), 3
blocks carried across. Per block: validity, RS verdicts, valid-slot bytes
and the packed buffer's valid rows equal exactly, and the sessions'
telemetry is identical; the signal ``filt`` that each step hands to the
timing estimate (the matched filter's output, or the DC-removed envelope
metric) within 1e-5 of max|ref| in float32 and within one bfloat16 ulp per
element in bfloat16. They cannot be equal bit for bit: XLA on the CPU
fuses products and sums into FMAs (the discriminator's and the mixer's
products, the envelopes' squares), sums its convolutions in its own order
and takes its own atan2; in float32 that moves filt by at most 7e-7 on
these inputs. So in bfloat16 a sample stored in the compute dtype (an
audio sample, a mixed plane) now and then lies so near a rounding boundary
that the two packages round it to neighbouring values. Through the
discriminator families' matched filter that one ulp spreads over the taps:
bfloat16 filt may differ by one more ulp of the block's largest |filt|
(its unit-gain input's scale) times the largest tap. On the dual-tone
families such a flip of a channel-filtered or mixed sample x moves one of
the four boxcar sums by at most 2**-7 |x| / nb, and the normalized metric
(P+ - P-) / (P+ + P-) by at most four times that over the envelope's
amplitude sqrt(P+ + P-), which is about |x| on rows that carry a signal:
bfloat16 filt may differ by 2**-5 / nb more (measured up to 1e-3 at nb =
20, within the 1.6e-3 it allows).
The chip ring ``chipbuf`` (through state_to_numpy) is held to the same
tolerance plus what the timing estimate's difference moves a chip: the two
estimates differ by ~1e-4 samples (the original's float32 cos/sin tables
against the port's, rounded once from float64), and a chip sampled that
far off moves by at most that times filt's largest step between two
samples.
"""

import jax
import numpy as np
import pytest
import torch

from sondetpu.runtime import pipeline as jpipe
from sondetpu.runtime.session import DecoderSession as JaxSession
from sondetpu_torch.runtime import pipeline as tpipe
from sondetpu_torch.runtime.session import DecoderSession
from sondetpu_torch.sondes import dfm as tdfm
from sondetpu_torch.sondes import ims100 as tims100
from sondetpu_torch.sondes import m10 as tm10
from sondetpu_torch.sondes import mrzn1 as tmrzn1
from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth, RS41XModulator
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

CPU = torch.device("cpu")
BLOCK, N_BLOCKS = 48000, 3
SERIALS = {"rs41": ["S1234567", "T7654321", "R0420042"],
           "rs41x": ["S1234567", "T7654321", "R0420042"],
           "dfm": [1234567, 1235678, 7654321],
           "m10": ["910-2-12345", "A05-3-54321", "C12-1-00042"],
           "ims100": ["2136051", "2136052", "R2136053"],
           "mrzn1": ["MRZ-040", "MRZ-041", "MRZ-042"]}
DUALTONE = ("m10", "ims100", "mrzn1")


def _iq(sonde, k, serial, n):
    """complex [n] at 48 kHz: back-to-back frames of ``sonde`` carrying
    ``serial`` (rs41x: with an ozone reading of 2.25 + k mPa; an "R" prefix
    makes ims100 frames RS-11G ones)."""
    if sonde == "dfm":
        return tdfm.DFMModulator().modulate(
            [tdfm.DFMTruth(serial_num=serial, frame_no=2 + j)
             for j in range(n // 10000 + 2)])
    if sonde == "m10":
        return tm10.M10Modulator().modulate(
            [tm10.M10Truth(serial=serial, frame_no=5 + j)
             for j in range(n // 8000 + 2)])
    if sonde == "ims100":
        return tims100.IMS100Modulator().modulate(
            [tims100.IMS100Truth(serial=serial, frame_no=2 + j,
                                 rs11g=serial.startswith("R"))
             for j in range(n // 11520 + 2)])
    if sonde == "mrzn1":
        return tmrzn1.MRZN1Modulator().modulate(
            [tmrzn1.MRZN1Truth(serial_lo=int(serial[4:]), frame_no=1 + j)
             for j in range(n // 5120 + 2)])
    ext = sonde == "rs41x"
    mod, per = (RS41XModulator(), 41440) if ext else (RS41Modulator(), 25600)
    return mod.modulate(
        [RS41Truth(serial=serial, frame_no=20 + j,
                   o3_mpa=2.25 + k if ext else None)
         for j in range(n // per + 2)])


def _planes(sonde, channels, seed=0, noise=0.1):
    """int16 (i, q) [channels, N_BLOCKS * BLOCK]: channel ch carries serial
    ch % 3 (rs41x: with its own ozone reading), each with its own offset
    into the frame stream and its own noise."""
    n = N_BLOCKS * BLOCK
    rows = []
    for k, serial in enumerate(SERIALS[sonde]):
        iq = _iq(sonde, k, serial, n + 37 * k)[37 * k:37 * k + n]
        rng = np.random.default_rng(seed + k)
        iq = iq + noise * (rng.normal(size=n) + 1j * rng.normal(size=n))
        rows.append((np.clip(iq.real * 32767, -32768, 32767).astype(np.int16),
                     np.clip(iq.imag * 32767, -32768, 32767).astype(np.int16)))
    return (np.stack([rows[ch % 3][0] for ch in range(channels)]),
            np.stack([rows[ch % 3][1] for ch in range(channels)]))


def _config(sonde, dtype, channels=8):
    return jpipe.PipelineConfig(sonde=sonde, channels=channels,
                                block_len=BLOCK, use_pallas=False,
                                compute_dtype=dtype, input_dtype="i16")


def _spy_timing(monkeypatch):
    """Record each step's filt, as both packages hand it to the timing
    estimate, and the estimate tau: {"jax": [...], "port": [...]} of
    (filt, tau, dtype) triples, filt and tau as float32 arrays and dtype
    the one filt was handed over in."""
    seen = {"jax": [], "port": []}
    jax_tau, port_tau = jpipe.oerder_meyr_tau, tpipe.oerder_meyr_tau

    def jax_spy(x, sps):
        tau = jax_tau(x, sps)
        jax.debug.callback(lambda v, t, dt=x.dtype: seen["jax"].append(
            (np.asarray(v, np.float32), np.asarray(t), dt)), x, tau)
        return tau

    def port_spy(x, *args):
        tau = port_tau(x, *args)
        seen["port"].append((x.to(torch.float32).numpy().copy(),
                             tau.numpy().copy(), x.dtype))
        return tau

    monkeypatch.setattr(jpipe, "oerder_meyr_tau", jax_spy)
    monkeypatch.setattr(tpipe, "oerder_meyr_tau", port_spy)
    return seen


def _assert_close(got, want, dtype, what, extra=0.0):
    """float32: within 1e-5 of max|want|; bfloat16: within one ulp of each
    element (2**-7 |want| bounds it), plus 1e-6 near zero; both plus
    ``extra``."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    d = np.abs(got - want)
    if dtype == "f32":
        tol = np.full_like(want, 1e-5 * np.abs(want).max())
    else:
        tol = 2.0 ** -7 * np.abs(want) + 1e-6
    tol = tol + extra
    bad = d > tol
    assert not bad.any(), (f"{what}: {int(bad.sum())} of {d.size} beyond "
                           f"tolerance, worst {float((d - tol).max())}")


def _leaves(state):
    return [state.chan_tail_i, state.chan_tail_q, state.fm_prev,
            state.fir.tail, state.timing.pos, state.timing.locked,
            state.chipbuf, state.buf_fill]


_CASES = [pytest.param(s, d, 8, id=f"{s}-{d}")
          for s in ("rs41", "rs41x", "dfm") for d in ("f32", "bf16")]
_CASES.append(pytest.param("rs41", "bf16", 1, id="rs41-bf16-one-channel"))
_CASES += [pytest.param(s, d, 8, id=f"{s}-{d}")
           for s in DUALTONE for d in ("f32", "bf16")]


@pytest.mark.parametrize("sonde,dtype,channels", _CASES)
def test_plain_path_matches_jax(monkeypatch, sonde, dtype, channels):
    """3 blocks: per block validity, RS verdicts, valid-slot bytes and the
    packed buffer's valid rows equal the JAX package's; filt and chipbuf
    within tolerance; the state has the JAX layout and dtypes and
    round-trips through state_to_numpy and state_from_numpy bit for bit.
    On the dual-tone families the sessions' telemetry is identical too,
    each channel its own serial."""
    seen = _spy_timing(monkeypatch)
    cfg = _config(sonde, dtype, channels)
    qi, qq = _planes(sonde, channels)
    jsess = JaxSession(cfg)
    jp, tp = jsess.pipeline, tpipe.Pipeline(cfg, CPU)
    dualtone = sonde in DUALTONE
    assert not (jp._pallas or jp._pallas_dualtone or jp._afsk)
    assert jp._dualtone == tp._dualtone == dualtone and tp._plain
    js, ts = jp.init_state(), tp.init_state()
    for j, t in zip(_leaves(js), _leaves(ts)):
        assert np.asarray(j).shape == tuple(t.shape)
        assert np.asarray(j).dtype == tpipe._leaf_to_numpy(t).dtype
    frames, moved = 0, 0.0
    # one flipped bfloat16 rounding of an audio sample, through the taps
    # of the matched filter (the dual-tone metric has none after it)
    flip = (2.0 ** -7 * float(np.abs(tp._taps).max())
            if dtype == "bf16" and not dualtone else 0.0)
    for b in range(N_BLOCKS):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        js, jo = jp.step(js, (qi[:, sl], qq[:, sl]))
        ts, to = tp.step(ts, (qi[:, sl], qq[:, sl]))
        jv = np.asarray(jo.frame_valid)
        np.testing.assert_array_equal(to.frame_valid.numpy(), jv)
        np.testing.assert_array_equal(to.rs_clean.numpy(),
                                      np.asarray(jo.rs_clean))
        np.testing.assert_array_equal(to.frames.numpy()[jv],
                                      np.asarray(jo.frames)[jv])
        tu = tpipe.unpack_block_output(to.packed.numpy(), cfg.k_slots,
                                       cfg.wire_ncols, cfg.chase_total)
        ju = jpipe.unpack_block_output(np.asarray(jo.packed), cfg.k_slots,
                                       cfg.wire_ncols, cfg.chase_total)
        np.testing.assert_array_equal(tu[0][jv], ju[0][jv])
        for k in (1, 2):
            np.testing.assert_array_equal(tu[k], ju[k])
        (pf, ptau, pdt), (jf, jtau, jdt) = seen["port"][b], seen["jax"][b]
        # filt is rounded to the compute dtype before the timing estimate
        assert (pdt, np.dtype(jdt).name) == {
            "f32": (torch.float32, "float32"),
            "bf16": (torch.bfloat16, "bfloat16")}[dtype]
        spread = (2.0 ** -5 / tp._nb if dualtone and dtype == "bf16"
                  else flip * float(np.abs(jf).max()))
        _assert_close(pf, jf, dtype, f"block {b} filt", extra=spread)
        np.testing.assert_allclose(ts.timing.pos.numpy(),
                                   np.asarray(js.timing.pos), atol=5e-3)
        # the ring holds chips of this block and the one before
        dtau = float(np.abs(ptau - jtau).max())
        assert dtau < 1e-3, f"block {b}: timing estimates differ by {dtau}"
        step = moved
        moved = dtau * float(np.abs(np.diff(jf, axis=-1)).max())
        back = tpipe.state_to_numpy(ts)
        _assert_close(back.chipbuf, np.asarray(js.chipbuf), dtype,
                      f"block {b} chipbuf",
                      extra=spread + max(step, moved))
        for j, t in zip(_leaves(js), _leaves(back)):
            assert t.dtype == np.asarray(j).dtype
        for t, t2 in zip(_leaves(ts),
                         _leaves(tpipe.state_from_numpy(back, CPU))):
            assert t.dtype == t2.dtype and torch.equal(t, t2)
        frames += int(jv.sum())
    assert len(seen["port"]) == len(seen["jax"]) == N_BLOCKS
    assert frames >= channels * (1 if sonde == "rs41x" else 3)
    if dualtone:
        tsess = DecoderSession(cfg, CPU, pipeline=tp)
        for b in range(N_BLOCKS):
            sl = slice(b * BLOCK, (b + 1) * BLOCK)
            jsess.process_block((qi[:, sl], qq[:, sl]))
            tsess.process_block((qi[:, sl], qq[:, sl]))
        assert sorted(tsess.telemetry) == list(range(channels))
        for ch in range(channels):
            t, j = tsess.telemetry[ch], jsess.telemetry[ch]
            assert repr(t.to_dict()) == repr(j.to_dict())
            assert t.serial == SERIALS[sonde][ch % 3]


def test_plain_state_carries_between_packages():
    """bf16 RS41: JAX runs block 1, the port runs block 2 from JAX's state
    (state_from_numpy), and JAX runs block 3 from the port's
    (state_to_numpy); each block's validity and valid bytes equal a JAX
    run that never left the JAX package."""
    cfg = _config("rs41", "bf16")
    qi, qq = _planes("rs41", 8, seed=3)
    jp, tp = jpipe.Pipeline(cfg), tpipe.Pipeline(cfg, CPU)
    blocks = [(qi[:, b * BLOCK:(b + 1) * BLOCK], qq[:, b * BLOCK:(b + 1) * BLOCK])
              for b in range(N_BLOCKS)]
    ref, outs = jp.init_state(), []
    for blk in blocks:
        ref, o = jp.step(ref, blk)
        outs.append(o)
    js, _ = jp.step(jp.init_state(), blocks[0])
    ts = tpipe.state_from_numpy(js, CPU)
    assert ts.chipbuf.dtype == torch.bfloat16 and ts.chan_tail_i.shape == (8, 40)
    ts, to = tp.step(ts, blocks[1])
    back = tpipe.state_to_numpy(ts)
    js = jpipe.PipelineState(
        chan_tail_i=back.chan_tail_i, chan_tail_q=back.chan_tail_q,
        fm_prev=back.fm_prev, fir=jpipe.FIRState(tail=back.fir.tail),
        timing=jpipe.TimingState(pos=back.timing.pos,
                                 locked=back.timing.locked),
        chipbuf=back.chipbuf, buf_fill=back.buf_fill, aux=back.aux)
    _, jo = jp.step(js, blocks[2])
    for got, want in ((to, outs[1]), (jo, outs[2])):
        v = np.asarray(want.frame_valid)
        np.testing.assert_array_equal(np.asarray(got.frame_valid), v)
        np.testing.assert_array_equal(np.asarray(got.frames)[v],
                                      np.asarray(want.frames)[v])
    assert int(np.asarray(outs[2].frame_valid).sum()) >= 8


def test_plain_session_matches_jax_session():
    """bf16 RS41 through both packages' DecoderSession: the same updates,
    the same telemetry per channel (serial, frame number, position), each
    channel its own serial."""
    cfg = _config("rs41", "bf16")
    qi, qq = _planes("rs41", 8, seed=5)
    jsess, tsess = JaxSession(cfg), DecoderSession(cfg, CPU)
    jup, tup = [], []
    for b in range(N_BLOCKS):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        jup += jsess.process_block((qi[:, sl], qq[:, sl]))
        tup += tsess.process_block((qi[:, sl], qq[:, sl]))
    assert len(tup) == len(jup) > 0
    assert ([(ch, repr(u.to_dict())) for ch, u in tup]
            == [(ch, repr(u.to_dict())) for ch, u in jup])
    assert sorted(tsess.telemetry) == list(range(8))
    for ch in range(8):
        t, j = tsess.telemetry[ch], jsess.telemetry[ch]
        assert repr(t.to_dict()) == repr(j.to_dict())
        assert t.serial == SERIALS["rs41"][ch % 3]
        assert (t.seq, t.lat, t.lon, t.alt) == (j.seq, j.lat, j.lon, j.alt)
        assert t.seq > 0 and abs(t.lat - 45.0) < 1e-3
    assert tsess.metrics.frames_decoded == jsess.metrics.frames_decoded > 0
