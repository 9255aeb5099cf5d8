"""The port's per-channel DDC and AFC loop against the JAX package's, on the
CPU, with the session duties that go with them.

The same numpy-made IQ (the port's modulators, carriers rotated off the
channel centre, seeded noise) goes through one JAX PipelineConfig in both
packages: the plain-op path (use_pallas=False, JAX's jnp step) and the
kernel paths (use_pallas=True, JAX's Pallas kernels in interpret mode, the
port's plain twins) of the K1 NRZ front end, the AFSK front end and the
dual-tone front end. Per block, validity, RS verdicts and valid-slot bytes
must be equal exactly, and the telemetry of the sessions identical.

They cannot be equal bit for bit. XLA on the CPU fuses the DDC's
``phase0 + f_norm * k`` into an FMA and has its own cos and sin, so the
rotated planes differ by a few ulp of the phase in cycles. These
tolerances hold the rest:

- AFC_HZ: the tracked frequency (``aux[-1]``, ``afc_freqs``), 0.05 Hz. The
  loop contracts each block's error by 1 - afc_beta, so differences of the
  block DC do not pile up; seen: 1e-3 Hz.
- PHASE_CYC: the carried DDC phase, 0.05 cycles, wrapped. It integrates
  the frequency, so the frequency's differences add up over blocks (seen:
  5e-3 after 5 blocks); a constant phase moves neither the discriminator
  nor the dual-tone envelopes.
- PLANE_TOL: the rotated planes of the first block (the carried input
  tails: the block's last samples, where the phase is largest), 0.02: four
  ulp of 7000 cycles (the largest phase here) are 0.012 rad, on IQ of
  magnitude up to 1.5; seen: 8.4e-3.
- CHIP_TOL: the chip ring, 5e-3 (seen: 1.7e-3), and soft_rms within
  rtol 1e-4.

Every block carries signal: on noise alone the discriminator's block DC
turns on ulps near zero amplitude, and so does the tracked frequency.
"""

import json

import jax
import numpy as np
import pytest
import torch

from sondetpu.runtime import pipeline as jpipe
from sondetpu.runtime.fleet import FleetChannel as JaxChannel
from sondetpu.runtime.fleet import FleetSession as JaxFleet
from sondetpu.runtime.session import DecoderSession as JaxSession
from sondetpu_torch.dsp.channelizer import bin_and_offset
from sondetpu_torch.runtime import pipeline as tpipe
from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession
from sondetpu_torch.runtime.session import DecoderSession
from sondetpu_torch.sondes.dfm import DFMModulator, DFMTruth
from sondetpu_torch.sondes.imet4 import IMET4Modulator, IMET4Truth
from sondetpu_torch.sondes.m10 import M10Modulator, M10Truth
from sondetpu_torch.sondes.modulate import freq_shift
from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

CPU = torch.device("cpu")
FS = 48000.0
BLOCK = 48000
AFC_HZ = 0.05
PHASE_CYC = 0.05
PLANE_TOL = 0.02
CHIP_TOL = 5e-3


def _noisy(rows, seed, noise=0.05):
    """complex64 rows, cut to whole blocks, plus seeded complex noise of
    std ``noise`` per component."""
    rows = np.atleast_2d(rows)
    rows = rows[:, :rows.shape[-1] // BLOCK * BLOCK]
    rng = np.random.default_rng(seed)
    return (rows + noise * (rng.normal(size=rows.shape)
                            + 1j * rng.normal(size=rows.shape))
            ).astype(np.complex64)


def _rotated(iq, offsets_hz):
    """[len(offsets), n]: ``iq`` (one row, or a row per offset) moved off
    the channel centre by each offset."""
    t = np.arange(np.shape(iq)[-1])
    return iq * np.exp(2j * np.pi * np.asarray(offsets_hz)[:, None] * t / FS)


def _drifting(iq, f0, f1):
    """``iq`` on a carrier ramping from f0 to f1 Hz (tests/test_afc.py)."""
    n = iq.size
    finst = f0 + (f1 - f0) * np.arange(n) / n
    return iq * np.exp(2j * np.pi * np.cumsum(finst) / FS)


def _blocks(sig):
    return [sig[:, b * BLOCK:(b + 1) * BLOCK]
            for b in range(sig.shape[-1] // BLOCK)]


def _np_state(tree):
    """Host copies of a JAX step's arrays (the next step donates its
    buffers)."""
    return jax.tree_util.tree_map(np.array, tree)


def _wrapped(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) % 1.0
    return np.minimum(d, 1.0 - d)


def _assert_close(jo, to, js, ts, afc, first_block):
    """One block of the two packages: exact where the output is bytes,
    within the module's tolerances where it is float. Returns the valid
    frames."""
    jv = np.asarray(jo.frame_valid)
    tv = to.frame_valid.numpy()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(to.frames.numpy()[tv],
                                  np.asarray(jo.frames)[jv])
    np.testing.assert_array_equal(to.rs_clean.numpy(), np.asarray(jo.rs_clean))
    np.testing.assert_allclose(to.soft_rms.numpy(), np.asarray(jo.soft_rms),
                               rtol=1e-4)
    np.testing.assert_allclose(ts.chipbuf.numpy(), np.asarray(js.chipbuf),
                               rtol=0, atol=CHIP_TOL)
    assert len(ts.aux) == len(js.aux)
    if afc:
        # the tracked frequency, then the phase before it
        np.testing.assert_allclose(ts.aux[-1].numpy(), np.asarray(js.aux[-1]),
                                   rtol=0, atol=AFC_HZ)
    phase = ts.aux[-2 if afc else -1].numpy()
    assert ((0.0 <= phase) & (phase < 1.0)).all()
    assert _wrapped(phase, np.asarray(js.aux[-2 if afc else -1])).max() \
        <= PHASE_CYC
    if first_block:
        for t, j in ((ts.chan_tail_i, js.chan_tail_i),
                     (ts.chan_tail_q, js.chan_tail_q)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                       atol=PLANE_TOL)
    return int(jv.sum())


def _jax_run(cfg, sig):
    """The JAX package's pipeline over the blocks of ``sig``: per block,
    host copies of (state, output)."""
    jp = jpipe.Pipeline(cfg)
    js = jp.init_state()
    run = []
    for x in _blocks(sig):
        js, jo = jp.step(js, x)
        run.append(_np_state((js, jo)))
    return run


def _port_run(cfg, sig, jax_run, ts=None):
    """The port's pipeline over the same blocks, from its initial state
    unless given, each block held to the JAX package's. Returns (state,
    valid frames)."""
    tp = tpipe.Pipeline(cfg, CPU)
    first = ts is None
    ts = tp.init_state() if first else ts
    frames = 0
    for b, (x, (js, jo)) in enumerate(zip(_blocks(sig), jax_run)):
        ts, to = tp.step(ts, x)
        frames += _assert_close(jo, to, js, ts, cfg.afc,
                                first_block=first and b == 0)
    return ts, frames


def _run_both(cfg, sig):
    return _port_run(cfg, sig, _jax_run(cfg, sig))


def _rs41(n_frames, serial="S1234567"):
    return RS41Modulator().modulate(
        [RS41Truth(serial=serial, frame_no=i) for i in range(n_frames)],
        fs=FS)


# --- the plain-op path (tests/test_afc.py:38-50, 121-146) --------------------

def test_plain_path_tracks_a_drifting_rs41():
    """A carrier drifting 1 -> 6.5 kHz on the plain-op path: both packages
    track it alike, and the tracked frequency ends near the ramp's end."""
    sig = _noisy(_drifting(_rs41(16), 1000.0, 6500.0), seed=0)
    cfg = jpipe.PipelineConfig(sonde="rs41", channels=1, block_len=BLOCK,
                               afc=True)
    ts, frames = _run_both(cfg, sig)
    assert frames >= 12
    assert 4000.0 < float(ts.aux[-1][0]) < 6500.0


def test_plain_path_holds_a_large_seed_offset():
    """A 20 kHz seed (|offset| > bandwidth/2, as bin_and_offset gives on the
    wideband path) is not pulled to the clamp, in both packages."""
    off = 20000.0
    sig = _noisy(_rotated(_rs41(8), [off]), seed=1, noise=0.0)
    cfg = jpipe.PipelineConfig(sonde="rs41", channels=1, block_len=BLOCK,
                               afc=True, fine_offsets=(off,))
    ts, frames = _run_both(cfg, sig)
    assert frames >= 5
    assert abs(float(ts.aux[-1][0]) - off) < 2500.0


# --- the kernel paths (JAX in interpret mode, 8 channels) --------------------

def test_k1_path_downconverts_off_grid_channels():
    """The K1 NRZ kernel path, fine offsets and AFC: 8 channels, each at its
    own offset within +/-7 kHz (beyond the 5 kHz channel filter without the
    DDC), 4 blocks; every channel decodes and holds its seed."""
    offs = tuple(float(f) for f in np.linspace(-7012.5, 6987.5, 8))
    sig = _noisy(_rotated(_rs41(10)[:4 * BLOCK], offs), seed=2)
    cfg = jpipe.PipelineConfig(sonde="rs41", channels=8, block_len=BLOCK,
                               use_pallas=True, afc=True, fine_offsets=offs)
    assert jpipe.Pipeline(cfg)._pallas
    ts, frames = _run_both(cfg, sig)
    assert frames >= 8 * 6
    assert np.abs(ts.aux[-1].numpy() - np.asarray(offs)).max() < 100.0


@pytest.fixture(scope="module")
def imet4_run():
    """The drifting iMet-4 of tests/test_afc.py:77-111 (0 -> 14 kHz,
    afc_max_hz 20 kHz) on 8 channels with their own noise, through the JAX
    package's AFSK kernel path: the config, the blocks, and the JAX state
    and output of each block."""
    iq = IMET4Modulator().modulate([IMET4Truth(frame_no=i) for i in range(16)],
                                   fs=FS)
    sig = _noisy(np.repeat(_drifting(iq, 0.0, 14000.0)[None], 8, axis=0),
                 seed=3, noise=0.03)
    cfg = jpipe.PipelineConfig(sonde="imet4", channels=8, block_len=BLOCK,
                               use_pallas=True, afc=True,
                               afc_max_hz=20000.0)
    assert jpipe.Pipeline(cfg)._pallas_afsk
    return cfg, sig, _jax_run(cfg, sig)


def test_afsk_path_tracks_a_drifting_imet4(imet4_run):
    """AFC on the AFSK kernel path (K1 at decim 1, then K8): the loop reads
    K1's block DC; the state is audio tail, DDC phase, tracked frequency."""
    cfg, sig, jax_run = imet4_run
    ts, frames = _port_run(cfg, sig, jax_run)
    assert [tuple(a.shape) for a in ts.aux] == [(8, 256), (8,), (8,)]
    assert frames >= 8 * 10
    f = ts.aux[-1].numpy()
    assert ((9000.0 < f) & (f < 14500.0)).all(), f


def test_jax_state_continues_in_the_port(imet4_run):
    """The JAX state after 2 blocks (audio tail, DDC phase and tracked
    frequency in aux) continues in the port: its next blocks equal the JAX
    package's own continuation."""
    cfg, sig, jax_run = imet4_run
    js = jax_run[1][0]
    ts = tpipe.state_from_numpy(js, CPU)
    assert len(ts.aux) == 3
    for a, b in zip(tpipe.state_to_numpy(ts).aux, js.aux):
        np.testing.assert_array_equal(a, b)
    _, frames = _port_run(cfg, sig[:, 2 * BLOCK:], jax_run[2:], ts=ts)
    assert frames > 0


def test_dualtone_path_tracks_an_m10_offset():
    """AFC on the dual-tone kernel path: K7 runs with want_afc and its
    envelope-rotation sums feed the loop; a fixed +800 Hz offset pulls the
    tracked frequency toward +800 Hz (tests/test_afc.py:179-204)."""
    iq = M10Modulator().modulate([M10Truth(frame_no=i) for i in range(30)],
                                 fs=FS)
    sig = _noisy(_rotated(iq, [800.0] * 8), seed=4)
    cfg = jpipe.PipelineConfig(sonde="m10", channels=8, block_len=BLOCK,
                               use_pallas=True, afc=True)
    assert jpipe.Pipeline(cfg)._pallas_dualtone
    ts, frames = _run_both(cfg, sig)
    assert frames > 0
    f = ts.aux[-1].numpy()
    assert ((400.0 < f) & (f < 1200.0)).all(), f


# --- the session's duties ----------------------------------------------------

def _telemetry_text(telem):
    return {k: json.dumps(t.to_dict(), sort_keys=True)
            for k, t in telem.items()}


def test_reset_channel_reseeds_one_afc_row():
    """tests/test_afc.py:207-230 in both packages: channel 0's tracked
    frequency walks away from its seed; reset_channel(0) puts it back and
    leaves channel 1's row alone; both sessions then decode on alike."""
    cfg = jpipe.PipelineConfig(sonde="rs41", channels=2, block_len=BLOCK,
                               afc=True, fine_offsets=(1500.0, -2000.0))
    js, ts = JaxSession(cfg), DecoderSession(cfg, CPU)
    sig = np.zeros((2, 4 * BLOCK), np.complex64)
    sig[0] = _noisy(_drifting(_rs41(8)[:4 * BLOCK], 1500.0, 5500.0),
                    seed=5)[0]
    blocks = _blocks(sig)
    for x in blocks[:3]:
        js.process_block(x)
        ts.process_block(x)
    np.testing.assert_allclose(ts.afc_freqs, js.afc_freqs, rtol=0,
                               atol=AFC_HZ)
    assert ts.afc_freqs[0] > 3000.0
    f1 = ts.afc_freqs[1]
    aux_before = [a.clone() for a in ts.state.aux]
    js.reset_channel(0)
    ts.reset_channel(0)
    assert ts.afc_freqs.dtype == np.float32
    assert ts.afc_freqs[0] == 1500.0 == js.afc_freqs[0]
    assert ts.afc_freqs[1] == f1
    assert torch.equal(ts.state.aux[0], aux_before[0])      # the phase
    assert 0 not in ts.telemetry
    js.process_block(blocks[3])
    ts.process_block(blocks[3])
    np.testing.assert_allclose(ts.afc_freqs, js.afc_freqs, rtol=0,
                               atol=AFC_HZ)
    assert _telemetry_text(ts.telemetry) == _telemetry_text(js.telemetry)
    assert DecoderSession(jpipe.PipelineConfig(
        sonde="rs41", channels=1, block_len=BLOCK), CPU).afc_freqs is None


def test_watchdog_resets_silent_channels():
    """Channel 1's sonde stops after 2 blocks: after more than 2 idle
    blocks the watchdog resets it (telemetry dropped) in both packages;
    channel 0 keeps decoding and is left alone."""
    cfg = jpipe.PipelineConfig(sonde="rs41", channels=2, block_len=BLOCK,
                               afc=True)
    sig = _noisy(np.stack([_rs41(12)[:6 * BLOCK]] * 2), seed=6)
    sig[1, 2 * BLOCK:] = 0
    js, ts = JaxSession(cfg), DecoderSession(cfg, CPU)
    resets = []
    for x in _blocks(sig):
        js.process_block(x)
        ts.process_block(x)
        got, want = ts.watchdog(2), js.watchdog(2)
        assert got == want
        resets.append(got)
    assert [1] in resets and all(0 not in r for r in resets)
    assert sorted(ts.telemetry) == [0]
    assert _telemetry_text(ts.telemetry) == _telemetry_text(js.telemetry)


def test_host_workers_match_one_worker_and_jax():
    """host_workers=4 decodes on the thread pool (16 or more valid frames
    a block) and gives the telemetry of host_workers=0 and of the JAX
    session, on 8 channels with three serials at their own fine offsets
    (the DDC without the AFC loop: its phase is aux[-1])."""
    serials = ["S1234567", "T7654321", "R0420042"]
    offs = tuple(float(-3000.0 + 750.0 * ch) for ch in range(8))
    rows = [_rs41(10, s)[37 * k:37 * k + 3 * BLOCK]
            for k, s in enumerate(serials)]
    sig = _noisy(_rotated(np.stack([rows[ch % 3] for ch in range(8)]), offs),
                 seed=7, noise=0.1)
    cfg = jpipe.PipelineConfig(sonde="rs41", channels=8, block_len=BLOCK,
                               fine_offsets=offs)
    js = JaxSession(cfg)
    one, four = DecoderSession(cfg, CPU), DecoderSession(cfg, CPU,
                                                         host_workers=4)
    calls = []
    parallel = four._decode_parallel
    four._decode_parallel = lambda *a: calls.append(1) or parallel(*a)
    for x in _blocks(sig):
        for s in (js, one, four):
            s.process_block(x)
        assert four.state.aux[0].shape == (8,)
    four.close()
    assert len(calls) >= 2
    want = _telemetry_text(js.telemetry)
    assert sorted(want) == list(range(8))
    assert _telemetry_text(one.telemetry) == want
    assert _telemetry_text(four.telemetry) == want
    assert four.metrics.frames_decoded == js.metrics.frames_decoded
    assert [four.telemetry[ch].serial for ch in range(8)] \
        == [serials[ch % 3] for ch in range(8)]


def test_decode_parallel_never_splits_a_channel():
    """The thread pool's row ranges are channel-aligned (each channel's
    decoder state has one writer) and their fragments come back in row
    order, for runs of rows per channel that the even split would cut."""
    class Recorder:
        def decode_byte_frames(self, frames, ch):
            calls.append(sorted(set(ch.tolist())))
            return [(int(c), int(f[0])) for c, f in zip(ch, frames)]

    cfg = jpipe.PipelineConfig(sonde="m10", channels=8, block_len=BLOCK,
                               use_pallas=True)
    sess = DecoderSession(cfg, CPU, host_workers=4)
    sess.decoder = Recorder()
    ch_idx = np.repeat(np.arange(6), [5, 1, 7, 2, 2, 3])
    frames = np.arange(ch_idx.size, dtype=np.uint8)[:, None]
    calls = []
    frags = sess._decode_parallel(frames, ch_idx, None, None, None, None)
    sess.close()
    assert frags == [(int(c), k) for k, c in enumerate(ch_idx)]
    seen = [c for chans in calls for c in chans]
    assert len(calls) > 1 and sorted(seen) == list(range(6))


# --- the fleet -----------------------------------------------------------------

N_BINS = 8
FS_WIDE = N_BINS * FS
# carriers off the PFB grid: (family, centre Hz)
OFFGRID = (("rs41", 1 * FS + 3100.0), ("m10", 3 * FS - 1450.0),
           ("dfm", -2 * FS + 4200.0))


def _offgrid_wideband():
    """The three carriers at their centres in one 8-bin stream, 3 blocks
    of back-to-back frames."""
    n = 3 * N_BINS * BLOCK
    sig = {"rs41": RS41Modulator().modulate(
        [RS41Truth(frame_no=40 + i) for i in range(6)], fs=FS_WIDE),
        "m10": M10Modulator().modulate(
            [M10Truth(frame_no=8 + i) for i in range(18)], fs=FS_WIDE),
        "dfm": DFMModulator().modulate(
            [DFMTruth(frame_no=2 + k) for k in range(14)], fs=FS_WIDE)}
    wide = np.zeros(n, np.complex64)
    for family, center in OFFGRID:
        x = freq_shift(sig[family][:n], center / FS_WIDE)
        wide[:x.size] += x
    return wide


def test_offgrid_fleet_matches_jax_fleet():
    """Carriers off the grid, each mapped to its bin and residual by the
    port's bin_and_offset, afc on: the port's fleet (pipelined) gives the
    JAX fleet's (use_pallas=True) telemetry and tracked frequencies."""
    wide = _offgrid_wideband()
    plan = [(*bin_and_offset(c, FS, N_BINS), f) for f, c in OFFGRID]
    assert all(off != 0.0 for _, off, _ in plan)
    jf = JaxFleet([JaxChannel(k, f, off) for k, off, f in plan], N_BINS,
                  use_pallas=True, afc=True)
    tf = FleetSession([FleetChannel(k, f, off) for k, off, f in plan],
                      N_BINS, CPU, afc=True, pipelined=True)
    w = N_BINS * BLOCK
    for i in range(0, wide.size, w):
        jf.process_wideband(wide[i:i + w])
        tf.process_wideband(wide[i:i + w])
    tf.flush()
    want = _telemetry_text(jf.telemetry)
    assert _telemetry_text(tf.telemetry) == want
    assert [tf.telemetry[i].serial for i in range(3)] \
        == ["S1234567", "910-2-12345", "1234567"]
    for family, (idxs, sess) in tf.groups.items():
        jsess = jf.groups[family][1]
        assert sess.config.fine_offsets[0] == plan[idxs[0]][1]
        # not the pad rows: they repeat the group's first bin without its
        # offset, so they carry no centred signal
        np.testing.assert_allclose(sess.afc_freqs[:len(idxs)],
                                   jsess.afc_freqs[:len(idxs)], rtol=0,
                                   atol=AFC_HZ)
