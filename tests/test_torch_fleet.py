"""The port's mixed fleet against the JAX package's FleetSession.

An rs41, an m10 and a dfm sonde in three PFB bins of one 8-bin wideband
stream (the signal of tests/test_fleet.py) go through the port's
FleetSession (plain twins on the CPU) and the JAX FleetSession with
use_pallas=True (Pallas kernels in interpret mode). The telemetry per
logical channel must be identical.
"""

import json

import numpy as np
import pytest
import torch

from sondetpu.runtime.fleet import FleetChannel as JaxChannel
from sondetpu.runtime.fleet import FleetSession as JaxFleet
from sondetpu_torch.parallel import make_mesh
from sondetpu_torch.runtime import pipeline as tpipe
from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession
from sondetpu_torch.sondes.dfm import DFMModulator, DFMTruth
from sondetpu_torch.sondes.ims100 import IMS100Modulator, IMS100Truth
from sondetpu_torch.sondes.m10 import M10Modulator, M10Truth
from sondetpu_torch.sondes.modulate import freq_shift, gfsk_modulate
from sondetpu_torch.sondes.mrzn1 import MRZN1Modulator, MRZN1Truth
from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

N_BINS = 8
FS_WIDE = N_BINS * 48000.0
PLAN = ((1, "rs41"), (3, "m10"), (6, "dfm"))


def _narrowband_at_wideband(bits, chip_rate, dev, f_center, bt=0.5):
    iq = gfsk_modulate(bits, FS_WIDE / chip_rate, dev / FS_WIDE, bt=bt)
    return freq_shift(iq, f_center / FS_WIDE)


def _wideband(centers):
    rs41 = RS41Modulator()
    sig = [_narrowband_at_wideband(rs41.frames_to_bits(np.stack(
        [rs41.build_frame(RS41Truth(frame_no=40 + i)) for i in range(3)])),
        4800.0, 2400.0, centers[1])]
    m10 = M10Modulator()
    sig.append(_narrowband_at_wideband(m10.frames_to_chips(np.stack(
        [m10.build_frame(M10Truth(frame_no=8 + i)) for i in range(10)])),
        9600.0, 12000.0, centers[3], bt=0.7))
    dfm = DFMModulator()
    sig.append(_narrowband_at_wideband(dfm.frames_to_chips(np.stack(
        [dfm.build_frame(DFMTruth(frame_no=2 + k), k) for k in range(8)])),
        2500.0, 2500.0, centers[6]))
    w = N_BINS * 48000
    n = max(s.size for s in sig)
    wide = np.zeros(((n + w - 1) // w) * w, np.complex64)
    for s in sig:
        wide[:s.size] += s
    return wide, w


@pytest.fixture(scope="module")
def wideband():
    return _wideband(FleetSession([FleetChannel(1, "rs41")], N_BINS, "cpu")
                     .pfb.center_freqs(FS_WIDE))


def _telemetry_text(telem):
    return {k: json.dumps(t.to_dict(), sort_keys=True)
            for k, t in telem.items()}


@pytest.fixture(scope="module")
def jax_reference(wideband):
    """The JAX fleet (use_pallas=True) over the stream, not pipelined: the
    updates of each block and the telemetry after it."""
    wide, w = wideband
    fleet = JaxFleet([JaxChannel(b, s) for b, s in PLAN], N_BINS,
                     use_pallas=True)
    updates, telem = [], []
    for i in range(0, wide.size, w):
        updates.append(fleet.process_wideband(wide[i:i + w]))
        telem.append(_telemetry_text(fleet.telemetry))
    return updates, telem


@pytest.mark.parametrize("pipelined", [False, True])
def test_fleet_matches_jax_fleet(wideband, jax_reference, pipelined):
    """Same updates and telemetry per logical channel as the JAX fleet,
    block by block (pipelined: one block later, and flush recovers the
    last block); pad rows never surface; each group is padded to a
    multiple of 8 only."""
    wide, w = wideband
    want_updates, want_telem = jax_reference
    got_updates = []
    port = FleetSession([FleetChannel(b, s) for b, s in PLAN], N_BINS, "cpu",
                        pipelined=pipelined,
                        on_update=lambda ch, s, t: got_updates.append((ch, s)))
    assert {s: sess.config.channels for s, (_, sess) in port.groups.items()} \
        == {"rs41": 8, "m10": 8, "dfm": 8}
    assert port.groups["m10"][1].pipeline._dualtone
    lag = int(pipelined)
    for b, i in enumerate(range(0, wide.size, w)):
        got = port.process_wideband(wide[i:i + w])
        if b < lag:
            assert got == 0 and port.telemetry == {}
        else:
            assert got == want_updates[b - lag]
            assert _telemetry_text(port.telemetry) == want_telem[b - lag]
    assert port.flush() == (want_updates[-1] if pipelined else 0)
    assert port.flush() == 0
    telem = port.telemetry
    assert _telemetry_text(telem) == want_telem[-1]
    assert set(telem) == {0, 1, 2}
    assert telem[0].serial == "S1234567"
    assert telem[1].serial == "910-2-12345"
    assert telem[2].serial == "1234567"
    assert telem[1].lat == pytest.approx(52.2, abs=1e-4)
    assert {ch for ch, _ in got_updates} == {0, 1, 2}
    assert {s for _, s in got_updates} == {"rs41", "m10", "dfm"}


@pytest.mark.parametrize("pipelined", [False, True])
def test_unfused_fleet_matches_fused_and_jax(wideband, jax_reference,
                                             pipelined):
    """fused=False (the original's per-group path, tests/test_fleet.py:339):
    PFB, then each group's row gather and process_block, with ``pipelined``
    passed on to the group sessions. Block by block the same updates and
    telemetry as the port's fused step and the JAX fleet; flush drains
    every group's session."""
    wide, w = wideband
    want_updates, want_telem = jax_reference
    chans = [FleetChannel(b, s) for b, s in PLAN]
    unfused = FleetSession(chans, N_BINS, "cpu", pipelined=pipelined,
                           fused=False)
    fused = FleetSession(chans, N_BINS, "cpu", pipelined=pipelined)
    assert fused._fused and not unfused._fused
    assert all(sess.pipelined is pipelined
               for _, sess in unfused.groups.values())
    lag = int(pipelined)
    for b, i in enumerate(range(0, wide.size, w)):
        got = unfused.process_wideband(wide[i:i + w])
        assert got == fused.process_wideband(wide[i:i + w])
        text = _telemetry_text(unfused.telemetry)
        assert text == _telemetry_text(fused.telemetry)
        if b >= lag:
            assert got == want_updates[b - lag]
            assert text == want_telem[b - lag]
    last = want_updates[-1] if pipelined else 0
    assert unfused.flush() == fused.flush() == last
    assert unfused.flush() == 0
    assert _telemetry_text(unfused.telemetry) == want_telem[-1]


def test_fleet_step_is_one_packed_buffer(wideband):
    """The device step returns every group's packed buffer concatenated,
    in group order, and the frames of each group."""
    wide, w = wideband
    fleet = FleetSession([FleetChannel(b, s) for b, s in PLAN], N_BINS, "cpu")
    planes = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        wide[:w].real, wide[:w].imag)]
    packed, frames = fleet.step(*planes)
    sizes = [sess.config.channels * sess.config.packed_row_bytes
             for _, _, sess in fleet._order]
    assert packed.dtype == torch.uint8 and packed.numel() == sum(sizes)
    assert [f.shape[0] for f in frames] == [8, 8, 8]
    assert fleet.process_wideband(tuple(planes)) >= 0


def test_fleet_refuses_what_is_not_ported():
    """Nothing is refused: a mesh fleet is built (a group of one channel,
    which does not divide into the 8-way mesh, stays on the device with no
    pad rows, as in the original's mesh fleet). Configs the port once
    refused take the route the original's gates pick: m10's 100-sample
    block (below the kernels' carried tail) the plain-op front end, with
    no pad rows; an ims100
    group at 48.1 kHz (sps 20.04) K7 and linear_interp, or with
    use_pallas=False the plain-op front end and linear_interp. afc and
    offset_hz below the grid (the groups' DDC and AFC loop) are taken and
    reach each group's config, pad rows on the grid."""
    chans = [FleetChannel(1, "rs41")]
    fleet = FleetSession(chans, N_BINS, "cpu",
                         mesh=make_mesh(devices=[torch.device("cpu")] * 8))
    assert fleet._fused_mesh and fleet._mp_local == ["rs41"]
    assert fleet.groups["rs41"][1].mesh is None
    assert fleet.groups["rs41"][1].config.channels == 1
    fleet = FleetSession([FleetChannel(3, "m10")], N_BINS, "cpu",
                         block_len=100)
    pipe = fleet.groups["m10"][1].pipeline
    assert pipe._plain and pipe.config.channels == 1
    for use_pallas, route in ((True, "dualtone"), (False, None)):
        fleet = FleetSession([FleetChannel(2, "ims100")], N_BINS, "cpu",
                             fs_chan=48100.0, block_len=48100,
                             use_pallas=use_pallas)
        pipe = fleet.groups["ims100"][1].pipeline
        assert pipe._route == route
        assert tpipe._rational_sps(pipe.config) is None
        assert not float(pipe.config.sps).is_integer()
    fleet = FleetSession(chans, N_BINS, "cpu", afc=True)
    cfg = fleet.groups["rs41"][1].config
    assert cfg.afc and cfg.fine_offsets is None
    fleet = FleetSession([FleetChannel(1, "rs41", offset_hz=300.0)], N_BINS,
                         "cpu")
    cfg = fleet.groups["rs41"][1].config
    assert not cfg.afc and cfg.fine_offsets == (300.0,) + (0.0,) * 7


# --- ims100 and mrzn1 beside rs41 ----------------------------------------------

N_BINS_16 = 16
FS_16 = N_BINS_16 * 48000.0
PLAN_16 = ((2, "rs41"), (5, "ims100"), (13, "mrzn1"))


def _wideband_16():
    """2 blocks of a 16-bin stream: rs41, ims100 and mrzn1 frames, each
    from the port's modulator at the wideband rate, at the centres of bins
    2, 5 and 13 (-3), plus seeded noise of std 0.02."""
    n = 2 * N_BINS_16 * 48000
    sig = {"rs41": RS41Modulator().modulate(
        [RS41Truth(frame_no=40 + i) for i in range(5)], fs=FS_16),
        "ims100": IMS100Modulator().modulate(
            [IMS100Truth(frame_no=6 + i) for i in range(10)], fs=FS_16),
        "mrzn1": MRZN1Modulator().modulate(
            [MRZN1Truth(frame_no=3 + i) for i in range(20)], fs=FS_16)}
    centers = FleetSession([FleetChannel(1, "rs41")], N_BINS_16,
                           "cpu").pfb.center_freqs(FS_16)
    wide = np.zeros(n, np.complex64)
    for k, family in PLAN_16:
        x = freq_shift(sig[family][:n], centers[k] / FS_16)
        wide[:x.size] += x
    rng = np.random.default_rng(16)
    return wide + (0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
                   ).astype(np.complex64)


@pytest.mark.parametrize("afc", [False, True])
def test_fleet_with_ims100_and_mrzn1_matches_jax_fleet(afc):
    """A 16-bin fleet with ims100 and mrzn1 carriers beside rs41, with and
    without afc: block by block the same updates and telemetry as the JAX
    fleet (use_pallas=True); ims100 and mrzn1 run K7's channel-filter body
    with midpoint DC (its twin here); every carrier reports its serial;
    with afc the tracked frequencies of the carriers' rows within 0.05 Hz
    of JAX's (K7's rotation sums are summed in another order)."""
    wide = _wideband_16()
    w = N_BINS_16 * 48000
    jf = JaxFleet([JaxChannel(b, s) for b, s in PLAN_16], N_BINS_16,
                  use_pallas=True, afc=afc)
    tf = FleetSession([FleetChannel(b, s) for b, s in PLAN_16], N_BINS_16,
                      "cpu", afc=afc)
    for sonde in ("ims100", "mrzn1"):
        pipe = tf.groups[sonde][1].pipeline
        assert pipe._dualtone and not pipe._skip_chanfilt and pipe._midpoint
    for i in range(0, wide.size, w):
        assert (tf.process_wideband(wide[i:i + w])
                == jf.process_wideband(wide[i:i + w]))
        assert _telemetry_text(tf.telemetry) == _telemetry_text(jf.telemetry)
    assert [tf.telemetry[i].serial for i in range(3)] \
        == ["S1234567", "2136051", "MRZ-042"]
    if afc:
        for family, (idxs, sess) in tf.groups.items():
            np.testing.assert_allclose(
                sess.afc_freqs[:len(idxs)],
                jf.groups[family][1].afc_freqs[:len(idxs)], rtol=0, atol=0.05)
