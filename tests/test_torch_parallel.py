"""The port's multi-device layer (sondetpu_torch.parallel) against the JAX
package's on the CPU.

The port's meshes are [cpu] * 8 (8-way) and the same devices as a
('host', 'chip') = (2, 4) mesh; the JAX package runs on the virtual
8-device CPU mesh of tests/conftest.py. Inputs are made with numpy from a
seed (the port's modulators, seeded noise, cs16).

- The channel-sharded step equals the port's unsharded step exactly: the
  packed buffer, frame_valid and every leaf of the merged state.
- It matches the JAX mesh step to the standard that tests/
  test_torch_plain_path.py and tests/test_torch_afc.py hold the unsharded
  port to JAX: validity, RS verdicts and valid-slot bytes exactly,
  soft_rms within rtol 1e-5 in float32 (bfloat16: 2**-7, one ulp), the
  AFC-tracked frequency within 0.05 Hz, telemetry identical.
- The time-sharded FIR and front end equal the JAX package's within
  tests/test_parallel.py's 2e-4.
"""

import json
import logging

import numpy as np
import pytest
import torch

from sondetpu.parallel import fanin as jfanin
from sondetpu.parallel import make_mesh as jax_make_mesh
from sondetpu.parallel import sharded_pipeline_step as jax_sharded_step
from sondetpu.parallel import time_parallel_fir as jax_tp_fir
from sondetpu.parallel import time_parallel_frontend as jax_tp_frontend
from sondetpu.runtime import pipeline as jpipe
from sondetpu.runtime.fleet import FleetChannel as JaxChannel
from sondetpu.runtime.fleet import FleetSession as JaxFleet
from sondetpu.runtime.session import DecoderSession as JaxSession
from sondetpu_torch.dsp.fir import apply_windows, design_lowpass
from sondetpu_torch.parallel import (fanin, frontend_serial, make_mesh,
                                     shard_channels, sharded_pipeline_step,
                                     time_parallel_fir,
                                     time_parallel_frontend)
from sondetpu_torch.parallel.sharding import Shards, channel_shards
from sondetpu_torch.runtime import checkpoint
from sondetpu_torch.runtime import pipeline as tpipe
from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession
from sondetpu_torch.runtime.session import DecoderSession
from sondetpu_torch.sondes.m10 import M10Modulator, M10Truth
from sondetpu_torch.sondes.modulate import freq_shift, gfsk_modulate
from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth
from sondetpu_torch.telemetry import SondeTelemetry
from test_torch_afc import (AFC_HZ, _blocks, _noisy, _rotated, _rs41,
                            _telemetry_text)
from test_torch_plain_path import _planes
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

CPU = torch.device("cpu")
BLOCK = 48000
MESHES = {"8way": (("chip",), None), "2x4": (("host", "chip"), (2, 4))}
OFFSETS = (0.0, 150.0, -150.0, 300.0, -300.0, 450.0, -450.0, 600.0)


def _port_mesh(name):
    axes, shape = MESHES[name]
    return make_mesh(axes, shape, devices=[CPU] * 8)


def _jax_mesh(name):
    axes, shape = MESHES[name]
    return jax_make_mesh(axes, shape)


_leaves = tpipe._state_leaves


def _updates_text(updates):
    """(channel, telemetry) updates as text (NaN fields compare equal)."""
    return [(c, json.dumps(t.to_dict(), sort_keys=True)) for c, t in updates]


def test_every_public_name_has_a_counterpart():
    import sondetpu.parallel as jpar
    import sondetpu_torch.parallel as tpar
    assert tpar.__all__ == jpar.__all__
    assert all(callable(getattr(tpar, n)) for n in jpar.__all__)


def test_make_mesh_shapes():
    mesh = _port_mesh("8way")
    assert mesh.shape == {"chip": 8} and mesh.devices.size == 8
    assert all(d == CPU for d in mesh.devices.flat)
    assert (mesh.ranks == 0).all()
    mesh2 = _port_mesh("2x4")
    assert mesh2.shape == {"host": 2, "chip": 4}
    assert mesh2.devices.shape == (2, 4) and mesh2.axis_names == ("host",
                                                                  "chip")
    assert mesh2.shape == _jax_mesh("2x4").shape
    with pytest.raises(ValueError):
        make_mesh(("host", "chip"), devices=[CPU] * 8)       # no shape
    with pytest.raises(ValueError):
        make_mesh(("host", "chip"), (2, 3), devices=[CPU] * 8)
    if torch.cuda.is_available():
        assert make_mesh().devices.size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_channel_layout_is_the_named_sharding_one():
    """Contiguous slabs in row-major device order over the channel axes;
    on a 2-D mesh sharded over one axis, the other replicates (each shard
    held once)."""
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    sh = shard_channels(x, _port_mesh("2x4"), ("host", "chip"))
    assert sh.starts == tuple(range(0, 16, 2)) and sh.channels == 16
    np.testing.assert_array_equal(torch.cat(sh.parts).numpy(), x)
    assert channel_shards(_port_mesh("2x4"), "host")[0] == 2
    sh = shard_channels(torch.from_numpy(x), _port_mesh("2x4"), "host")
    assert sh.starts == (0, 8) and [tuple(p.shape) for p in sh.parts] == \
        [(8, 3), (8, 3)]
    rows = torch.tensor([5, 1, 2, 0])
    sh = shard_channels(torch.from_numpy(x), _port_mesh("8way"), "chip",
                        rows=rows[:, None].expand(4, 2).reshape(-1))
    np.testing.assert_array_equal(torch.cat(sh.parts).numpy(),
                                  x[[5, 5, 1, 1, 2, 2, 0, 0]])
    with pytest.raises(ValueError, match="do not split"):
        shard_channels(x[:12], _port_mesh("8way"))


def _case_config(case):
    sonde, dtype, afc = {"rs41-f32": ("rs41", "f32", False),
                         "rs41-bf16": ("rs41", "bf16", False),
                         "m10-f32": ("m10", "f32", False),
                         "rs41-afc": ("rs41", "f32", True)}[case]
    kw = dict(afc=True, fine_offsets=OFFSETS) if afc else {}
    return jpipe.PipelineConfig(sonde=sonde, channels=8, block_len=BLOCK,
                                compute_dtype=dtype, input_dtype="i16", **kw)


def _case_planes(case, cfg):
    """int16 planes [8, 2 blocks]: three serials (tests/
    test_torch_plain_path.py's _planes); for the AFC case one rs41 signal,
    each row off its channel centre by its fine offset."""
    if not cfg.afc:
        qi, qq = _planes(cfg.sonde, 8)
        return qi[:, :2 * BLOCK], qq[:, :2 * BLOCK]
    iq = _noisy(_rotated(_rs41(6)[:2 * BLOCK], OFFSETS), seed=3)
    return (np.clip(iq.real * 32767, -32768, 32767).astype(np.int16),
            np.clip(iq.imag * 32767, -32768, 32767).astype(np.int16))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", ["rs41-f32", "rs41-bf16", "m10-f32",
                                  "rs41-afc"])
def test_sharded_step_matches_unsharded_and_jax(case, mesh_name):
    cfg = _case_config(case)
    qi, qq = _case_planes(case, cfg)
    tp = tpipe.Pipeline(cfg, CPU)
    step, shard = sharded_pipeline_step(tp, _port_mesh(mesh_name))
    jp = jpipe.Pipeline(cfg)
    jstep, jshard = jax_sharded_step(jp, _jax_mesh(mesh_name))
    s0, s1, js = tp.init_state(), shard(tp.init_state()), jshard(jp.init_state())
    assert len(s1.parts) == 8 and s1.starts == tuple(range(8))
    if cfg.sonde == "m10":
        assert s1.parts[0].fir.tail.shape[0] == 4      # the [4C] tail
    frames = 0
    for b in range(2):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        pi, pq = np.ascontiguousarray(qi[:, sl]), np.ascontiguousarray(qq[:, sl])
        s0, o0 = tp.step(s0, (pi, pq))
        s1, o1 = step(s1, shard(pi), shard(pq))
        js, jo = jstep(js, jshard(pi), jshard(pq))
        # the port's sharded step is its unsharded step, bit for bit
        packed = torch.cat([o.packed for o in o1.parts])
        valid = torch.cat([o.frame_valid for o in o1.parts])
        assert torch.equal(packed, o0.packed)
        assert torch.equal(valid, o0.frame_valid)
        for a, c in zip(_leaves(tpipe.merge_state(s1.parts)), _leaves(s0)):
            assert a.dtype == c.dtype and torch.equal(a, c)
        # and matches the JAX mesh step
        jv = np.asarray(jo.frame_valid)
        tv = valid.numpy()
        np.testing.assert_array_equal(tv, jv)
        frames_t = torch.cat([o.frames for o in o1.parts]).numpy()
        np.testing.assert_array_equal(frames_t[tv], np.asarray(jo.frames)[jv])
        np.testing.assert_array_equal(
            torch.cat([o.rs_clean for o in o1.parts]).numpy(),
            np.asarray(jo.rs_clean))
        t_un = tpipe.unpack_block_output(packed.numpy(), cfg.k_slots,
                                         cfg.wire_ncols, cfg.chase_total)
        j_un = jpipe.unpack_block_output(np.asarray(jo.packed), cfg.k_slots,
                                         cfg.wire_ncols, cfg.chase_total)
        np.testing.assert_array_equal(t_un[0][tv], j_un[0][jv])
        np.testing.assert_array_equal(t_un[1], j_un[1])
        np.testing.assert_array_equal(t_un[2], j_un[2])
        rtol = 2.0 ** -7 if cfg.compute_dtype == "bf16" else 1e-5
        np.testing.assert_allclose(t_un[3], j_un[3], rtol=rtol)
        if cfg.afc:
            np.testing.assert_allclose(
                torch.cat([s.aux[-1] for s in s1.parts]).numpy(),
                np.asarray(js.aux[-1]), rtol=0, atol=AFC_HZ)
        frames += int(jv.sum())
    assert frames >= 8


def test_kernel_route_on_one_channel_shards():
    """use_pallas on 8 channels takes the kernel route (K1-K3; on the CPU
    their plain twins); on an 8-way mesh every 1-channel shard keeps that
    route (its own config would fail the channels % 8 gate) and the
    sharded step equals the unsharded one exactly."""
    cfg = tpipe.PipelineConfig(sonde="rs41", channels=8, block_len=BLOCK,
                               use_pallas=True, input_dtype="i16")
    one = tpipe.PipelineConfig(sonde="rs41", channels=1, block_len=BLOCK,
                               use_pallas=True, input_dtype="i16")
    assert tpipe._route(cfg) == "fused" and tpipe._route(one) is None
    assert tpipe.Pipeline(one, CPU, shard_of=cfg)._route == "fused"
    qi, qq = _planes("rs41", 8)
    tp = tpipe.Pipeline(cfg, CPU)
    step, shard = sharded_pipeline_step(tp, _port_mesh("8way"))
    s0, s1 = tp.init_state(), shard(tp.init_state())
    assert s1.parts[0].chan_tail_i.shape == (1, tpipe.HALO)
    for b in range(3):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        s0, o0 = tp.step(s0, (qi[:, sl], qq[:, sl]))
        s1, o1 = step(s1, qi[:, sl], qq[:, sl])
        assert torch.equal(torch.cat([o.packed for o in o1.parts]), o0.packed)
        assert o0.frame_valid.any()
    for a, c in zip(_leaves(tpipe.merge_state(s1.parts)), _leaves(s0)):
        assert torch.equal(a, c)


def test_shard_and_merge_state_layouts():
    """shard_state takes channel c's rows p * C + c of the dual-tone FIR
    tail's four planes, and every shard the jnp AFSK front end's shared LO
    counter whole; merge_state undoes both."""
    for sonde, kw in (("m10", {}), ("imet4", dict(afc=True))):
        cfg = tpipe.PipelineConfig(sonde=sonde, channels=8, block_len=BLOCK,
                                   **kw)
        st = tpipe.Pipeline(cfg, CPU).init_state()
        st = tpipe._from_leaves(st, [
            torch.arange(t.numel(), dtype=torch.float64).reshape(t.shape)
            .to(t.dtype) for t in _leaves(st)])
        parts = [tpipe.shard_state(st, lo, lo + 2) for lo in range(0, 8, 2)]
        if sonde == "m10":
            assert torch.equal(parts[1].fir.tail,
                               st.fir.tail[[2, 3, 10, 11, 18, 19, 26, 27]])
        else:
            assert all(torch.equal(p.aux[4], st.aux[4]) for p in parts)
            assert parts[0].aux[4].shape == (1,)
        for a, c in zip(_leaves(tpipe.merge_state(parts)), _leaves(st)):
            assert torch.equal(a, c)


def _rs41_rows(n_blocks, serials=("S1234567",), seed=1):
    """complex [8, n_blocks * BLOCK]: channel ch carries serials[ch % k]."""
    rows = [_noisy(_rs41(4 * n_blocks, s)[:n_blocks * BLOCK], seed=seed + k)
            for k, s in enumerate(serials)]
    return np.concatenate([rows[ch % len(rows)] for ch in range(8)])


def test_sharded_session_decodes_s1234567():
    """DecoderSession over the (2, 4) mesh decodes every channel, as the
    unsharded session and the JAX mesh session do (telemetry identical);
    the fan-in is this session's view; the mesh holds every channel."""
    cfg = jpipe.PipelineConfig(sonde="rs41", channels=8, block_len=BLOCK)
    sig = _rs41_rows(3, ("S1234567", "T7654321"))
    tm = DecoderSession(cfg, CPU, mesh=_port_mesh("2x4"))
    tu = DecoderSession(cfg, CPU)
    jm = JaxSession(cfg, mesh=_jax_mesh("2x4"))
    assert isinstance(tm.state, Shards) and tm.local_channels() == list(
        range(8))
    for x in _blocks(sig):
        assert _updates_text(tm.process_block(x)) == \
            _updates_text(tu.process_block(x))
        jm.process_block(x)
    assert len(tm.telemetry) == 8 and tm.telemetry[0].serial == "S1234567"
    assert tm.telemetry[1].serial == "T7654321"
    assert _telemetry_text(tm.telemetry) == _telemetry_text(jm.telemetry) \
        == _telemetry_text(tu.telemetry)
    fan = tm.telemetry_fanin()
    assert fan == jm.telemetry_fanin()
    assert set(fan) == set(range(8))
    assert fan[0]["lat"] == pytest.approx(45.0, abs=1e-4)
    assert tm.metrics_fanin() == jm.metrics_fanin()
    assert tm.metrics_fanin()["frames_decoded"] >= 8


def test_pipelined_mesh_session_with_host_workers():
    """pipelined (updates one block late, flush at the end) and
    host_workers on a mesh session give the unsharded session's updates."""
    cfg = jpipe.PipelineConfig(sonde="rs41", channels=8, block_len=BLOCK)
    sig = _rs41_rows(3, ("S1234567", "T7654321", "R0420042"))
    tm = DecoderSession(cfg, CPU, mesh=_port_mesh("8way"), pipelined=True,
                        host_workers=2)
    tu = DecoderSession(cfg, CPU, pipelined=True)
    for x in _blocks(sig):
        assert _updates_text(tm.process_block(x)) == \
            _updates_text(tu.process_block(x))
    assert _updates_text(tm.flush()) == _updates_text(tu.flush())
    assert _telemetry_text(tm.telemetry) == _telemetry_text(tu.telemetry)
    assert len(tm.telemetry) == 8
    tm.close()


def test_sharded_session_reset_and_watchdog():
    """On the 8-way mesh with afc: reset_channel reseeds only the owner
    shard's row (the other shards untouched), the watchdog resets the
    channel whose sonde stopped, and the session stays equal to the
    unsharded one and to the JAX mesh session."""
    cfg = jpipe.PipelineConfig(sonde="rs41", channels=8, block_len=BLOCK,
                               afc=True, fine_offsets=OFFSETS)
    sig = _noisy(_rotated(_rs41(20)[:5 * BLOCK], OFFSETS), seed=4)
    sig[5, 2 * BLOCK:] = 0
    tm = DecoderSession(cfg, CPU, mesh=_port_mesh("8way"))
    tu = DecoderSession(cfg, CPU)
    jm = JaxSession(cfg, mesh=_jax_mesh("8way"))
    blocks = _blocks(sig)
    for x in blocks[:2]:
        for s in (tm, tu, jm):
            s.process_block(x)
    before = [p.aux[-1].clone() for p in tm.state.parts]
    for s in (tm, tu, jm):
        s.reset_channel(3)
    assert tm.afc_freqs[3] == np.float32(OFFSETS[3]) == jm.afc_freqs[3]
    assert all(torch.equal(p.aux[-1], b) for j, (p, b)
               in enumerate(zip(tm.state.parts, before)) if j != 3)
    np.testing.assert_array_equal(tm.afc_freqs, tu.afc_freqs)
    resets = []
    for x in blocks[2:]:
        for s in (tm, tu, jm):
            s.process_block(x)
        got = tm.watchdog(2)
        assert got == tu.watchdog(2) == jm.watchdog(2)
        resets.append(got)
    assert [5] in resets and 5 not in tm.telemetry
    np.testing.assert_array_equal(tm.afc_freqs, tu.afc_freqs)
    np.testing.assert_allclose(tm.afc_freqs, jm.afc_freqs, rtol=0,
                               atol=AFC_HZ)
    assert _telemetry_text(tm.telemetry) == _telemetry_text(tu.telemetry) \
        == _telemetry_text(jm.telemetry)


def test_checkpoints_between_mesh_and_unsharded(tmp_path):
    """A mesh session saves its merged state: loaded into an unsharded
    session (and an unsharded checkpoint into a mesh session) it goes on
    with the uninterrupted run's output, block for block."""
    cfg = jpipe.PipelineConfig(sonde="rs41", channels=8, block_len=BLOCK,
                               compute_dtype="bf16")
    blocks = _blocks(_rs41_rows(4, ("S1234567", "R0420042")))
    ref = DecoderSession(cfg, CPU)
    ref_ups = [_updates_text(ref.process_block(x)) for x in blocks]
    for first, second in ((_port_mesh("2x4"), None),
                          (None, _port_mesh("8way"))):
        a = DecoderSession(cfg, CPU, mesh=first)
        for x in blocks[:2]:
            a.process_block(x)
        path = str(tmp_path / f"session_{first is not None}.ckpt")
        checkpoint.save_session(a, path)
        b = DecoderSession(cfg, CPU, mesh=second)
        checkpoint.load_session(b, path)
        assert isinstance(b.state, Shards) == (second is not None)
        for x, want in zip(blocks[2:], ref_ups[2:]):
            assert _updates_text(b.process_block(x)) == want
        assert _telemetry_text(b.telemetry) == _telemetry_text(ref.telemetry)


def _fleet_wideband(n_bins, plan):
    """tests/test_fleet.py:83-131's stream: rs41 and m10 carriers at the
    PFB centres of ``plan``'s bins."""
    fs_wide = n_bins * 48000.0
    centers = FleetSession([FleetChannel(1, "rs41")], n_bins,
                           CPU).pfb.center_freqs(fs_wide)
    rs41 = RS41Modulator()
    bits = rs41.frames_to_bits(np.stack(
        [rs41.build_frame(RS41Truth(frame_no=30 + i)) for i in range(3)]))
    m10 = M10Modulator()
    chips = m10.frames_to_chips(np.stack(
        [m10.build_frame(M10Truth(frame_no=8 + i)) for i in range(10)]))
    sigs = []
    for b, s in plan:
        x = (gfsk_modulate(bits, fs_wide / 4800.0, 2400.0 / fs_wide, bt=0.5)
             if s == "rs41" else
             gfsk_modulate(chips, fs_wide / 9600.0, 12000.0 / fs_wide, bt=0.7))
        sigs.append(freq_shift(x, centers[b] / fs_wide))
    w = n_bins * 48000
    wide = np.zeros(((max(x.size for x in sigs) + w - 1) // w) * w,
                    np.complex64)
    for x in sigs:
        wide[:x.size] += x
    return wide, w


def test_mesh_fleet_matches_jax_and_the_unsharded_fleet(tmp_path):
    """tests/test_fleet.py:83-131 in both packages: 16 rs41 channels (the
    group shards 8-way: _mp_order) and 1 m10 channel (stays on the
    device: _mp_local) in a 32-bin stream. The mesh fleet's telemetry
    equals the JAX mesh fleet's, and its updates and telemetry the port's
    unsharded fused fleet's."""
    plan = [(1 + k, "rs41") for k in range(16)] + [(20, "m10")]
    wide, w = _fleet_wideband(32, plan)
    mk = [FleetChannel(b, s) for b, s in plan]
    tm = FleetSession(mk, 32, CPU, mesh=_port_mesh("8way"), use_pallas=False)
    tu = FleetSession(mk, 32, CPU, use_pallas=False)
    jm = JaxFleet([JaxChannel(b, s) for b, s in plan], 32,
                  mesh=_jax_mesh("8way"))
    assert tm._fused_mesh and not tm._fused
    assert [g[0] for g in tm._mp_order] == ["rs41"] and tm._mp_local == ["m10"]
    assert tm.groups["rs41"][1].mesh is not None
    assert tm.groups["m10"][1].mesh is None
    assert tm.groups["m10"][1].config.channels == 1          # no pad rows
    for i in range(0, wide.size, w):
        assert tm.process_wideband(wide[i:i + w]) == \
            tu.process_wideband(wide[i:i + w])
        jm.process_wideband(wide[i:i + w])
    telem = tm.telemetry
    assert sorted(telem) == list(range(17))
    assert all(telem[k].serial == "S1234567" for k in range(16))
    assert telem[16].serial == "910-2-12345"
    assert _telemetry_text(telem) == _telemetry_text(jm.telemetry) \
        == _telemetry_text(tu.telemetry)
    # checkpoints: the mesh fleet's into an unsharded fleet and the
    # unsharded fleet's into a mesh fleet carry every group's state
    checkpoint.save_fleet(tm, str(tmp_path / "mesh.ckpt"))
    checkpoint.save_fleet(tu, str(tmp_path / "unsharded.ckpt"))
    back = FleetSession(mk, 32, CPU, use_pallas=False)
    checkpoint.load_fleet(back, str(tmp_path / "mesh.ckpt"))
    onto = FleetSession(mk, 32, CPU, mesh=_port_mesh("2x4"),
                        use_pallas=False)
    checkpoint.load_fleet(onto, str(tmp_path / "unsharded.ckpt"))
    assert isinstance(onto.groups["rs41"][1].state, Shards)
    for sonde in ("rs41", "m10"):
        want = _leaves(tu.groups[sonde][1].state)
        for got in (back.groups[sonde][1].state,
                    onto.groups[sonde][1].global_state()):
            assert all(torch.equal(a, c) for a, c in zip(_leaves(got), want))
    assert _telemetry_text(onto.telemetry) == _telemetry_text(tu.telemetry)


def test_fanin_rows_roundtrip_equals_the_original():
    t = SondeTelemetry()
    t.lat, t.lon, t.alt = 45.0, 9.0, 12000.0
    t.time, t.seq = 1_700_000_045.0, 107
    rows = fanin.telemetry_rows({3: t})
    np.testing.assert_array_equal(rows, jfanin.telemetry_rows({3: t}))
    got = fanin.allgather_rows(rows)
    np.testing.assert_array_equal(got, jfanin.allgather_rows(rows))
    d = fanin.rows_to_dict(got)
    assert d == jfanin.rows_to_dict(got)
    assert d[3]["lat"] == pytest.approx(45.0)
    assert d[3]["time"] == pytest.approx(1_700_000_045.0, abs=0.01)
    counts = [5, 7, 16_777_217, 2_500_000_001]
    np.testing.assert_array_equal(fanin.sum_counts(counts), counts)
    np.testing.assert_array_equal(fanin.sum_counts(counts),
                                  jfanin.sum_counts(counts))
    assert fanin.ROW_FIELDS == jfanin.ROW_FIELDS


def test_allgather_rows_warns_instead_of_silent_drop(caplog):
    rows = np.arange(5 * len(fanin.ROW_FIELDS),
                     dtype=np.float32).reshape(5, -1)
    with caplog.at_level(logging.WARNING):
        out = fanin.allgather_rows(rows, cap=3)
    assert out.shape[0] == 3
    assert any("dropping 2 of 5" in r.message for r in caplog.records)


def test_session_fanin_cap_defaults_to_channel_count():
    sess = DecoderSession(tpipe.PipelineConfig(sonde="rs41", channels=300,
                                               block_len=BLOCK), CPU)
    for ch in range(300):
        t = SondeTelemetry()
        t.lat, t.lon = 1.0 + ch, 2.0
        sess.telemetry[ch] = t
    fan = sess.telemetry_fanin()
    assert len(fan) == 300
    assert json.dumps(fan[299], sort_keys=True) == json.dumps(
        fanin.rows_to_dict(fanin.telemetry_rows({299: sess.telemetry[299]}))
        [299], sort_keys=True)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_time_parallel_fir_matches_jax_and_serial(mesh_name):
    """On the 2x4 mesh the time axis is 'chip' (4 blocks), replicated over
    'host'."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 1024)).astype(np.float32)
    taps = design_lowpass(0.2, 1.0, 33)
    got = time_parallel_fir(x, taps, _port_mesh(mesh_name)).numpy()
    serial = apply_windows(torch.cat([torch.zeros(4, 32),
                                            torch.from_numpy(x)], -1),
                                 taps).numpy()
    np.testing.assert_array_equal(got, serial)
    want = np.asarray(jax_tp_fir(x, taps, _jax_mesh(mesh_name)))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("decim", [1, 2])
def test_time_parallel_frontend_matches_jax_and_serial(decim):
    rng = np.random.default_rng(1)
    n = 8 * 1024 * decim
    xi = rng.normal(size=(4, n)).astype(np.float32)
    xq = rng.normal(size=(4, n)).astype(np.float32)
    ct = design_lowpass(5000.0, 48000.0, 41)
    mt = design_lowpass(2640.0, 48000.0 / decim, 41)
    mesh, jmesh = _port_mesh("8way"), _jax_mesh("8way")
    for dc_block in (False, True):
        kw = dict(decim=decim, scale=3.18, dc_block=dc_block)
        got = time_parallel_frontend(xi, xq, ct, mt, mesh, **kw).numpy()
        serial = frontend_serial(xi, xq, ct, mt, **kw).numpy()
        want = np.asarray(jax_tp_frontend(xi, xq, ct, mt, jmesh, **kw))
        assert got.shape == serial.shape == want.shape == (4, n // decim)
        np.testing.assert_allclose(got, serial, atol=2e-4)
        np.testing.assert_allclose(got, want, atol=2e-4)
