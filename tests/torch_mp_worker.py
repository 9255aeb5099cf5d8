"""Worker process of the port's two-process run (the counterpart of
tests/_mp_worker.py), started by tests/test_torch_multihost.py on the CPU
and by chip_smoke.py on the card:

    python tests/torch_mp_worker.py RANK PORT DEVICE [--full]

Two processes form a gloo group on 127.0.0.1:PORT, each with four
positions of DEVICE ("cpu" or "cuda"), so a ('host', 'chip') = (2, 4)
mesh: rank 0 holds channels 0-3 of 8, rank 1 channels 4-7. Each decodes
the 8-channel RS41 session's own channels and the 8-bin fleet's own rs41
channels, and gathers every channel's telemetry and the summed metrics
over the fan-in; a 1-D mesh of 8 positions across the two processes runs
the time-sharded front end, whose halo between positions 3 and 4 goes by
send and receive. With --full, also RS41 at 2048 channels x 4 s (i16, the
kernel route in f32), 1024 channels a process, 3 blocks. Prints one JSON
line. Imports nothing of jax or of the JAX package.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from sondetpu_torch.dsp.fir import design_lowpass  # noqa: E402
from sondetpu_torch.kernels import cuda  # noqa: E402
from sondetpu_torch.parallel import (distributed_init, frontend_serial,  # noqa: E402
                                     make_mesh, time_parallel_frontend)
from sondetpu_torch.parallel import sharding  # noqa: E402
from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession  # noqa: E402
from sondetpu_torch.runtime.pipeline import PipelineConfig  # noqa: E402
from sondetpu_torch.runtime.session import DecoderSession  # noqa: E402
from sondetpu_torch.sondes.modulate import freq_shift, gfsk_modulate  # noqa: E402
from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth  # noqa: E402


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def session_case(mesh, dev):
    """The 8-channel RS41 session over the (2, 4) mesh."""
    iq1 = RS41Modulator().modulate([RS41Truth(frame_no=5 + i)
                                    for i in range(3)])
    iq = np.stack([iq1] * 8)
    sess = DecoderSession(PipelineConfig(sonde="rs41", channels=8,
                                         block_len=48000), dev, mesh=mesh)
    for i in range(0, iq.shape[1] - 48000 + 1, 48000):
        sess.process_block(iq[:, i:i + 48000])
    fan = sess.telemetry_fanin()
    return {
        "local_telemetry": sorted(sess.telemetry),
        "expected_local": sess.local_channels(),
        "fan_channels": sorted(fan),
        "fan_lat0": fan.get(0, {}).get("lat"),
        "serial0": sess.telemetry[min(sess.telemetry)].serial
        if sess.telemetry else "",
        "metrics": sess.metrics_fanin(),
    }


def fleet_case(mesh, dev):
    """8 rs41 channels in the 8 bins of one wideband stream, the rs41
    group sharded over the mesh; each process channelizes the whole block
    and decodes its own channels."""
    n_bins = 8
    fs_wide = n_bins * 48000.0
    fleet = FleetSession([FleetChannel(pfb_bin=k, sonde="rs41")
                          for k in range(8)], n_bins, dev, mesh=mesh)
    assert fleet._fused_mesh and not fleet._fused
    assert len(fleet._mp_order) == 1 and not fleet._mp_local
    before = dict(sharding.SHARD_STATS)
    mod = RS41Modulator()
    bits = mod.frames_to_bits(np.stack(
        [mod.build_frame(RS41Truth(frame_no=70 + i)) for i in range(3)]))
    centers = fleet.pfb.center_freqs(fs_wide)
    w = n_bins * 48000
    sigs = [freq_shift(gfsk_modulate(bits, fs_wide / 4800.0,
                                     2400.0 / fs_wide, bt=0.5),
                       centers[k] / fs_wide) for k in range(8)]
    n = ((max(x.size for x in sigs) + w - 1) // w) * w
    wide = np.zeros(n, np.complex64)
    for x in sigs:
        wide[:x.size] += x
    for i in range(0, n - w + 1, w):
        fleet.process_wideband(wide[i:i + w])
    sess = fleet.groups["rs41"][1]
    return {
        "fleet_local": sorted(sess.telemetry),
        "fleet_fan": sorted(sess.telemetry_fanin()),
        "fleet_shard_stats": {k: sharding.SHARD_STATS[k] - before[k]
                              for k in before},
        "fleet_fused_mesh": bool(fleet._fused_mesh),
    }


def time_parallel_case(dev):
    """The time-sharded front end on a 1-D mesh of 8 positions across the
    two processes, against the serial chain."""
    mesh = make_mesh(devices=[dev] * 4)
    rng = np.random.default_rng(1)
    xi = rng.normal(size=(4, 8 * 1024 * 2)).astype(np.float32)
    xq = rng.normal(size=(4, 8 * 1024 * 2)).astype(np.float32)
    ct = design_lowpass(5000.0, 48000.0, 41)
    mt = design_lowpass(2640.0, 24000.0, 41)
    got = time_parallel_frontend(xi, xq, ct, mt, mesh, decim=2, scale=3.18)
    want = frontend_serial(xi, xq, ct, mt, decim=2, scale=3.18)
    return {"time_parallel_shape": list(got.shape),
            "time_parallel_err": float((got.cpu() - want).abs().max())}


def full_width_case(dev, channels=2048, block_len=192000, n_blocks=3):
    """RS41 at full width: one signal on every channel, int16 host planes
    (a broadcast view: each process uploads only its slabs)."""
    mesh = make_mesh(("host", "chip"), (2, 4), devices=[dev] * 4)
    n = n_blocks * block_len
    iq = RS41Modulator().modulate([RS41Truth(frame_no=20 + j)
                                   for j in range(n // 25600 + 2)])[:n]
    qi = np.broadcast_to(np.clip(iq.real * 32767, -32768, 32767)
                         .astype(np.int16), (channels, n))
    qq = np.broadcast_to(np.clip(iq.imag * 32767, -32768, 32767)
                         .astype(np.int16), (channels, n))
    cfg = PipelineConfig(sonde="rs41", channels=channels, block_len=block_len,
                         use_pallas=True, input_dtype="i16")
    sess = DecoderSession(cfg, dev, mesh=mesh)
    _sync(dev)
    cuda.reset_launches()
    block_ms = []
    for b in range(n_blocks):
        sl = slice(b * block_len, (b + 1) * block_len)
        _sync(dev)
        t0 = time.perf_counter()
        sess.process_block((qi[:, sl], qq[:, sl]))
        _sync(dev)
        block_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v for k, v in cuda.launches.items() if v}
    fan_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        fan = sess.telemetry_fanin()
        fan_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    met = sess.metrics_fanin()
    met_ms = (time.perf_counter() - t0) * 1e3
    local = sorted(sess.telemetry)
    return {
        "full_local": [local[0], local[-1], len(local)] if local else [],
        "full_expected_local": [sess.local_channels()[0],
                                sess.local_channels()[-1],
                                len(sess.local_channels())],
        "full_serials": sorted({t.serial for t in sess.telemetry.values()}),
        "full_fan": len(fan),
        "full_fan_lats": sorted({round(v["lat"], 4) for v in fan.values()}),
        "full_metrics": met,
        "full_block_ms": block_ms,
        "full_launches": launches,
        "fanin_ms": fan_ms,
        "metrics_fanin_ms": met_ms,
    }


def main():
    rank, port, device = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    distributed_init(f"127.0.0.1:{port}", 2, rank)
    mesh = make_mesh(axis_names=("host", "chip"), shape=(2, 4),
                     devices=[dev] * 4)
    res = {"rank": rank, "mesh": mesh.shape,
           "ranks": mesh.ranks.tolist()}
    res.update(session_case(mesh, dev))
    res.update(fleet_case(mesh, dev))
    res.update(time_parallel_case(dev))
    if "--full" in sys.argv[4:]:
        res.update(full_width_case(dev))
    _sync(dev)
    torch.distributed.destroy_process_group()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
