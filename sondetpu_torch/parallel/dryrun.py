"""The multi-device dry run (counterpart: ``__graft_entry__.py``'s
``dryrun_multichip``): every multi-device path once, at small shapes.

    python -m sondetpu_torch.parallel.dryrun 4 cuda   # a 4-way mesh on cuda:0
    python -m sondetpu_torch.parallel.dryrun 8 cpu    # [cpu] * 8
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from sondetpu_torch.dsp.fir import design_lowpass
from sondetpu_torch.parallel.mesh import make_mesh
from sondetpu_torch.parallel.sharding import (sharded_pipeline_step,
                                              time_parallel_fir,
                                              time_parallel_frontend)
from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession
from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig


def _example(channels: int, device, block_len: int = 4800):
    cfg = PipelineConfig(sonde="rs41", channels=channels, block_len=block_len)
    pipe = Pipeline(cfg, device)
    rng = np.random.default_rng(0)
    iq_i = rng.normal(size=(channels, block_len)).astype(np.float32) * 0.5
    iq_q = rng.normal(size=(channels, block_len)).astype(np.float32) * 0.5
    return pipe, pipe.init_state(), (iq_i, iq_q)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One channel-sharded RS41 step on an n-way mesh of ``device`` (the
    device repeated n times), the ('host', 'chip') mesh when n is even and
    at least 4, ``time_parallel_fir`` and ``time_parallel_frontend``, and
    one block of a fused mesh fleet."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    devices = [dev] * n_devices
    mesh = make_mesh(devices=devices)

    channels = 2 * n_devices
    pipe, state, (iq_i, iq_q) = _example(channels, dev)
    step_fn, shard_fn = sharded_pipeline_step(pipe, mesh)
    _, out = step_fn(shard_fn(state), shard_fn(iq_i), shard_fn(iq_q))
    assert sum(o.frames.shape[0] for o in out.parts) == channels

    # the 2-D ('host', 'chip') mesh: channels shard over the product
    if n_devices % 2 == 0 and n_devices >= 4:
        mesh2 = make_mesh(axis_names=("host", "chip"),
                          shape=(2, n_devices // 2), devices=devices)
        pipe2, state2, (i2, q2) = _example(channels, dev)
        step2, shard2 = sharded_pipeline_step(pipe2, mesh2)
        _, out2 = step2(shard2(state2), shard2(i2), shard2(q2))
        assert len(out2.parts) == n_devices

    # the time-sharded paths: one FIR, and the whole plain front end
    taps = design_lowpass(0.2, 1.0, 17)
    y = time_parallel_fir(torch.ones((4, 128 * n_devices), device=dev),
                          taps, mesh)
    assert y.shape == (4, 128 * n_devices)
    ct = design_lowpass(5000.0, 48000.0, 41)
    mt = design_lowpass(2640.0, 24000.0, 41)
    n = 256 * 2 * n_devices
    f = time_parallel_frontend(torch.ones((2, n), device=dev),
                               torch.zeros((2, n), device=dev), ct, mt, mesh,
                               decim=2, scale=3.18)
    assert f.shape == (2, n // 2)

    # the fused mesh fleet: the PFB once, the sharded rs41 group's rows fed
    # device to device
    n_bins = 16 * (2 * n_devices // 16 + 1)      # every bin 1 + k exists
    chans = [FleetChannel(pfb_bin=1 + k, sonde="rs41")
             for k in range(2 * n_devices)]
    fleet = FleetSession(chans, n_bins, dev, block_len=4800, mesh=mesh,
                         use_pallas=False)
    assert fleet._fused_mesh and len(fleet._mp_order) == 1
    rng = np.random.default_rng(1)
    w = n_bins * 4800
    fleet.process_wideband(
        (rng.normal(size=w).astype(np.float32) * 0.1,
         rng.normal(size=w).astype(np.float32) * 0.1))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]), sys.argv[2] if len(sys.argv) > 2
                     else "cuda")
    print("dryrun_multichip ok")
