"""Channel sharding and the time-sharded front end (counterpart:
``sondetpu/parallel/sharding.py``).

Channel parallelism: channels are independent, so a channel-sharded step
is one shard pipeline per mesh position, each stepping its slab of
channels on its position's device, with no collective. Channels go to the
shards in contiguous slabs, in the mesh's row-major order over the channel
axes: the original's ``NamedSharding(P(axis))`` layout (on a ``(2, 4)``
mesh across two processes, rank 0 holds channels 0-3 of 8 and rank 1
channels 4-7). A process holds the shards of its own positions only; a
shard that several of its positions replicate (a mesh axis the channels
do not shard over) it holds once, on the first such position's device.

Time parallelism: a block's time axis splits over one mesh axis, and each
position filters its block after taking its left neighbour's tail as a
halo: a device-to-device copy within a process, ``dist.send``/``dist.recv``
across processes (the original's ``ppermute``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from sondetpu_torch.dsp.fir import apply_windows
from sondetpu_torch.parallel.mesh import Mesh, process_count, process_rank
from sondetpu_torch.runtime.pipeline import (Pipeline, PipelineState,
                                             shard_state)

# instrumentation: how session and fleet feeds reached the shards. A host
# array uploads its slabs (host_uploads); a tensor (the fleet's PFB rows)
# is sliced where it lies and moved device to device (device_feeds). One
# count per array.
SHARD_STATS = {"host_uploads": 0, "device_feeds": 0}


class Shards(NamedTuple):
    """A channel-sharded value as this process holds it: ``parts[j]`` (a
    tensor, a PipelineState or a BlockOutput on its shard's device) holds
    channels ``starts[j]`` to ``starts[j] + channels // n_shards``."""

    parts: tuple
    starts: tuple
    channels: int


def mesh_channel_axes(mesh: Mesh):
    """The mesh axes the channel dimension shards over: the full
    ('host', 'chip') product on a 2-D multi-process mesh, the first axis
    otherwise."""
    names = tuple(mesh.axis_names)
    if "host" in names and "chip" in names:
        return ("host", "chip")
    return names[0]


def _axis_dims(mesh: Mesh, axis) -> list:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    return [mesh.axis_names.index(a) for a in axes]


def channel_shards(mesh: Mesh, axis="chip"):
    """(number of channel shards, [(shard index, device)] of the shards
    this process holds, in shard order)."""
    dims = _axis_dims(mesh, axis)
    sizes = [mesh.devices.shape[d] for d in dims]
    rank = process_rank()
    held = {}
    for idx in np.ndindex(mesh.devices.shape):
        if mesh.ranks[idx] == rank:
            s = int(np.ravel_multi_index([idx[d] for d in dims], sizes))
            held.setdefault(s, mesh.devices[idx])
    return int(np.prod(sizes)), sorted(held.items())


def shard_channels(tree: Any, mesh: Mesh, axis="chip",
                   rows: Optional[torch.Tensor] = None) -> Shards:
    """Split a PipelineState, a host array or a tensor by channel (its
    leading axis) over the mesh, each slab this process holds on its
    shard's device. ``rows`` (an index tensor on the tensor's device)
    takes the channels as ``tree.index_select(0, rows)``, each shard
    gathering its own rows only. A Shards value passes through."""
    if isinstance(tree, Shards):
        return tree
    n, held = channel_shards(mesh, axis)
    if isinstance(tree, PipelineState):
        c = tree.timing.pos.shape[0]
    elif rows is not None:
        c = rows.shape[0]
    else:
        c = tree.shape[0]
    if c % n:
        raise ValueError(f"{c} channels do not split into {n} shards")
    per = c // n
    parts = []
    if isinstance(tree, np.ndarray):
        SHARD_STATS["host_uploads"] += 1
    elif isinstance(tree, torch.Tensor):
        SHARD_STATS["device_feeds"] += 1
    for s, dev in held:
        lo, hi = s * per, (s + 1) * per
        if isinstance(tree, PipelineState):
            part = shard_state(tree, lo, hi, dev)
        elif isinstance(tree, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(tree[lo:hi])).to(dev)
        elif rows is not None:
            part = tree.index_select(0, rows[lo:hi]).to(dev)
        else:
            part = tree[lo:hi].to(dev)
        parts.append(part)
    return Shards(tuple(parts), tuple(s * per for s, _ in held), c)


def sharded_pipeline_step(pipeline: Pipeline, mesh: Mesh, axis=None):
    """The pipeline's step over channel shards. Returns (step_fn,
    shard_fn): ``shard_fn(tree, rows=None)`` is :func:`shard_channels` on
    this mesh; ``step_fn(state, iq_i, iq_q)`` steps every shard this
    process holds (each on its device, in shard order) and returns
    (Shards of states, Shards of BlockOutputs). Each shard's Pipeline
    holds its slab of ``fine_offsets`` and takes the global config's route
    (``Pipeline(..., shard_of=)``). ``axis`` defaults to the mesh's channel
    axes (the ('host','chip') product on a 2-D mesh)."""
    if axis is None:
        axis = mesh_channel_axes(mesh)
    cfg = pipeline.config
    n, held = channel_shards(mesh, axis)
    if cfg.channels % n:
        raise ValueError(f"{cfg.channels} channels do not split into {n} "
                         "shards")
    per = cfg.channels // n
    offs = cfg.fine_offsets
    pipes = [Pipeline(dataclasses.replace(
        cfg, channels=per,
        fine_offsets=None if offs is None
        else tuple(offs[s * per:(s + 1) * per])), dev, shard_of=cfg)
        for s, dev in held]

    def shard_fn(tree, rows=None):
        return shard_channels(tree, mesh, axis, rows)

    def step_fn(state, iq_i, iq_q):
        state, iq_i, iq_q = shard_fn(state), shard_fn(iq_i), shard_fn(iq_q)
        states, outs = [], []
        for pipe, st, i, q in zip(pipes, state.parts, iq_i.parts,
                                  iq_q.parts):
            if tuple(i.shape) != (per, cfg.block_len) or i.shape != q.shape:
                raise ValueError(f"iq shard {tuple(i.shape)}, expected "
                                 f"{(per, cfg.block_len)}")
            st, out = pipe._step_impl(st, i.contiguous(), q.contiguous())
            states.append(st)
            outs.append(out)
        return (Shards(tuple(states), state.starts, cfg.channels),
                Shards(tuple(outs), state.starts, cfg.channels))

    return step_fn, shard_fn


# -- time parallelism ------------------------------------------------------

def _time_blocks(mesh: Mesh, axis: str):
    """(D blocks along ``axis``, {block: device} of the blocks this process
    computes, the owner rank of each block). A process computes every
    block it holds a position of; where each process holds every block
    (the time axis lies within a process) nothing crosses processes, and
    a block's owner is this process."""
    d = mesh.axis_names.index(axis)
    ndev = mesh.devices.shape[d]
    rank = process_rank()
    local, owner = {}, [None] * ndev
    for idx in np.ndindex(mesh.devices.shape):
        i = idx[d]
        r = int(mesh.ranks[idx])
        owner[i] = r if owner[i] is None else min(owner[i], r)
        if r == rank:
            local.setdefault(i, mesh.devices[idx])
    if len(local) == ndev:
        owner = [rank] * ndev
    else:
        local = {i: dev for i, dev in local.items() if owner[i] == rank}
    return ndev, local, owner


def _halos(blocks: dict, h: int, owner: list) -> dict:
    """Each block's left halo: the last h samples of block i - 1 on block
    i's device (a copy within the process, a send and receive between
    processes), zeros for block 0 (the original's ppermute, whose
    wrap-around block 0 discards)."""
    rank = process_rank()
    sends = []
    for i, x in blocks.items():
        if i + 1 < len(owner) and owner[i + 1] != rank:
            sends.append(dist.isend(x[:, -h:].cpu().contiguous(),
                                    owner[i + 1]))
    halos = {}
    for i, x in blocks.items():
        if i == 0:
            halos[i] = torch.zeros((x.shape[0], h), dtype=x.dtype,
                                   device=x.device)
        elif (i - 1) in blocks:
            halos[i] = blocks[i - 1][:, -h:].to(x.device)
        else:
            buf = torch.empty((x.shape[0], h), dtype=x.dtype)
            dist.recv(buf, owner[i - 1])
            halos[i] = buf.to(x.device)
    for s in sends:
        s.wait()
    return halos


def _gather_blocks(outs: dict, owner: list) -> torch.Tensor:
    """The blocks' outputs in order along the time axis, as one tensor on
    the first local block's device; across processes they are gathered
    over the process group (through the host) so that every process
    returns the whole output."""
    first = outs[min(outs)]
    if len(outs) == len(owner):
        return torch.cat([outs[i].to(first.device) for i in sorted(outs)],
                         dim=-1)
    local = torch.stack([outs[i].cpu() for i in sorted(outs)])
    gathered = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(gathered, local)
    by_rank = {r: iter(g) for r, g in enumerate(gathered)}
    return torch.cat([next(by_rank[r]) for r in owner], dim=-1).to(
        first.device)


def _split_time(x, ndev: int, local: dict) -> dict:
    x = torch.as_tensor(x)
    n = x.shape[-1] // ndev
    return {i: x[:, i * n:(i + 1) * n].to(dev) for i, dev in local.items()}


def time_parallel_fir(x, taps, mesh: Mesh, axis: str = "chip"):
    """FIR over a stream whose TIME axis splits across ``axis`` of the
    mesh. x: [channels, n] (a tensor or host array, the whole stream) with
    n divisible by mesh.shape[axis]. Each block is filtered after taking
    the ``ntaps-1``-sample halo from its left neighbour (block 0 starts
    from zeros); the result equals the unsharded causal FIR exactly and is
    returned whole on the first local block's device."""
    taps = np.asarray(taps, np.float32)
    ndev, local, owner = _time_blocks(mesh, axis)
    blocks = _split_time(x, ndev, local)
    halos = _halos(blocks, taps.shape[0] - 1, owner)
    outs = {i: apply_windows(torch.cat([halos[i], xb], dim=-1), taps)
            for i, xb in blocks.items()}
    return _gather_blocks(outs, owner)


def _fm(cfi: torch.Tensor, cfq: torch.Tensor, scale: float) -> torch.Tensor:
    """FM discriminator of consecutive filtered samples: [C, m + 1] ->
    [C, m]."""
    pi_, pq_ = cfi[:, :-1], cfq[:, :-1]
    ci, cq = cfi[:, 1:], cfq[:, 1:]
    return torch.atan2(cq * pi_ - ci * pq_, ci * pi_ + cq * pq_) * scale


def frontend_serial(iq_i, iq_q, chan_taps, match_taps, decim: int = 1,
                    scale: float = 1.0, dc_block: bool = True):
    """Single-device reference of the plain front end from zero initial
    state: channel filter (stride ``decim``) -> FM quadrature
    discriminator -> optional DC block -> matched FIR. The oracle for
    :func:`time_parallel_frontend`."""
    iq_i, iq_q = torch.as_tensor(iq_i), torch.as_tensor(iq_q)
    nt_c, nt_m = len(chan_taps), len(match_taps)
    c = iq_i.shape[0]

    def zeros(w):
        return torch.zeros((c, w), dtype=torch.float32, device=iq_i.device)

    cfi = apply_windows(torch.cat([zeros(nt_c - 1), iq_i], -1), chan_taps,
                        stride=decim)
    cfq = apply_windows(torch.cat([zeros(nt_c - 1), iq_q], -1), chan_taps,
                        stride=decim)
    audio = _fm(torch.cat([zeros(1), cfi], -1), torch.cat([zeros(1), cfq], -1),
                scale)
    if dc_block:
        audio = audio - torch.mean(audio, dim=-1, keepdim=True)
    return apply_windows(torch.cat([zeros(nt_m - 1), audio], -1), match_taps)


def time_parallel_frontend(iq_i, iq_q, chan_taps, match_taps, mesh: Mesh,
                           decim: int = 1, scale: float = 1.0,
                           dc_block: bool = True, axis: str = "chip"):
    """The whole plain front end over a TIME-sharded block: [C, n] planes
    (tensors or host arrays) split along ``axis``; each block takes one
    left halo of

        H = decim * nt_match + nt_chan - 1

    full-rate samples from its neighbour and recomputes the chain inside
    it (channel filter + decimate + FM discriminator + matched FIR). The
    DC block subtracts the mean of the blocks' means (the original's
    pmean: an all-reduce across processes). Output [C, n // decim], equal
    to :func:`frontend_serial` within float rounding; block 0 uses zero
    history (a fresh stream)."""
    nt_c, nt_m = len(chan_taps), len(match_taps)
    ndev, local, owner = _time_blocks(mesh, axis)
    c, n = torch.as_tensor(iq_i).shape
    n_loc = n // ndev
    if n % ndev or n_loc % decim:
        raise ValueError(f"n={n} must split into {ndev} blocks divisible "
                         f"by decim={decim}")
    h = decim * nt_m + nt_c - 1
    if h > n_loc:
        raise ValueError(f"halo {h} exceeds local block {n_loc}")
    audio = {}
    for planes in (_split_time(iq_i, ndev, local),
                   _split_time(iq_q, ndev, local)):
        halos = _halos(planes, h, owner)
        # chanfilt over [C, H + n_loc]: nt_m extra (history) outputs lead
        # the local segment ((H - nt_c + 1) / decim == nt_m)
        for i, x in planes.items():
            audio.setdefault(i, []).append(apply_windows(
                torch.cat([halos[i], x], dim=-1), chan_taps, stride=decim))
    audio = {i: _fm(cf[0], cf[1], scale) for i, cf in audio.items()}
    if dc_block:
        dev0 = audio[min(audio)].device
        total = torch.zeros(c, dtype=torch.float32, device=dev0)
        for i in sorted(audio):
            total = total + torch.mean(audio[i][:, nt_m - 1:], dim=-1).to(dev0)
        if len(audio) < ndev:
            total = total.cpu()
            dist.all_reduce(total)
            total = total.to(dev0)
        dc = total / ndev
        for i in audio:
            a = audio[i] - dc.to(audio[i].device)[:, None]
            if i == 0:
                # block 0's history is the serial path's literal zero
                # initial state: kept zero, not dc-subtracted
                a[:, :nt_m - 1] = 0.0
            audio[i] = a
    outs = {i: apply_windows(a, match_taps) for i, a in audio.items()}
    return _gather_blocks(outs, owner)
