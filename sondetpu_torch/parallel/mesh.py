"""Device mesh and multi-process start-up (counterpart:
``sondetpu/parallel/mesh.py``).

A :class:`Mesh` names the devices that the channel axis shards over, in
the mesh's shape, with the process rank that owns each position. A device
may stand at several positions: ``[torch.device("cpu")] * 8`` is the
counterpart of the original's virtual 8-device CPU mesh, and
``[torch.device("cuda", 0)] * 4`` runs a 4-way mesh on one card, its
shards in turn. In a multi-process run (``torch.distributed``, started by
:func:`distributed_init`) each process passes its own devices; the mesh is
``(world_size, k)`` and row ``p`` belongs to rank ``p``, the original's
``('host', 'chip')`` layout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def process_rank() -> int:
    """This process's rank in the process group, 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The processes in the group, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _object_array(items, shape) -> np.ndarray:
    # np.asarray would look into the items; an object array holds them
    a = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        a[i] = x
    return a.reshape(shape)


class Mesh:
    """Devices in a named grid: ``devices`` (an object array of
    ``torch.device`` in the mesh's shape), ``axis_names``, ``shape`` (a
    dict, as JAX's ``mesh.shape``) and ``ranks`` (the process rank that
    owns each position)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 ranks: np.ndarray):
        if devices.ndim != len(axis_names) or ranks.shape != devices.shape:
            raise ValueError(f"mesh of shape {devices.shape} with axes "
                             f"{tuple(axis_names)} and ranks {ranks.shape}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.ranks = ranks

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def make_mesh(axis_names: Sequence[str] = ("chip",),
              shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """Build a mesh over this process's devices (default: every CUDA device
    of the process; without a card this raises, it does not fall back to
    the CPU). Default shape: 1-D over all devices of all processes. Pass
    ``axis_names=('host', 'chip')`` with a 2-D shape for the multi-process
    layout. In a run of N processes with k devices each, the mesh holds
    N * k positions in row-major order, the first k of rank 0, the next k
    of rank 1 and so on; ``devices`` at another rank's positions are this
    process's own, in the same order (every process runs the same
    layout)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "(e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    local = [torch.device(d) for d in devices]
    world = process_count()
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (world * len(local),)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != world * len(local):
        raise ValueError(f"mesh shape {shape} != {world} processes x "
                         f"{len(local)} devices")
    ranks = np.repeat(np.arange(world), len(local))
    return Mesh(_object_array(local * world, shape), axis_names,
                ranks.reshape(shape))


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Start the process group (a no-op for one process or none): gloo, over
    TCP at ``coordinator`` ("host:port"). Call once per process before
    building the mesh. The fan-in moves small host arrays, which is what
    gloo is for; the channel shards never cross processes."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
