"""Multi-device and multi-process scale-out (counterpart:
``sondetpu/parallel``).

Channels shard over a :class:`~sondetpu_torch.parallel.mesh.Mesh` of
torch devices (one shard pipeline per position, no collective: channels
are independent); long blocks shard over time with halos passed to the
right neighbour; multi-process runs start a ``torch.distributed`` group
(gloo) and fan telemetry and metrics in over it.
"""

from sondetpu_torch.parallel.mesh import distributed_init, make_mesh
from sondetpu_torch.parallel.sharding import (
    frontend_serial, shard_channels, sharded_pipeline_step,
    time_parallel_fir, time_parallel_frontend)

__all__ = ["make_mesh", "distributed_init", "shard_channels",
           "sharded_pipeline_step", "time_parallel_fir",
           "time_parallel_frontend", "frontend_serial"]
