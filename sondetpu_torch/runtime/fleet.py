"""Mixed-fleet decoding: heterogeneous sonde types over one wideband input
(counterpart: ``sondetpu/runtime/fleet.py``).

One PFB channelizer splits the wideband stream; channels are grouped by
sonde type, and each group advances through its type's pipeline as a batch.
The default (``fused=None`` or ``True``) is the original's single-process
fused ``FleetSession`` step: PFB, a row gather per group, each group's
step, the groups' packed buffers concatenated into one, and one
device->host readback per block (one block later when ``pipelined``).
``fused=False`` is the original's per-group path: PFB, then for each group
a row gather and that group's ``process_block``, one readback per group,
with ``pipelined`` passed on to the groups' sessions. Both run eagerly on
``device``. A channel's
``offset_hz`` below the PFB grid goes to its group's DDC
(``fine_offsets``), and ``afc`` runs each group's AFC loop from it.

``compute_dtype="bf16"`` runs the PFB itself in bfloat16, and each group
takes the original's dtype rule (``sondetpu/runtime/fleet.py:107-113``):
AFSK groups, and groups on a kernel route that are not dual-tone, in
float32, the rest in bfloat16; the gathered planes flow in the PFB's dtype
and each group's step casts them. ``use_pallas=True`` or ``False`` puts
every group on the kernel path or the plain-op path. ``use_pallas=None``
puts every group on the kernel path too: the original's ``None`` is a
per-family policy measured on a TPU v5e (dual-tone groups on the kernel,
the rest on the jnp path), which on any other backend than a TPU means no
kernels at all; the policy for this card is for the benchmark to measure.

With ``mesh=`` (``sondetpu_torch.parallel.make_mesh``), the original's
mesh fleet: groups take no pad rows, and a group whose channel count
divides into the mesh's size is sharded over it (its session's
``mesh``); the other groups stay on ``device``. With ``fused`` (the
default) a block is the original's ``_fused_mesh`` step: each process
channelizes the whole wideband block once on ``device``; every sharded
group (``_mp_order``) gathers each of its shards' rows from the PFB output
and feeds them device to device (no host round trip), every shard steps,
and each shard's packed buffer is read back and decoded; then every other
group (``_mp_local``) runs ``process_block`` on its gathered rows.
``fused=False`` keeps the per-group path.

The original's 64-row group padding was tuned for the TPU and is dropped:
a group is padded only to the kernels' multiple of 8 rows, and only when
it takes a kernel route and the fleet has no mesh.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from sondetpu_torch.dsp.channelizer import PFBChannelizer
from sondetpu_torch.io.iq import c64_to_planes
from sondetpu_torch.runtime.pipeline import BlockOutput, PipelineConfig, _route
from sondetpu_torch.runtime.session import DecoderSession
from sondetpu_torch.sondes.base import get_sonde
from sondetpu_torch.telemetry import SondeTelemetry

ROW_MULTIPLE = 8   # the kernel path's channel gate (pipeline._route)


@dataclass
class FleetChannel:
    """One logical channel: which PFB bin, which protocol, and the fine
    frequency offset below the PFB grid."""

    pfb_bin: int
    sonde: str
    offset_hz: float = 0.0


class FleetSession:
    """Wideband IQ -> channelize -> per-type batched decode sessions, on
    ``device``."""

    def __init__(self, channels: Sequence[FleetChannel], n_bins: int, device,
                 fs_chan: float = 48000.0, block_len: int = 48000,
                 sync_threshold: float = 0.55, use_pallas: bool = None,
                 on_update=None, mesh=None, compute_dtype: str = "f32",
                 afc: bool = False, pipelined: bool = False,
                 fused: bool = None):
        self.channels = list(channels)
        self.device = torch.device(device)
        self.pfb = PFBChannelizer(
            n_bins, self.device,
            dtype="bf16" if compute_dtype == "bf16" else "f32")
        # None: every group on its kernel route (see the module docstring)
        self.use_pallas = True if use_pallas is None else bool(use_pallas)
        self.pfb_state = self.pfb.init_state()
        self.block_len = block_len
        self.n_bins = n_bins
        self.fs_chan = fs_chan
        self.pipelined = bool(pipelined)
        fused = True if fused is None else bool(fused)
        self._fused = fused and mesh is None
        self._fused_mesh = fused and mesh is not None
        self.mesh = mesh
        self._pending = None

        groups: Dict[str, List[int]] = {}
        for idx, ch in enumerate(self.channels):
            groups.setdefault(ch.sonde, []).append(idx)
        # sonde -> (logical channel indices, session); pad rows duplicate
        # the group's first bin and are dropped by _wrap/telemetry
        self.groups: Dict[str, tuple] = {}
        self._order = []          # [(sonde, bins tensor, session)]
        for sonde, idxs in groups.items():
            spec = get_sonde(sonde)["spec"]
            dualtone = bool(spec.extra.get("fsk_dualtone"))
            # the original's group dtype rule
            group_cdt = ("f32" if spec.modulation == "afsk"
                         or (self.use_pallas and not dualtone)
                         else compute_dtype)

            def config(pad, sonde=sonde, idxs=idxs, cdt=group_cdt):
                # pad rows sit on the grid (sondetpu/runtime/fleet.py:
                # 118-125)
                offs = tuple(self.channels[i].offset_hz for i in idxs) \
                    + (0.0,) * pad
                return PipelineConfig(
                    sonde=sonde, channels=len(idxs) + pad, fs=fs_chan,
                    block_len=block_len, sync_threshold=sync_threshold,
                    use_pallas=self.use_pallas, compute_dtype=cdt, afc=afc,
                    fine_offsets=offs if any(offs) else None)

            pad = ((-len(idxs)) % ROW_MULTIPLE
                   if self.use_pallas and mesh is None else 0)
            cfg = config(pad)
            if pad and _route(cfg) is None:
                # a kernel gate other than the channels' fails: no pad rows
                pad = 0
                cfg = config(0)
            # a group shards over the mesh when its channel count divides
            # into the mesh's size; smaller groups stay on the device
            group_mesh = mesh if (mesh is not None and len(idxs)
                                  % mesh.devices.size == 0) else None
            sess = DecoderSession(cfg, self.device,
                                  on_update=self._wrap(sonde, idxs, on_update),
                                  pipelined=self.pipelined, mesh=group_mesh)
            self.groups[sonde] = (idxs, sess)
            bins = [self.channels[i].pfb_bin for i in idxs]
            bins += [bins[0]] * pad
            self._order.append((sonde, torch.tensor(
                bins, dtype=torch.int64, device=self.device), sess))
        if self._fused_mesh:
            # the sharded groups, stepped as one, and the groups that stay
            # on the device
            self._mp_order = [g for g in self._order if g[2].mesh is not None]
            self._mp_local = [g[0] for g in self._order if g[2].mesh is None]

    def _wrap(self, sonde: str, idxs: List[int], on_update):
        if on_update is None:
            return None

        def inner(local_ch: int, telem: SondeTelemetry):
            if local_ch < len(idxs):       # dummy pad channels are dropped
                on_update(idxs[local_ch], sonde, telem)

        return inner

    @property
    def telemetry(self) -> Dict[int, SondeTelemetry]:
        """Telemetry keyed by logical (fleet) channel index."""
        out = {}
        for sonde, (idxs, sess) in self.groups.items():
            for local, t in sess.telemetry.items():
                if local < len(idxs):      # dummy pad channels are dropped
                    out[idxs[local]] = t
        return out

    def step(self, wi: torch.Tensor, wq: torch.Tensor):
        """The device step of one wideband block of a fleet without a mesh
        (planes [W] float32 on the fleet's device): PFB, every group's row gather (in the PFB's dtype)
        and pipeline step.
        Advances the states and returns (the groups' packed buffers
        concatenated, [each group's frames])."""
        self.pfb_state, yi, yq = self.pfb(self.pfb_state, wi, wq)
        packeds, frames = [], []
        for sonde, bins, sess in self._order:
            gi = yi.index_select(0, bins)
            gq = yq.index_select(0, bins)
            sess.state, out = sess.pipeline._step_impl(sess.state, gi, gq)
            packeds.append(out.packed)
            frames.append(out.frames)
        return torch.cat(packeds), frames

    def _consume(self, pending) -> int:
        """Read one block's concatenated packed buffer back (ONE transfer
        for the whole fleet) and run every group's host FEC/parse/merge on
        its slice."""
        packed_all, frames = pending
        host = packed_all.cpu().numpy()
        updates = 0
        off = 0
        for (sonde, bins, sess), frames_k in zip(self._order, frames):
            t0 = time.perf_counter()
            c = sess.config
            nbytes = c.channels * c.packed_row_bytes
            out = BlockOutput(frames=frames_k, frame_valid=None,
                              frame_score=None, soft_rms=None, rs_clean=None,
                              packed=host[off:off + nbytes])
            off += nbytes
            sess.blocks_seen += 1
            ups, frames_raw, decoded, soft_rms = sess._handle_output(out)
            sess.metrics.on_block(c.block_len, time.perf_counter() - t0,
                                  frames_raw, decoded, len(ups), soft_rms)
            updates += len(ups)
        return updates

    def process_wideband(self, iq) -> int:
        """One wideband block [n_bins * block_len] complex64 (host) or an
        (i, q) plane pair (NumPy arrays or tensors). Returns the number of
        telemetry updates (for the previous block when ``pipelined``)."""
        if isinstance(iq, tuple):
            wi, wq = iq
        else:
            wi, wq = c64_to_planes(np.asarray(iq))
        wi = torch.as_tensor(wi).to(self.device, torch.float32)
        wq = torch.as_tensor(wq).to(self.device, torch.float32)
        if self._fused_mesh:
            return self._process_wideband_mesh(wi, wq)
        if not self._fused:
            # the per-group path: each group's session steps, reads back
            # and decodes its own rows (pipelined in the session)
            self.pfb_state, yi, yq = self.pfb(self.pfb_state, wi, wq)
            return sum(len(sess.process_block((yi.index_select(0, bins),
                                               yq.index_select(0, bins))))
                       for _, bins, sess in self._order)
        block = self.step(wi, wq)
        if not self.pipelined:
            return self._consume(block)
        # pipelined: block k is read back after block k+1 is stepped, so
        # telemetry lags the input by one block. The readback is queued on
        # the same stream behind block k+1's step, so it waits for that
        # step and the host decode does not overlap the device.
        pending, self._pending = self._pending, block
        return self._consume(pending) if pending is not None else 0

    def _process_wideband_mesh(self, wi: torch.Tensor,
                               wq: torch.Tensor) -> int:
        """The fused mesh step of one block: the PFB once on the device;
        every sharded group's shards gather their rows and step, then each
        group's shards are read back and decoded; then each group that
        stays on the device runs process_block on its rows."""
        self.pfb_state, yi, yq = self.pfb(self.pfb_state, wi, wq)
        outs = []
        for sonde, bins, sess in self._mp_order:
            sess.state, out = sess._sharded_step(
                sess.state, sess._shard_fn(yi, rows=bins),
                sess._shard_fn(yq, rows=bins))
            outs.append(out)
        updates = 0
        for (sonde, bins, sess), out in zip(self._mp_order, outs):
            t0 = time.perf_counter()
            sess.blocks_seen += 1
            ups, frames_raw, decoded, soft_rms = sess._handle_output(out)
            sess.metrics.on_block(sess.config.block_len,
                                  time.perf_counter() - t0, frames_raw,
                                  decoded, len(ups), soft_rms)
            updates += len(ups)
        for sonde, bins, sess in self._order:
            if sonde in self._mp_local:
                updates += len(sess.process_block(
                    (yi.index_select(0, bins), yq.index_select(0, bins))))
        return updates

    def flush(self) -> int:
        """Drain the pending block in pipelined mode (call at end of
        stream: without it the final block's frames are dropped); unfused,
        every group's session drains its own."""
        if not self._fused:
            return sum(len(sess.flush()) for _, _, sess in self._order)
        pending, self._pending = self._pending, None
        return self._consume(pending) if pending is not None else 0
