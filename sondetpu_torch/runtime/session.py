"""Host-side decode session: steps the pipeline, aggregates telemetry
(counterpart: ``sondetpu/runtime/session.py``).

It steps the port's pipeline, reads the packed buffer back to the host,
runs the family's byte-level FEC and parse (with the device's weakest-bit
ranks for the Chase repair of m10; over a thread pool on channel-aligned
rows with ``host_workers``), and merges fragments into per-channel
telemetry. It carries the original's AFC read-out (``afc_freqs``),
``reset_channel`` (which reseeds a channel's AFC-tracked frequency) and
``watchdog``. In pipelined mode the readback of block k happens after
block k+1 is stepped, so telemetry lags the input by one block, as in the
original; the readback itself (``packed.cpu()``) still waits for the
device.

With ``mesh=`` (``sondetpu_torch.parallel``) the state is split by channel
over the mesh's shards in the constructor and each block steps every shard
this process holds (``sharded_pipeline_step``). Each shard's packed buffer
is read back on its own and decoded under its global channel ids; in a
multi-process run a process decodes only its own channels
(``local_channels``), only the owner of a channel reseeds it in
``reset_channel``, and ``telemetry_fanin``/``metrics_fanin`` gather every
process's telemetry and counters over the process group.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sondetpu_torch.io.iq import c64_to_planes
from sondetpu_torch.parallel import fanin
from sondetpu_torch.parallel.mesh import process_count, process_rank
from sondetpu_torch.parallel.sharding import Shards, sharded_pipeline_step
from sondetpu_torch.runtime.metrics import Metrics
from sondetpu_torch.runtime.pipeline import (Pipeline, PipelineConfig,
                                             merge_state,
                                             unpack_block_output)
from sondetpu_torch.sondes.base import get_sonde
from sondetpu_torch.telemetry import SondeTelemetry


class DecoderSession:
    """Streaming decode of [channels, block] IQ into telemetry updates."""

    def __init__(self, config: PipelineConfig, device,
                 on_update: Optional[Callable[[int, SondeTelemetry], None]] = None,
                 pipelined: bool = False, host_workers: int = 0,
                 pipeline: Optional[Pipeline] = None, mesh=None):
        self.config = config
        self.device = torch.device(device)
        # callers that already hold a Pipeline for this config reuse it
        self.pipeline = (pipeline if pipeline is not None
                         else Pipeline(config, self.device))
        self.state = self.pipeline.init_state()
        # mesh: the state as Shards of channel slabs, stepped shard by
        # shard; ``device`` (one of this process's mesh devices) holds
        # what is not sharded
        self.mesh = mesh
        self._shard_fn = None
        self._sharded_step = None
        if mesh is not None:
            if _index(self.device) not in {
                    _index(d) for d in mesh.devices[
                        mesh.ranks == process_rank()]}:
                raise ValueError(f"device {self.device} is not one of this "
                                 f"process's devices of the mesh {mesh}")
            self._sharded_step, self._shard_fn = sharded_pipeline_step(
                self.pipeline, mesh)
            self.state = self._shard_fn(self.state)
        self.decoder = get_sonde(config.sonde)["decoder"]()
        self.telemetry: Dict[int, SondeTelemetry] = {}
        self.on_update = on_update
        self.frames_seen = 0
        self.blocks_seen = 0
        self.metrics = Metrics(channels=config.channels, fs=config.fs)
        self._last_update_block: Dict[int, int] = {}
        self.pipelined = pipelined
        self._pending = None
        # host_workers > 1: the byte-level FEC/parse runs on a thread pool
        # over CHANNEL-ALIGNED row ranges, so each channel's decoder state
        # has one writer (sondetpu/runtime/session.py:64-74); it gains only
        # as far as the family's parse releases the GIL
        self.host_workers = int(host_workers)
        self._pool = (ThreadPoolExecutor(max_workers=self.host_workers)
                      if self.host_workers > 1 else None)

    def close(self) -> None:
        """Stop the host thread pool, if any."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    @property
    def afc_freqs(self):
        """Per-channel AFC-tracked carrier offsets in Hz (a host [C]
        float32 array), or None when config.afc is off. On a mesh, of the
        merged state; a channel that another process holds reads NaN."""
        if not self.config.afc:
            return None
        if self.mesh is None:
            return self.state.aux[-1].cpu().numpy()
        freqs = np.full(self.config.channels, np.nan, np.float32)
        for base, part in zip(self.state.starts, self.state.parts):
            f = part.aux[-1].cpu().numpy()
            freqs[base:base + f.size] = f
        return freqs

    def global_state(self):
        """The state of every channel on ``device``: the shards merged on
        a mesh (which must hold every shard: one process)."""
        if self.mesh is None:
            return self.state
        if len(self.local_channels()) != self.config.channels:
            raise ValueError("the global state of a multi-process mesh "
                             "session is split across processes")
        return merge_state(self.state.parts, self.device)

    def set_global_state(self, state) -> None:
        """Replace the state by a global one (on any device), sharded
        again on a mesh."""
        if self.mesh is None:
            self.state = state
        else:
            self.state = self._shard_fn(state)

    def local_channels(self) -> List[int]:
        """Global channel indices whose state and output this process
        holds (every channel in a single-process run), from the shards it
        holds."""
        if self.mesh is None:
            return list(range(self.config.channels))
        per = self.state.parts[0].timing.pos.shape[0]
        return [c for b in self.state.starts for c in range(b, b + per)]

    def reset_channel(self, channel: int) -> None:
        """Drop a channel's host state; the device state re-syncs on the
        next frames by itself, except the AFC-tracked frequency: its row of
        state.aux[-1] is reseeded to the channel's fine_offsets seed on the
        device (every other row and leaf untouched), so a loop that
        mis-tracked to its clamp does not hand the old sonde's offset to
        the next sonde on this channel."""
        self.decoder.reset_channel(channel)
        self.telemetry.pop(channel, None)
        self._last_update_block.pop(channel, None)
        if self.config.afc:
            offs = self.config.fine_offsets
            seed = float(np.float32(offs[channel] if offs is not None
                                    else 0.0))
            if self.mesh is None:
                self.state = _reseed(self.state, channel, seed)
                return
            # only the owner reseeds (its own watchdog fires for its own
            # channels); every other shard is untouched
            parts = list(self.state.parts)
            for j, base in enumerate(self.state.starts):
                if base <= channel < base + parts[j].timing.pos.shape[0]:
                    parts[j] = _reseed(parts[j], channel - base, seed)
            self.state = self.state._replace(parts=tuple(parts))

    def watchdog(self, max_idle_blocks: int) -> List[int]:
        """Reset the channels that produced no telemetry for more than
        max_idle_blocks blocks; returns them."""
        stale = [ch for ch, blk in self._last_update_block.items()
                 if self.blocks_seen - blk > max_idle_blocks]
        for ch in stale:
            self.reset_channel(ch)
        return stale

    def process_block(self, iq) -> List[Tuple[int, SondeTelemetry]]:
        """iq: [channels, block_len] complex64 or (i, q) planes.
        Returns (channel, telemetry snapshot) updates (for the previous
        block when ``pipelined``)."""
        t0 = time.perf_counter()
        if self.mesh is not None:
            pi, pq = iq if isinstance(iq, tuple) else \
                c64_to_planes(np.asarray(iq))
            # a host array uploads its slabs; a tensor (a fleet's PFB rows)
            # is sliced where it lies and moved device to device
            self.state, out = self._sharded_step(
                self.state, self._shard_fn(pi), self._shard_fn(pq))
        else:
            self.state, out = self.pipeline.step(self.state, iq)
        self.blocks_seen += 1
        if self.pipelined:
            out, self._pending = self._pending, out
            if out is None:
                self.metrics.on_block(self.config.block_len,
                                      time.perf_counter() - t0, 0, 0, 0)
                return []
        updates, frames_raw, decoded, soft_rms = self._handle_output(out)
        self.metrics.on_block(
            n_samples_per_chan=self.config.block_len,
            wall_seconds=time.perf_counter() - t0,
            frames_raw=frames_raw, frames_decoded=decoded,
            updates=len(updates), soft_rms=soft_rms)
        return updates

    def flush(self) -> List[Tuple[int, SondeTelemetry]]:
        """Drain the pending block in pipelined mode (call at end of stream)."""
        if not self.pipelined or self._pending is None:
            return []
        out, self._pending = self._pending, None
        updates, frames_raw, decoded, soft_rms = self._handle_output(out)
        self.metrics.on_block(0, 0.0, frames_raw, decoded, len(updates),
                              soft_rms)
        return updates

    def _packed_parts(self, out):
        """Host copies of the packed buffer as (channel_base, bytes) parts:
        one device->host transfer of the whole buffer, or, on a mesh, one
        per shard, parts of contiguous channels merged (a process reads
        only its own shards back). The buffer may already be a host array
        (the fleet reads several sessions' buffers back at once)."""
        if not isinstance(out, Shards):
            packed = out.packed
            if isinstance(packed, torch.Tensor):
                packed = packed.cpu().numpy()
            return [(0, packed)]
        row = self.config.packed_row_bytes
        merged = []
        for base, o in zip(out.starts, out.parts):
            data = o.packed.cpu().numpy()
            if merged and merged[-1][0] + merged[-1][1].size // row == base:
                merged[-1] = (merged[-1][0],
                              np.concatenate([merged[-1][1], data]))
            else:
                merged.append((base, data))
        return merged

    def _handle_output(self, out):
        """Decode one block's packed buffer (a BlockOutput, or on a mesh
        the Shards of the shards' BlockOutputs) part by part, each at its
        global channel base."""
        cfg = self.config
        updates: List[Tuple[int, SondeTelemetry]] = []
        frames_total, frags_total = 0, 0
        # full-length quality vector, indexed by GLOBAL channel id (the
        # channels of other processes read 0)
        soft_rms = np.zeros(cfg.channels, np.float32)
        for ch_base, packed in self._packed_parts(out):
            res = unpack_block_output(packed, cfg.k_slots, cfg.wire_ncols,
                                      cfg.chase_total)
            weak_all = None
            if cfg.chase_m:
                all_frames, valid, rs_clean, part_rms, weak_all = res
            else:
                all_frames, valid, rs_clean, part_rms = res
            soft_rms[ch_base:ch_base + part_rms.size] = part_rms
            if not valid.any():
                continue
            ch_loc, slot_idx = np.nonzero(valid)
            frames = all_frames[ch_loc, slot_idx]         # [n, wire_ncols]
            ch_idx = ch_loc + ch_base                     # global channels
            self.frames_seen += frames.shape[0]
            frames_total += int(frames.shape[0])
            clean = rs_clean[ch_loc, slot_idx]
            cols = cfg.wire_columns
            # compact mode: the suspect rows' full frames (for host FEC)
            # come in ONE device gather, so the workers stay pure NumPy
            full = None
            sus_ord = None
            if cols is not None:
                suspect = ~clean
                if suspect.any():
                    full = self._fetch_full(out, ch_idx[suspect],
                                            slot_idx[suspect])
                    sus_ord = np.cumsum(suspect) - 1
            # the original's order of branches (sondetpu/runtime/
            # session.py:255-275)
            if weak_all is not None and getattr(self.decoder,
                                                "wants_weak_bits", False):
                # soft-assist families: hand the device's weakest-bit ranks
                # to the Chase repair in the host parser
                frags = self.decoder.decode_byte_frames(
                    frames, ch_idx, weak_bits=weak_all[ch_loc, slot_idx])
            elif self._pool is not None and \
                    ch_idx.size >= 4 * self.host_workers:
                frags = self._decode_parallel(frames, ch_idx, clean, cols,
                                              full, sus_ord)
            elif cols is not None:
                frags = self._decode_rows(frames, ch_idx, clean, cols, full,
                                          sus_ord, 0)
            elif getattr(self.decoder, "wants_rs_clean", False):
                frags = self.decoder.decode_byte_frames(frames, ch_idx,
                                                        rs_clean=clean)
            else:
                frags = self.decoder.decode_byte_frames(frames, ch_idx)
            frags_total += len(frags)
            updates += self._merge_frags(frags)
        return updates, frames_total, frags_total, soft_rms

    def _fetch_full(self, out, ch_idx, slot_idx) -> np.ndarray:
        """The full frames of (channel, slot) pairs from the device; on a
        mesh from the shard that holds each channel (this process's own,
        by construction of the packed-part readback)."""
        if not isinstance(out, Shards):
            return self.pipeline.fetch_frames(out.frames, ch_idx, slot_idx)
        res = np.zeros((len(ch_idx), self.config.spec.frame_bytes),
                       np.uint8)
        for base, o in zip(out.starts, out.parts):
            sel = np.nonzero((ch_idx >= base)
                             & (ch_idx < base + o.frames.shape[0]))[0]
            if sel.size:
                res[sel] = self.pipeline.fetch_frames(
                    o.frames, ch_idx[sel] - base, slot_idx[sel])
        return res

    def telemetry_fanin(self, cap: Optional[int] = None) -> dict:
        """Every process's numeric telemetry rows, gathered over the
        process group: {channel: {field: value}} on EVERY process (with one
        process, this session's telemetry). The wire cap defaults to the
        channel count (every process runs the same config, so the
        collective's shape agrees): no channel can drop silently."""
        if cap is None:
            cap = max(1, self.config.channels)
        rows = fanin.telemetry_rows(self.telemetry)
        return fanin.rows_to_dict(fanin.allgather_rows(rows, cap=cap))

    def metrics_fanin(self) -> dict:
        """Counter sums over every process (the original's psum)."""
        m = self.metrics
        tot = fanin.sum_counts([self.frames_seen, m.frames_decoded,
                                m.updates, self.blocks_seen])
        return {"frames_raw": int(tot[0]), "frames_decoded": int(tot[1]),
                "updates": int(tot[2]),
                "blocks": int(tot[3] // process_count())}

    def _merge_frags(self, frags) -> List[Tuple[int, SondeTelemetry]]:
        updates: List[Tuple[int, SondeTelemetry]] = []
        for ch, frag in frags:
            ch = int(ch)
            telem = self.telemetry.get(ch)
            if telem is None:
                telem = self.telemetry[ch] = SondeTelemetry()
            if telem.merge(frag):
                self._last_update_block[ch] = self.blocks_seen
                # snapshot: the live object keeps mutating on later frames
                snap = telem.snapshot()
                updates.append((ch, snap))
                if self.on_update:
                    self.on_update(ch, snap)
        return updates

    def _decode_rows(self, wire: np.ndarray, ch: np.ndarray,
                     clean: np.ndarray, cols: np.ndarray,
                     full: Optional[np.ndarray], sus_ord: Optional[np.ndarray],
                     row0: int):
        """Compact wire-column readback for one row range [row0, row0+len):
        RS-clean frames are reconstructed column-sparse and parsed without
        CRC re-checks (the device syndrome already proves integrity);
        suspect frames use the prefetched full gather ``full`` (``sus_ord``
        maps global row -> row of full)."""
        fb = self.config.spec.frame_bytes
        frags = []
        if clean.any():
            recon = np.zeros((int(clean.sum()), fb), np.uint8)
            recon[:, np.asarray(cols)] = wire[clean]
            frags += self.decoder.decode_byte_frames(
                recon, ch[clean], rs_clean=np.ones(recon.shape[0], bool),
                crc_present=False)
        suspect = ~clean
        if suspect.any():
            rows = np.nonzero(suspect)[0] + row0
            frags += self.decoder.decode_byte_frames(
                full[sus_ord[rows]], ch[suspect],
                rs_clean=np.zeros(int(suspect.sum()), bool))
        return frags

    def _decode_parallel(self, frames: np.ndarray, ch_idx: np.ndarray,
                         clean: np.ndarray, cols, full, sus_ord):
        """The byte-level decode over the thread pool on channel-aligned
        row ranges (ch_idx is sorted: np.nonzero's row order), fragments in
        row order (sondetpu/runtime/session.py:372-398)."""
        n = ch_idx.size
        w = self.host_workers
        bounds = [0]
        for k in range(1, w):
            p = k * n // w
            while 0 < p < n and ch_idx[p] == ch_idx[p - 1]:
                p += 1                  # never split a channel across workers
            bounds.append(p)
        bounds.append(n)
        ranges = [(a, b) for a, b in zip(bounds, bounds[1:]) if b > a]

        def work(ab):
            a, b = ab
            sl = slice(a, b)
            if cols is not None:
                return self._decode_rows(frames[sl], ch_idx[sl], clean[sl],
                                         cols, full, sus_ord, a)
            if getattr(self.decoder, "wants_rs_clean", False):
                return self.decoder.decode_byte_frames(
                    frames[sl], ch_idx[sl], rs_clean=clean[sl])
            return self.decoder.decode_byte_frames(frames[sl], ch_idx[sl])

        return [f for r in self._pool.map(work, ranges) for f in r]


def _reseed(state, row: int, seed: float):
    """``state`` with row ``row`` of its AFC-tracked frequency
    (state.aux[-1]) set to ``seed``; every other row and leaf untouched."""
    freqs = state.aux[-1].clone()
    freqs[row] = seed
    return state._replace(aux=state.aux[:-1] + (freqs,))


def _index(device: torch.device) -> torch.device:
    """``device`` with its index (a CUDA device without one is the current
    one)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
