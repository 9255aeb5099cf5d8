"""Host-side decode session: steps the pipeline, aggregates telemetry
(counterpart: ``sondetpu/runtime/session.py``).

Single-process form of the original's ``DecoderSession``: it steps the
port's pipeline, reads the packed buffer back to the host, runs the
family's byte-level FEC and parse (with the device's weakest-bit ranks for
the Chase repair of m10; over a thread pool on channel-aligned rows with
``host_workers``), and merges fragments into per-channel telemetry. It
carries the original's AFC read-out (``afc_freqs``), ``reset_channel``
(which reseeds a channel's AFC-tracked frequency) and ``watchdog``; the
mesh and fan-in duties are not ported. In pipelined mode the readback of
block k happens after block k+1 is stepped, so telemetry lags the input by
one block, as in the original; the readback itself (``packed.cpu()``)
still waits for the device.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sondetpu_torch.runtime.metrics import Metrics
from sondetpu_torch.runtime.pipeline import (BlockOutput, Pipeline,
                                             PipelineConfig,
                                             unpack_block_output)
from sondetpu_torch.sondes.base import get_sonde
from sondetpu_torch.telemetry import SondeTelemetry


class DecoderSession:
    """Streaming decode of [channels, block] IQ into telemetry updates."""

    def __init__(self, config: PipelineConfig, device,
                 on_update: Optional[Callable[[int, SondeTelemetry], None]] = None,
                 pipelined: bool = False, host_workers: int = 0,
                 pipeline: Optional[Pipeline] = None):
        self.config = config
        self.device = torch.device(device)
        # callers that already hold a Pipeline for this config reuse it
        self.pipeline = (pipeline if pipeline is not None
                         else Pipeline(config, self.device))
        self.state = self.pipeline.init_state()
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
        float32 array), or None when config.afc is off."""
        if not self.config.afc:
            return None
        return self.state.aux[-1].cpu().numpy()

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
            freqs = self.state.aux[-1].clone()
            freqs[channel] = float(np.float32(
                offs[channel] if offs is not None else 0.0))
            self.state = self.state._replace(
                aux=self.state.aux[:-1] + (freqs,))

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

    def _handle_output(self, out: BlockOutput):
        """Decode one block's packed buffer. ``out.packed`` is read back
        here (ONE device->host transfer), or is already a host array when
        the caller read several sessions' buffers back at once (the
        fleet)."""
        cfg = self.config
        packed = out.packed
        if isinstance(packed, torch.Tensor):
            packed = packed.cpu().numpy()
        res = unpack_block_output(packed, cfg.k_slots, cfg.wire_ncols,
                                  cfg.chase_total)
        weak_all = None
        if cfg.chase_m:
            all_frames, valid, rs_clean, soft_rms, weak_all = res
        else:
            all_frames, valid, rs_clean, soft_rms = res
        if not valid.any():
            return [], 0, 0, soft_rms
        ch_idx, slot_idx = np.nonzero(valid)
        frames = all_frames[ch_idx, slot_idx]             # [n, wire_ncols]
        self.frames_seen += frames.shape[0]
        clean = rs_clean[ch_idx, slot_idx]
        cols = cfg.wire_columns
        # compact mode: the suspect rows' full frames (for host FEC) come in
        # ONE device gather, so the workers stay pure NumPy
        full = None
        sus_ord = None
        if cols is not None:
            suspect = ~clean
            if suspect.any():
                full = self._fetch_full(out, ch_idx[suspect], slot_idx[suspect])
                sus_ord = np.cumsum(suspect) - 1
        # the original's order of branches (sondetpu/runtime/session.py:
        # 255-275)
        if weak_all is not None and getattr(self.decoder, "wants_weak_bits",
                                            False):
            # soft-assist families: hand the device's weakest-bit ranks to
            # the Chase repair in the host parser
            frags = self.decoder.decode_byte_frames(
                frames, ch_idx, weak_bits=weak_all[ch_idx, slot_idx])
        elif self._pool is not None and ch_idx.size >= 4 * self.host_workers:
            frags = self._decode_parallel(frames, ch_idx, clean, cols, full,
                                          sus_ord)
        elif cols is not None:
            frags = self._decode_rows(frames, ch_idx, clean, cols, full,
                                      sus_ord, 0)
        elif getattr(self.decoder, "wants_rs_clean", False):
            frags = self.decoder.decode_byte_frames(frames, ch_idx,
                                                    rs_clean=clean)
        else:
            frags = self.decoder.decode_byte_frames(frames, ch_idx)
        updates = self._merge_frags(frags)
        return updates, int(frames.shape[0]), len(frags), soft_rms

    def _fetch_full(self, out: BlockOutput, ch_idx, slot_idx) -> np.ndarray:
        return self.pipeline.fetch_frames(out.frames, ch_idx, slot_idx)

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
