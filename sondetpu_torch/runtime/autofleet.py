"""Self-managing wideband decoding: discover sondes as they launch
(counterpart: ``sondetpu/runtime/autofleet.py``).

The reference's operating model is a human watching the waterfall and
creating one module instance per sonde as carriers appear
(main.cpp:23,55-56,136-151). :class:`AutoFleet` closes that loop: every
``rescan_blocks`` wideband blocks it re-runs the PSD carrier scan
(``dsp/scan.py``) over the last ``probe_blocks`` blocks, classifies the
carriers it has not seen before by decode-probing them, and extends the
fleet's channel map; carriers that stay silent are dropped after
``drop_idle_blocks``. Last-known telemetry is kept per tracked sonde
across rebuilds. Everything runs on ``device``.

A membership change rebuilds the fleet. The original carries a surviving
group's session across the rebuild by putting the old session into the
new fleet's ``groups`` (``sondetpu/runtime/autofleet.py:162-172``), but
its default fused step advances the sessions it built itself
(``sondetpu/runtime/fleet.py:177-180, 401``), so in effect every group
restarts with zero state and a fresh decoder, and the transplanted session
stands still. The port reproduces what the original's step does: the new
fleet keeps its own sessions, so ``fleet.groups`` and the step hold the
same objects, and only the PFB's carry (``pfb_state``) crosses a rebuild.
The update stream, :attr:`AutoFleet.telemetry` and the JSONL equal the
original's. After a rebuild that a group survives, the port reads that
group's live session where the original reads the frozen one in exactly
three places: ``fleet.telemetry``, the AFC fold-back of
:meth:`AutoFleet._refresh_centers`, and the group payload that
``checkpoint.save_autofleet`` writes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sondetpu_torch.dsp.channelizer import bin_and_offset
from sondetpu_torch.dsp.scan import (classify_carriers, detect_carriers,
                                     device_planes)
from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession
from sondetpu_torch.telemetry import SondeTelemetry


@dataclass
class TrackedSonde:
    """One discovered emitter being decoded.

    ``pfb_bin``/``seed_offset_hz`` are the carrier's IDENTITY in the fleet
    (fixed at discovery — group layouts and checkpoints compare against
    them); ``center_hz`` is the LIVE estimate, refreshed from AFC each
    rescan so a drifting sonde keeps matching itself."""

    center_hz: float
    sonde: str
    pfb_bin: int = -1
    seed_offset_hz: float = 0.0
    last_update_block: int = 0
    found_block: int = 0
    telem: Optional[SondeTelemetry] = None   # last-known, survives rebuilds


class AutoFleet:
    """Wideband IQ in, telemetry out — channels managed automatically, on
    ``device``."""

    def __init__(self, n_bins: int, device, fs_chan: float = 48000.0,
                 block_len: int = 48000, rescan_blocks: int = 10,
                 min_snr_db: float = 8.0, families=None,
                 sync_threshold: float = 0.55, probe_blocks: int = 2,
                 drop_idle_blocks: int = 0, on_update=None,
                 on_change=None, compute_dtype: str = "f32",
                 afc: bool = False, use_pallas: bool = False):
        self.n_bins = n_bins
        self.device = torch.device(device)
        self.fs_chan = fs_chan
        self.fs_wide = n_bins * fs_chan
        self.block_len = block_len
        self.rescan_blocks = rescan_blocks
        self.min_snr_db = min_snr_db
        self.families = families
        self.sync_threshold = sync_threshold
        self.probe_blocks = max(1, probe_blocks)
        self.drop_idle_blocks = drop_idle_blocks
        self.on_update = on_update
        self.on_change = on_change          # callback(list[TrackedSonde])
        self.compute_dtype = compute_dtype
        self.afc = afc
        self.use_pallas = use_pallas

        self.tracked: List[TrackedSonde] = []
        self.blocks_seen = 0
        self.fleet: Optional[FleetSession] = None
        # the last wideband blocks as given: complex host arrays or (i, q)
        # pairs of arrays or tensors
        self._recent: list = []
        # carriers that failed classification (interference, unknown
        # protocols): remembered so they are not re-probed every rescan;
        # retried after retry_failed_blocks
        self._failed: List[Tuple[float, int]] = []   # (center_hz, block)
        self.retry_failed_blocks = 10 * rescan_blocks

    @property
    def telemetry(self) -> Dict[int, Tuple[str, SondeTelemetry]]:
        """Last-known telemetry keyed by tracked-sonde index."""
        return {i: (t.sonde, t.telem) for i, t in enumerate(self.tracked)
                if t.telem is not None}

    # -- internals ----------------------------------------------------------

    def _fleet_update(self, ch: int, sonde: str, telem: SondeTelemetry) -> None:
        if ch < len(self.tracked):
            self.tracked[ch].last_update_block = self.blocks_seen
            self.tracked[ch].telem = telem
        if self.on_update is not None:
            self.on_update(ch, sonde, telem)

    def _wrap_df(self, a: float, b: float) -> float:
        """Circular frequency distance (the wideband spectrum wraps at
        +/-fs_wide/2; a near-Nyquist carrier and its alias are the same)."""
        fs = self.fs_wide
        return abs((a - b + fs / 2.0) % fs - fs / 2.0)

    def _known(self, center_hz: float) -> bool:
        return any(self._wrap_df(t.center_hz, center_hz) < 0.25 * self.fs_chan
                   for t in self.tracked)

    def _recently_failed(self, center_hz: float) -> bool:
        self._failed = [(f, b) for f, b in self._failed
                        if self.blocks_seen - b <= self.retry_failed_blocks]
        return any(self._wrap_df(f, center_hz) < 0.25 * self.fs_chan
                   for f, _ in self._failed)

    def _rebuild(self) -> None:
        """Apply the current ``tracked`` list as the fleet's channel map.
        Every group gets the new fleet's own session (the module docstring
        says why); the PFB's carry crosses over."""
        if self.fleet is not None:     # not on first build / checkpoint
            # a group whose membership changed re-seeds its members'
            # identities from the live (drift-corrected) centers, so its
            # new session starts tuned to where each carrier is now
            old_layouts = {
                sonde: [(self.fleet.channels[j].pfb_bin,
                         self.fleet.channels[j].offset_hz) for j in idxs]
                for sonde, (idxs, _s) in self.fleet.groups.items()}
            members: Dict[str, List[TrackedSonde]] = {}
            for t in self.tracked:
                members.setdefault(t.sonde, []).append(t)
            for sonde, ts in members.items():
                layout = [(t.pfb_bin, t.seed_offset_hz) for t in ts]
                if old_layouts.get(sonde) != layout:
                    for t in ts:
                        t.pfb_bin, t.seed_offset_hz = bin_and_offset(
                            t.center_hz, self.fs_chan, self.n_bins)
        chans = [FleetChannel(pfb_bin=t.pfb_bin, sonde=t.sonde,
                              offset_hz=t.seed_offset_hz)
                 for t in self.tracked]
        if not chans:
            self.fleet = None
            if self.on_change is not None:
                self.on_change([])
            return
        fleet = FleetSession(chans, self.n_bins, self.device,
                             fs_chan=self.fs_chan, block_len=self.block_len,
                             sync_threshold=self.sync_threshold,
                             compute_dtype=self.compute_dtype, afc=self.afc,
                             use_pallas=self.use_pallas,
                             on_update=self._fleet_update)
        if self.fleet is not None:
            fleet.pfb_state = self.fleet.pfb_state
        self.fleet = fleet
        if self.on_change is not None:
            self.on_change(list(self.tracked))

    def _refresh_centers(self) -> None:
        """Fold each channel's AFC-tracked offset back into its tracked
        center frequency, so a drifting transmitter keeps matching itself
        in later scans instead of re-appearing as a 'new' carrier."""
        if self.fleet is None or not self.afc:
            return
        for sonde, (idxs, sess) in self.fleet.groups.items():
            freqs = sess.afc_freqs
            if freqs is None:
                continue
            for local, fleet_ch in enumerate(idxs):
                t = self.tracked[fleet_ch]
                k = t.pfb_bin                   # fixed discovery identity
                f_bin = (k if k < self.n_bins / 2 else k - self.n_bins) \
                    * self.fs_chan
                center = f_bin + float(freqs[local])
                # wrap into [-fs_wide/2, fs_wide/2)
                t.center_hz = ((center + self.fs_wide / 2.0) % self.fs_wide
                               - self.fs_wide / 2.0)

    def _rescan(self) -> None:
        self._refresh_centers()
        # the buffer's entries may be complex blocks or plane pairs of
        # arrays or tensors, mixed if the caller switches forms: each goes
        # to the device as planes, and the scan reads one concatenation
        planes = [device_planes(b, self.device) for b in self._recent]
        wide = (torch.cat([p[0] for p in planes]),
                torch.cat([p[1] for p in planes]))
        del planes
        carriers = detect_carriers(wide, self.fs_wide,
                                   min_snr_db=self.min_snr_db,
                                   device=self.device)
        fresh = [c for c in carriers if not self._known(c.center_hz)
                 and not self._recently_failed(c.center_hz)]
        changed = False
        if fresh:
            fresh = classify_carriers(
                wide, self.fs_wide, fresh, fs_chan=self.fs_chan,
                block_len=self.block_len, families=self.families,
                sync_threshold=self.sync_threshold, device=self.device)
            for c in fresh:
                if c.sonde is not None:
                    k, resid = bin_and_offset(c.center_hz, self.fs_chan,
                                              self.n_bins)
                    self.tracked.append(TrackedSonde(
                        center_hz=c.center_hz, sonde=c.sonde,
                        pfb_bin=k, seed_offset_hz=resid,
                        last_update_block=self.blocks_seen,
                        found_block=self.blocks_seen))
                    changed = True
                else:
                    self._failed.append((c.center_hz, self.blocks_seen))
        if self.drop_idle_blocks:
            keep = [t for t in self.tracked
                    if self.blocks_seen - t.last_update_block
                    <= self.drop_idle_blocks]
            if len(keep) != len(self.tracked):
                self.tracked = keep
                changed = True
        if changed:
            self._rebuild()

    # -- public -------------------------------------------------------------

    def process_wideband(self, iq) -> int:
        """One wideband block: [n_bins * block_len] complex64 (host) or an
        (i, q) plane pair of arrays or tensors (the plane form avoids a
        complex copy on the streaming hot path). Returns telemetry
        updates."""
        if not isinstance(iq, tuple):
            iq = np.asarray(iq)
        self._recent.append(iq)
        if len(self._recent) > self.probe_blocks:
            self._recent.pop(0)
        updates = 0
        if self.fleet is not None:
            updates = self.fleet.process_wideband(iq)
        self.blocks_seen += 1
        # rescan on cadence; while the fleet is EMPTY scan every block once
        # the probe buffer fills (first acquisition should not wait out a
        # cadence) — the failed-classification cache bounds the cost when
        # the only emissions are unclassifiable
        if (self.rescan_blocks and self.blocks_seen % self.rescan_blocks == 0
                or (self.fleet is None
                    and len(self._recent) >= self.probe_blocks)):
            self._rescan()
        return updates
