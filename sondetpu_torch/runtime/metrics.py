"""Metrics / observability (counterpart: ``sondetpu/runtime/metrics.py``).

A copy of ``Metrics``: the original module is reached only through
``sondetpu.runtime``, whose package import pulls in jax.

A :class:`Metrics` instance is fed by the decode session every block and
renders either a human status line or a JSON record of the north-star
counters: IQ Msamples/s, concurrent real-time channels, frames decoded,
per-channel lock status.

:func:`span` takes the place of the original's ``trace()``, which wrapped
jax.profiler: a named range (``sondetpu.<stage>``) around each stage of the
pipeline's and the fleet's step and of the session's block. While a
``torch.profiler`` session runs (the CLI's ``--trace``, a benchmark's
traced run, or an operator's own), each span is a ``record_function``
range in its trace, on the clock of the kernels, copies and CUDA runtime
calls it launched; otherwise it is one shared no-op context.

The vocabulary: the entries ``sondetpu.step`` and ``sondetpu.fleet.step``;
inside the fleet's, ``sondetpu.fleet.pfb``, ``sondetpu.group.<sonde>`` and
``sondetpu.fleet.pack``; the pipeline's stages ``sondetpu.ingest``,
``.ddc``, ``.frontend``, ``.afc``, ``.timing``, ``.sample``, ``.ring``,
``.corr``, ``.peaks``, ``.gather``, ``.syndrome`` and ``.pack``; inside
``sondetpu.frontend`` on the plain-op path ``sondetpu.chanfilt``,
``.demod`` and ``.matched``; the midpoint DC of the midpoint-DC families
(ims100, mrzn1) in ``sondetpu.midpoint``, inside ``sondetpu.frontend`` on
the kernel route and inside ``sondetpu.demod`` on the plain-op path; and
the session's ``sondetpu.session.step``, ``.readback``, ``.decode`` and
``.fetch``.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler session is active; otherwise the shared no-op context, so that
    an untraced step enters no RecordFunction and allocates nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@dataclass
class Metrics:
    channels: int = 0
    fs: float = 48000.0
    samples_in: int = 0            # complex samples ingested (all channels)
    frames_raw: int = 0            # frames gathered on device
    frames_decoded: int = 0        # frames surviving FEC/CRC + parse
    updates: int = 0               # telemetry merges fired
    blocks: int = 0
    started_at: float = field(default_factory=time.monotonic)
    busy_seconds: float = 0.0      # wall time inside step+readback
    last_rms: Optional[np.ndarray] = None   # [C] chip-level quality

    def on_block(self, n_samples_per_chan: int, wall_seconds: float,
                 frames_raw: int, frames_decoded: int, updates: int,
                 soft_rms: Optional[np.ndarray] = None) -> None:
        self.blocks += 1
        self.samples_in += n_samples_per_chan * self.channels
        self.busy_seconds += wall_seconds
        self.frames_raw += frames_raw
        self.frames_decoded += frames_decoded
        self.updates += updates
        if soft_rms is not None:
            self.last_rms = np.asarray(soft_rms)

    # -- derived ------------------------------------------------------------

    @property
    def msamples_per_sec(self) -> float:
        """Sustained device throughput (north-star metric, BASELINE.json:2)."""
        if self.busy_seconds == 0:
            return 0.0
        return self.samples_in / self.busy_seconds / 1e6

    @property
    def realtime_channels(self) -> float:
        """How many channels of rate fs this throughput sustains live."""
        return self.msamples_per_sec * 1e6 / self.fs

    @property
    def frame_yield(self) -> float:
        """Fraction of gathered frames that decoded (1 - FER upper bound)."""
        if self.frames_raw == 0:
            return 0.0
        return self.frames_decoded / self.frames_raw

    def locked_channels(self, rms_threshold: float = 0.3) -> int:
        if self.last_rms is None:
            return 0
        return int((self.last_rms > rms_threshold).sum())

    def to_dict(self) -> dict:
        return {
            "blocks": self.blocks,
            "channels": self.channels,
            "msamples_per_sec": round(self.msamples_per_sec, 3),
            "realtime_channels": round(self.realtime_channels, 1),
            "frames_raw": self.frames_raw,
            "frames_decoded": self.frames_decoded,
            "frame_yield": round(self.frame_yield, 4),
            "updates": self.updates,
            "locked_channels": self.locked_channels(),
        }

    def json_line(self) -> str:
        return json.dumps(self.to_dict())

    def status_line(self) -> str:
        d = self.to_dict()
        return (f"[{d['blocks']:5d}] {d['msamples_per_sec']:8.2f} Msps "
                f"({d['realtime_channels']:7.0f} rt-ch) frames "
                f"{d['frames_decoded']}/{d['frames_raw']} "
                f"locked {d['locked_channels']}/{d['channels']}")
