"""JSON-lines telemetry sink (a copy of
``sondetpu/io/jsonl.py``).

Headless replacement for the reference's live GUI telemetry table
(src/main.cpp:155-297): every merged telemetry update is emitted as one JSON
object per line (a superset of the PTU CSV columns, ptu.cpp:11), tagged with
the channel id and sonde type so a multi-channel fleet multiplexes into one
stream.
"""

from __future__ import annotations

import json
import math
import sys
from typing import IO, Optional

from sondetpu_torch.telemetry import SondeTelemetry


class JSONLWriter:
    def __init__(self, target: Optional[str] = None):
        self._fd: Optional[IO[str]] = None
        self._owns = False
        if target is not None:
            if not self.init(target):
                # match GPX/PTU: an unopenable sink is an error, not a
                # silent run with zero telemetry written
                raise OSError(f"cannot open JSONL output {target!r}")

    def init(self, target: str) -> bool:
        if self._fd and self._owns:
            self._fd.close()
        if target == "-":
            self._fd = sys.stdout
            self._owns = False
            return True
        try:
            self._fd = open(target, "w")
        except OSError:
            self._fd = None
            return False
        self._owns = True
        return True

    def deinit(self) -> None:
        if self._fd and self._owns:
            self._fd.close()
        self._fd = None

    close = deinit

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.deinit()

    def add_point(self, data: SondeTelemetry, channel: int = 0, sonde_type: str = "") -> None:
        if not self._fd:
            return
        rec = {"channel": channel, "type": sonde_type}
        rec.update(data.to_dict())
        # strict JSON: json.dumps would emit bare NaN/Infinity tokens for
        # not-yet-derivable fields (e.g. climb before the second fix),
        # which breaks jq/strict parsers — null is the faithful encoding
        rec = {k: (None if isinstance(v, float) and not math.isfinite(v)
                   else v) for k, v in rec.items()}
        self._fd.write(json.dumps(rec, allow_nan=False) + "\n")
        self._fd.flush()
