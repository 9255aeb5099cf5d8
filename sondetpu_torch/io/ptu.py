"""PTU CSV log sink (a copy of
``sondetpu/io/ptu.py``).

Re-implements the reference PTU writer (src/ptu.cpp:3-35): identical header
row (ptu.cpp:11), identical column order and formatting (ptu.cpp:27-33), one
row per decoded fragment, flushed per row (ptu.cpp:34).
"""

from __future__ import annotations

from typing import Optional

from sondetpu_torch.telemetry import SondeTelemetry

_HEADER = (
    "Epoch,Temperature,Relative humidity,Dew point,Pressure,"
    "Latitude,Longitude,Altitude,Speed,Heading,Climb,XDATA\n"
)


class PTUWriter:
    def __init__(self, fname: Optional[str] = None):
        self._fd = None
        if fname is not None:
            if not self.init(fname):
                raise OSError(f"cannot open PTU file {fname!r}")

    def init(self, fname: str) -> bool:
        if self._fd:
            self.deinit()
        try:
            self._fd = open(fname, "w")
        except OSError:
            self._fd = None
            return False
        self._fd.write(_HEADER)
        return True

    def deinit(self) -> None:
        if not self._fd:
            return
        self._fd.close()
        self._fd = None

    close = deinit

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.deinit()

    def add_point(self, data: SondeTelemetry) -> None:
        if not self._fd:
            return
        self._fd.write(
            f"{int(data.time)},{data.temp:.1f},{data.rh:.1f},{data.dewpt:.1f},"
            f"{data.pressure:.1f},{data.lat:.6f},{data.lon:.6f},{data.alt:.1f},"
            f"{data.spd:.1f},{data.hdg:.1f},{data.climb:.1f},{data.aux_data}\n"
        )
        self._fd.flush()
