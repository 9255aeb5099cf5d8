"""Live terminal telemetry table, the headless analogue of the reference
GUI (a copy of ``sondetpu/io/table.py``).

Renders per-channel running telemetry the way the reference's ImGui panel
does (src/main.cpp:155-297): serial, frame no., onboard UTC time, latitude
with N/S, longitude with E/W, altitude, speed, heading, climb, temperature,
RH, dew point, pressure, and aux data. Values that depend on incomplete
calibration are rendered yellow with the calibration percentage, matching
the reference's UNCAL_COLOR + "(NN%)" tooltip semantics (main.cpp:15,
242-286). Used by `sondetpu decode --table N` (redraws every N blocks).
"""

from __future__ import annotations

import time as _time
from typing import Dict, Optional, Tuple

from sondetpu_torch.telemetry import SondeTelemetry

_YELLOW = "\x1b[33m"
_RESET = "\x1b[0m"
CLEAR = "\x1b[2J\x1b[H"

_COLS = ("ch", "type", "serial", "frame", "time (UTC)", "latitude",
         "longitude", "alt m", "spd m/s", "hdg", "climb", "temp C",
         "RH %", "dew C", "P hPa", "aux")
_WIDTHS = (4, 7, 10, 7, 19, 11, 11, 8, 8, 6, 7, 9, 8, 8, 8, 14)
# optional trailing columns (rendered when the caller supplies the data):
# chip-level signal quality and AFC-tracked carrier offset — receiver
# health the reference surfaces via the waterfall, headless here
_EXTRA_COLS = {"quality": ("sig", 6, lambda v: f"{v:.2f}"),
               "afc_hz": ("afc Hz", 8, lambda v: f"{v:+.0f}")}


def _utc(t: float) -> str:
    if t <= 0:
        return "-"
    return _time.strftime("%Y-%m-%d %H:%M:%S", _time.gmtime(t))


def _latlon(v: float, pos: str, neg: str) -> str:
    hemi = pos if v >= 0 else neg
    return f"{abs(v):.4f}{hemi}"


def render_table(telemetry: Dict[int, Tuple[str, SondeTelemetry]],
                 color: bool = True, title: Optional[str] = None,
                 quality: Optional[Dict[int, float]] = None,
                 afc_hz: Optional[Dict[int, float]] = None) -> str:
    """telemetry: {channel: (sonde_type, SondeTelemetry)} -> table string.

    ``quality`` (chip-level soft RMS) and ``afc_hz`` (tracked carrier
    offset) add per-channel receiver-health columns when provided."""
    extras = [(_EXTRA_COLS[name], data)
              for name, data in (("quality", quality), ("afc_hz", afc_hz))
              if data is not None]
    cols = _COLS + tuple(e[0][0] for e in extras)
    widths = _WIDTHS + tuple(e[0][1] for e in extras)
    lines = []
    if title:
        lines.append(title)
    header = " ".join(f"{c:>{w}s}" for c, w in zip(cols, widths))
    lines.append(header)
    lines.append("-" * len(header))
    for ch in sorted(telemetry):
        stype, t = telemetry[ch]
        # uncalibrated PTU values get the reference's yellow "(NN%)" styling
        def cal(v: str) -> str:
            if t.calibrated or not color:
                return v
            return f"{_YELLOW}{v}{_RESET}"

        pct = "" if t.calibrated else f" ({t.calib_percent:.0f}%)"
        cells = (
            f"{ch}", stype, t.serial or "-", f"{t.seq}", _utc(t.time),
            _latlon(t.lat, "N", "S"), _latlon(t.lon, "E", "W"),
            f"{t.alt:.0f}", f"{t.spd:.1f}", f"{t.hdg:.0f}", f"{t.climb:+.1f}",
            cal(f"{t.temp:.1f}"), cal(f"{t.rh:.0f}"), cal(f"{t.dewpt:.1f}"),
            f"{t.pressure:.1f}", (t.aux_data or "-") + pct,
        )
        for (name, w, fmt), data in extras:
            v = data.get(ch)
            cells = cells + (fmt(v) if v is not None else "-",)
        # pad ignoring the ANSI escape bytes
        row = []
        for cell, w in zip(cells, widths):
            visible = cell.replace(_YELLOW, "").replace(_RESET, "")
            row.append(" " * max(w - len(visible), 0) + cell)
        lines.append(" ".join(row))
    if not telemetry:
        lines.append("(no telemetry yet)")
    return "\n".join(lines)
