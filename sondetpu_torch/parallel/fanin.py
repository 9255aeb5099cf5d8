"""Cross-process telemetry and metrics fan-in (counterpart:
``sondetpu/parallel/fanin.py``; a copy of its host logic over
``torch.distributed``).

In a run of N >= 2 processes each process reads back and decodes only the
channels of its own shards, so it holds telemetry for a subset of the
channels. These helpers move the small per-process results over the
process group: an all-gather of telemetry rows, and a summed gather of
metrics counters. With one process they are the identity, so the same
code runs in the single-process tests and in a real multi-process run.

Wire precision, as in the original: the wire carries 32-bit values, so
values beyond float32's exact range are split before the gather (epoch
times into (day, second-of-day), counters into 20-bit limbs) and joined
after; the results equal the original's.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from sondetpu_torch.parallel.mesh import process_count

# the numeric fan-in row: channel + the numeric core of SondeTelemetry
# (strings such as the serial ride the JSONL sinks per process); "time" as
# (time_day, time_sod), both exact in float32 (the sod ulp at 86400 is
# ~8 ms)
ROW_FIELDS = ("channel", "lat", "lon", "alt", "spd", "hdg", "climb",
              "temp", "rh", "pressure", "time_day", "time_sod", "seq")
_LIMB = 1 << 20      # counter limb base: both limbs exact in float32/int32


def _allgather(x: np.ndarray) -> np.ndarray:
    """Stack x across processes -> [n_processes, *x.shape] (over gloo, as
    CPU tensors)."""
    if process_count() <= 1:
        return np.asarray(x)[None]
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def allgather_rows(rows: np.ndarray, cap: int = 256) -> np.ndarray:
    """Gather variable-count per-process float rows: [n_local, F] ->
    [n_total, F] on every process.

    ``cap`` is the fixed per-process wire width (the collective needs one
    shape); every process must pass the SAME cap. Size it from the
    session's channel count (DecoderSession.telemetry_fanin does): rows
    beyond it drop WITH a warning, never silently."""
    rows = np.atleast_2d(np.asarray(rows, np.float32))
    n, f = rows.shape if rows.size else (0, len(ROW_FIELDS))
    if n > cap:
        logging.getLogger(__name__).warning(
            "telemetry fan-in dropping %d of %d local rows (cap=%d; raise "
            "the cap to the channel count)", n - cap, n, cap)
    buf = np.zeros((cap, f + 1), np.float32)
    k = min(n, cap)
    if k:
        buf[:k, 0] = 1.0
        buf[:k, 1:] = rows[:k]
    g = _allgather(buf).reshape(-1, f + 1)
    return g[g[:, 0] > 0.5, 1:]


def sum_counts(vec) -> np.ndarray:
    """Sum a per-process counter vector across all processes (frames seen
    and decoded, updates, blocks). Counters go over the 32-bit wire in
    20-bit limbs and are joined after, so totals stay integer-exact far
    beyond the float32/int32 range of one value."""
    ints = [int(round(float(x))) for x in np.ravel(np.asarray(vec))]
    lo = np.asarray([c % _LIMB for c in ints], np.int32)
    hi = np.asarray([c // _LIMB for c in ints], np.int32)
    g = _allgather(np.stack([hi, lo]))          # [P, 2, n]
    g = g.reshape(-1, 2, lo.size).astype(np.int64)
    return (g[:, 0, :] * _LIMB + g[:, 1, :]).sum(axis=0)


def telemetry_rows(telemetry: Dict[int, object]) -> np.ndarray:
    """Encode a session's {channel: SondeTelemetry} as fan-in rows."""
    rows = np.zeros((len(telemetry), len(ROW_FIELDS)), np.float32)
    for i, (ch, t) in enumerate(sorted(telemetry.items())):
        day, sod = divmod(float(t.time), 86400.0)
        rows[i] = (ch, t.lat, t.lon, t.alt, t.spd, t.hdg, t.climb,
                   t.temp, t.rh, t.pressure, day, sod, t.seq)
    return rows


def rows_to_dict(rows: np.ndarray) -> Dict[int, Dict[str, float]]:
    """Decode fan-in rows into {channel: {field: value}};
    (time_day, time_sod) join to "time"."""
    out: Dict[int, Dict[str, float]] = {}
    for r in np.atleast_2d(rows):
        d = dict(zip(ROW_FIELDS[1:], (float(x) for x in r[1:])))
        d["time"] = d.pop("time_day") * 86400.0 + d.pop("time_sod")
        out[int(r[0])] = d
    return out
