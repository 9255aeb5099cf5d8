"""Crash-safe GPX 1.1 track writer (a copy of
``sondetpu/io/gpx.py``).

Re-implements the reference GPX sink semantics (src/gpx.cpp:9-120):

- the file on disk is *always* valid XML: after every mutation the closing
  tags are rewritten at the current offset and the offset rewound
  (``terminateFile`` trick, gpx.cpp:98-110);
- one ``<trk>`` per sonde serial; ``start_track`` with the currently-active
  name is a no-op, a different name closes the old track (gpx.cpp:39-57);
- serial names must be printable-non-space only (``isgraph`` check,
  gpx.cpp:43);
- points are dropped when lat/lon/alt contain NaN, when all three are zero,
  or when either the timestamp or the full position repeats the previous
  point (dedup rules gpx.cpp:76-78).
"""

from __future__ import annotations

import math
import os
import time as _time
from typing import Optional

_GPX_HEADER = (
    '<?xml version="1.0" encoding="UTF-8" standalone="no" ?>\n'
    '<gpx xmlns="http://www.topografix.com/GPX/1/1" version="1.1" creator="sondetpu">\n'
)


class GPXWriter:
    def __init__(self, fname: Optional[str] = None):
        self._fd = None
        self._offset = 0
        self._track_active = False
        self._serial = ""
        self._lat = self._lon = self._alt = 0.0
        self._time = 0.0
        if fname is not None:
            if not self.init(fname):
                raise OSError(f"cannot open GPX file {fname!r}")

    def init(self, fname: str) -> bool:
        if self._fd:
            self.deinit()
        try:
            self._fd = open(fname, "wb")
        except OSError:
            self._fd = None
            return False
        self._lat = self._lon = self._alt = 0.0
        self._time = 0.0
        self._track_active = False
        self._fd.write(_GPX_HEADER.encode())
        self._offset = self._fd.tell()
        self._terminate_file()
        return True

    def deinit(self) -> None:
        if not self._fd:
            return
        self._terminate_file()
        self._fd.close()
        self._fd = None

    close = deinit

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.deinit()

    def start_track(self, name: str) -> None:
        if not self._fd:
            return
        if self._track_active and name == self._serial:
            return
        # isgraph(): printable and not a space (gpx.cpp:43)
        if any((not c.isprintable()) or c.isspace() for c in name):
            return
        if self._track_active:
            self.stop_track()
        self._serial = name
        from xml.sax.saxutils import escape
        self._fd.seek(self._offset)
        # escape &, <, > — isgraph admits them, and the file's core
        # invariant is "always well-formed XML"
        self._fd.write(
            f"<trk>\n<name>{escape(name)}</name>\n<trkseg>\n".encode())
        self._offset = self._fd.tell()
        self._track_active = True
        self._terminate_file()

    def stop_track(self) -> None:
        if not self._fd or not self._track_active:
            return
        self._stop_track_internal()
        self._track_active = False
        self._terminate_file()

    def add_track_point(
        self, time: float, lat: float, lon: float, alt: float, spd: float, hdg: float
    ) -> None:
        if not self._fd or not self._track_active:
            return
        if math.isnan(lat) or math.isnan(lon) or math.isnan(alt):
            return
        if lat == 0 and lon == 0 and alt == 0:
            return
        if time == self._time or (lat == self._lat and lon == self._lon and alt == self._alt):
            return
        self._lat, self._lon, self._alt, self._time = lat, lon, alt, time
        timestr = _time.strftime("%Y-%m-%dT%H:%M:%SZ", _time.gmtime(time))
        self._fd.seek(self._offset)
        self._fd.write(
            (
                f'<trkpt lat="{lat:f}" lon="{lon:f}">\n'
                f"<time>{timestr}</time>\n"
                f"<ele>{alt:f}</ele>\n"
                f"<speed>{spd:f}</speed>\n"
                f"<course>{hdg:f}</course>\n"
                f"</trkpt>\n"
            ).encode()
        )
        self._offset = self._fd.tell()
        self._terminate_file()

    def _stop_track_internal(self) -> None:
        self._fd.seek(self._offset)
        self._fd.write(b"</trkseg>\n</trk>\n")
        self._offset = self._fd.tell()

    def _terminate_file(self) -> None:
        saved = self._offset
        self._fd.seek(self._offset)
        if self._track_active:
            self._stop_track_internal()
        self._fd.write(b"</gpx>\n")
        self._fd.truncate()
        self._fd.flush()
        self._offset = saved


class MultiGPXWriter:
    """GPX writer for MIXED fleets: one <trk> per sonde serial with
    PER-SERIAL dedup state, safe under interleaved updates from many
    concurrent sondes (a single GPXWriter would thrash start_track on
    every alternation and its writer-global dedup would drop points whose
    timestamps collide across sondes).

    Durability model (keeps the reference's per-point crash-safety
    invariant, gpx.cpp:98-110, at fleet scale): every accepted point is
    APPENDED AND FLUSHED to a per-serial segment file under ``<path>.d/``
    before anything else — a crash loses at most the one partially-written
    point per track, and memory stays O(#serials), not O(#points). The
    merged ``<path>`` master is rebuilt atomically (tmp + replace, always
    complete well-formed XML) every max(8, total/8) points by STREAMING the
    segment files, and on close; a clean close removes the segment
    directory. ``init()`` on a path whose segment directory survived a
    crash recovers every flushed point into the master and continues the
    same tracks."""

    MIN_FLUSH = 8            # master rewrites are O(total points): every
                             # max(8, total/8) adds keeps total rewrite work
                             # O(n log n) on long runs instead of O(n^2)
    MAX_OPEN_FDS = 128       # LRU cap on concurrently-open segment files:
                             # fleet-scale serial counts (10k+) would blow
                             # RLIMIT_NOFILE with one fd per serial

    def __init__(self, path: str = ""):
        self._path = ""
        self._dir = ""
        self._segs: "dict[str, object]" = {}      # serial -> open fd
        self._fnames: "dict[str, str]" = {}       # serial -> segment path
        self._last: "dict[str, tuple]" = {}
        self._pending = 0
        self._total = 0
        if path:
            if not self.init(path):
                raise OSError(f"cannot open GPX output {path!r}")

    def init(self, path: str) -> bool:
        if self._path:
            self.deinit()                  # persist the previous file
        d = path + ".d"
        try:
            os.makedirs(d, exist_ok=True)
        except OSError:
            return False
        self._segs, self._fnames, self._last = {}, {}, {}
        self._pending = self._total = 0
        self._path, self._dir = path, d
        # crash recovery: segment files left by a killed run are adopted —
        # their serials come from the header line inside each file
        for fn in sorted(os.listdir(d)):
            fp = os.path.join(d, fn)
            try:
                with open(fp, "rb") as f:
                    raw_head = f.readline()
                    head = raw_head.decode("utf-8", "replace")
                    if not head.startswith("#serial "):
                        # NOT a segment file (pre-existing dir, another
                        # tool's leftovers, torn header): leave it
                        # untouched — truncating or counting it would
                        # destroy foreign data
                        continue
                    body = f.read()
                # TRUNCATE a torn trailing point NOW, not only at rewrite
                # time: the killed run may have died mid-append, and the
                # adopted file's next append would otherwise land AFTER
                # the torn bytes — a later complete point then makes
                # _rewrite's trailing-trim keep the garbage mid-body and
                # the master is malformed XML forever
                end = body.rfind(b"</trkpt>\n")
                good = len(raw_head) + (end + 9 if end >= 0 else 0)
                if good < len(raw_head) + len(body):
                    with open(fp, "r+b") as f:
                        f.truncate(good)
                    body = body[:end + 9 if end >= 0 else 0]
                self._total += body.count(b"\n<trkpt") + body.startswith(b"<trkpt")
            except OSError:
                continue
            self._fnames[head[8:].rstrip("\n")] = fp
        try:
            self._rewrite()
        except OSError:
            self._path = self._dir = ""
            return False
        return True

    def _segment(self, serial: str):
        fd = self._segs.pop(serial, None)     # pop+reinsert: LRU order
        if fd is None:
            fp = self._fnames.get(serial)
            if fp is None:
                safe = "".join(c if c.isalnum() or c in "._-" else "_"
                               for c in serial)
                fp = os.path.join(self._dir,
                                  f"{safe}-{len(self._fnames):04d}.seg")
                self._fnames[serial] = fp
            new = not os.path.exists(fp)
            fd = open(fp, "ab")
            if new:
                fd.write(f"#serial {serial}\n".encode())
            if len(self._segs) >= self.MAX_OPEN_FDS:
                # evict the least-recently-used open segment (reopens in
                # append mode transparently on the serial's next point)
                old_serial = next(iter(self._segs))
                self._segs.pop(old_serial).close()
        self._segs[serial] = fd
        return fd

    def add_track_point(self, serial: str, time: float, lat: float,
                        lon: float, alt: float, spd: float, hdg: float) -> None:
        if not self._path or not serial:
            return
        if any((not c.isprintable()) or c.isspace() for c in serial):
            return
        if math.isnan(lat) or math.isnan(lon) or math.isnan(alt):
            return
        if lat == 0 and lon == 0 and alt == 0:
            return
        last = self._last.get(serial)
        if last is not None and (time == last[0] or
                                 (lat, lon, alt) == last[1:]):
            return
        self._last[serial] = (time, lat, lon, alt)
        timestr = _time.strftime("%Y-%m-%dT%H:%M:%SZ", _time.gmtime(time))
        fd = self._segment(serial)
        fd.write((f'<trkpt lat="{lat:f}" lon="{lon:f}">\n'
                  f"<time>{timestr}</time>\n"
                  f"<ele>{alt:f}</ele>\n"
                  f"<speed>{spd:f}</speed>\n"
                  f"<course>{hdg:f}</course>\n"
                  f"</trkpt>\n").encode())
        fd.flush()                         # the crash-safety invariant
        self._pending += 1
        self._total += 1
        if self._pending >= max(self.MIN_FLUSH, self._total // 8):
            self._rewrite()

    def _rewrite(self) -> None:
        """Rebuild the merged master by streaming the segment files."""
        from xml.sax.saxutils import escape
        tmp = self._path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_GPX_HEADER.encode())
            for serial, fp in self._fnames.items():
                fd = self._segs.get(serial)
                if fd is not None:
                    fd.flush()
                f.write(f"<trk>\n<name>{escape(serial)}</name>\n"
                        f"<trkseg>\n".encode())
                try:
                    with open(fp, "rb") as seg:
                        seg.readline()     # the #serial header
                        body = seg.read()
                except OSError:
                    body = b""
                # trim a torn trailing point (crash mid-append: ENOSPC,
                # power loss) so the master stays well-formed XML — this is
                # the "loses at most one partially-written point" guarantee
                end = body.rfind(b"</trkpt>\n")
                f.write(body[:end + 9] if end >= 0 else b"")
                f.write(b"</trkseg>\n</trk>\n")
            f.write(b"</gpx>\n")
        os.replace(tmp, self._path)
        self._pending = 0

    def deinit(self) -> None:
        if not self._path:
            return
        self._rewrite()
        for fd in self._segs.values():
            fd.close()
        # clean close: the master holds everything; drop the segment dir
        try:
            for fp in self._fnames.values():
                os.unlink(fp)
            os.rmdir(self._dir)
        except OSError:
            pass
        self._path = self._dir = ""
        self._segs, self._fnames = {}, {}

    close = deinit
