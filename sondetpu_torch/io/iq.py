"""IQ sources: file readers, format conversion, block framing (a copy of
``sondetpu/io/iq.py``).

Supports the common raw-IQ interchange formats (cf32, cs16, cs8, cu8) and
WAV, converts to complex64 or float32 (i, q) planes, and frames the stream
into fixed-size blocks ``[block_len]`` for the pipeline.

The C++ helpers ``csrc/iqconv.cpp`` (conversion, deinterleave) and
``csrc/iqstream.cpp`` (the prefetching stream reader), copies of the
original's, are compiled with the host's C++ compiler at first use into
``build/sondetpu_torch/`` (``sondetpu_torch/cxx.py``). Where no compiler is
at hand, or with ``SONDETPU_NO_NATIVE=1``, NumPy does the same work.
``readers`` counts the calls that went through each of them
(``"native:<entry point>"`` or ``"numpy:<function>"``), so a run can show
which reader ran; :func:`reset_readers` sets every count to 0.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import wave
from typing import Dict, Iterator, Optional

import numpy as np

from sondetpu_torch import cxx

_FORMATS = {
    "cf32": (np.complex64, 8),
    "cf64": (np.complex128, 16),
    "cs16": (np.int16, 4),
    "cs8": (np.int8, 2),
    "cu8": (np.uint8, 2),
}

_native = None
readers: Dict[str, int] = {}


def reset_readers() -> None:
    readers.clear()


def _count(reader: str) -> None:
    readers[reader] = readers.get(reader, 0) + 1


def _build_and_load(source: str, extra_flags=()):
    """The C++ helper ``csrc/<source>``, built at first use; False where it
    cannot be built or loaded (the NumPy path then runs)."""
    try:
        return ctypes.CDLL(cxx.build(source, extra_flags))
    except (OSError, subprocess.SubprocessError):
        return False


def _load_native():
    """Load the C++ conversion library (csrc/iqconv.cpp), building it first.

    SONDETPU_NO_NATIVE=1 disables it like every other native helper (the
    kill-switch must remove ALL native code from the datapath)."""
    global _native
    if _native is not None:
        return _native
    if os.environ.get("SONDETPU_NO_NATIVE"):
        _native = False
        return _native
    lib = _build_and_load("iqconv.cpp")
    if not lib:
        _native = False
        return _native
    try:
        lib.iq_cs16_to_cf32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_float]
        lib.iq_cs8_to_cf32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_float]
        lib.iq_cu8_to_cf32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_float]
        if hasattr(lib, "iq_c64_to_planes"):
            lib.iq_c64_to_planes.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        _native = lib
    except AttributeError:
        _native = False
    return _native


def c64_to_planes(iq: np.ndarray):
    """Split complex64 [..., n] into contiguous float32 (i, q) planes.

    The host-side per-block hot path (every ingested block feeds the device
    as planes); uses the C++ helper when built, NumPy otherwise.
    """
    iq = np.ascontiguousarray(iq, dtype=np.complex64)
    lib = _load_native()
    if lib and hasattr(lib, "iq_c64_to_planes"):
        out_i = np.empty(iq.shape, dtype=np.float32)
        out_q = np.empty(iq.shape, dtype=np.float32)
        lib.iq_c64_to_planes(iq.ctypes.data, out_i.ctypes.data,
                             out_q.ctypes.data, iq.size)
        _count("native:iq_c64_to_planes")
        return out_i, out_q
    _count("numpy:c64_to_planes")
    return (np.ascontiguousarray(iq.real.astype(np.float32)),
            np.ascontiguousarray(iq.imag.astype(np.float32)))


def convert_to_c64(raw: np.ndarray, fmt: str) -> np.ndarray:
    """Convert interleaved/typed raw samples to complex64 in [-1, 1]."""
    if fmt in ("cf32", "cf64"):
        return np.ascontiguousarray(raw.astype(np.complex64))
    lib = _load_native()
    n = raw.size // 2
    raw = raw[: 2 * n]          # a truncated file may end mid-sample
    if lib:
        out = np.empty(n, dtype=np.complex64)
        src = np.ascontiguousarray(raw)
        fn = {"cs16": lib.iq_cs16_to_cf32, "cs8": lib.iq_cs8_to_cf32,
              "cu8": lib.iq_cu8_to_cf32}[fmt]
        scale = {"cs16": 1.0 / 32768.0, "cs8": 1.0 / 128.0, "cu8": 1.0 / 128.0}[fmt]
        fn(src.ctypes.data, out.ctypes.data, n, scale)
        _count(f"native:iq_{fmt}_to_cf32")
        return out
    _count("numpy:convert_to_c64")
    if fmt == "cs16":
        f = raw.astype(np.float32) / 32768.0
    elif fmt == "cs8":
        f = raw.astype(np.float32) / 128.0
    elif fmt == "cu8":
        f = (raw.astype(np.float32) - 127.5) / 128.0
    else:
        raise ValueError(f"unknown IQ format {fmt!r}")
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


def interleaved_to_int_planes(raw: np.ndarray, fmt: str):
    """Split interleaved cs16/cs8 samples into raw integer (i, q) planes.

    The device-dequant ingest path (PipelineConfig.input_dtype "i16"/"i8"):
    no host float conversion at all — the planes upload as integers (2x/4x
    less host->device traffic than float32) and the compiled step dequantizes
    on device. Returns (i_plane, q_plane, input_dtype)."""
    if fmt == "cs16":
        raw = np.ascontiguousarray(raw, dtype=np.int16)
        dt = "i16"
    elif fmt == "cs8":
        raw = np.ascontiguousarray(raw, dtype=np.int8)
        dt = "i8"
    else:
        raise ValueError(f"device-dequant ingest needs cs16/cs8, got {fmt!r}")
    _count("numpy:interleaved_to_int_planes")
    pair = raw[: 2 * (raw.size // 2)].reshape(-1, 2)   # tolerate a capture
    #                                                    cut mid-sample
    return (np.ascontiguousarray(pair[:, 0]),
            np.ascontiguousarray(pair[:, 1]), dt)


def infer_format(path: str, fmt: Optional[str] = None) -> str:
    """IQ sample format from an explicit override or the file extension
    (.cf32/.cs16/.cs8/.cu8/.wav; .raw aliases cf32). The ONE place this
    inference lives — sources and the CLI must agree on it."""
    if fmt is not None:
        return fmt
    ext = os.path.splitext(path)[1].lstrip(".").lower()
    return {"wav": "wav", "raw": "cf32"}.get(ext, ext)


def iq_from_file(path: str, fmt: Optional[str] = None,
                 count: Optional[int] = None) -> np.ndarray:
    """Read an IQ file into a complex64 array.

    ``fmt`` is inferred from the extension when not given (.cf32/.cs16/.cs8/
    .cu8/.wav). WAV files must be 2-channel (I, Q). ``count`` limits the
    read to the first N complex samples (probe reads skip the full-file
    load; wav is read whole and sliced).
    """
    fmt = infer_format(path, fmt)
    if fmt == "wav":
        iq = _read_wav_iq(path)
        return iq[:count] if count is not None else iq
    if fmt not in _FORMATS:
        raise ValueError(f"unknown IQ format {fmt!r} for {path}")
    dtype, nbytes = _FORMATS[fmt]
    items_per_complex = nbytes // np.dtype(dtype).itemsize
    n_items = -1 if count is None else count * items_per_complex
    raw = np.fromfile(path, dtype=dtype, count=n_items)
    if fmt in ("cf32", "cf64"):
        return raw.astype(np.complex64)
    return convert_to_c64(raw, fmt)


def _read_wav_iq(path: str) -> np.ndarray:
    with wave.open(path, "rb") as w:
        nch = w.getnchannels()
        if nch != 2:
            raise ValueError(f"IQ wav must have 2 channels, got {nch}")
        sw = w.getsampwidth()
        frames = w.readframes(w.getnframes())
    if sw == 2:
        data = np.frombuffer(frames, dtype=np.int16)
        return convert_to_c64(data, "cs16")
    if sw == 1:
        data = np.frombuffer(frames, dtype=np.uint8)
        return convert_to_c64(data, "cu8")
    raise ValueError(f"unsupported wav sample width {sw}")


def write_iq(path: str, iq: np.ndarray, fmt: str = "cf32") -> None:
    """Write complex64 IQ to a raw file (test fixtures / synth output)."""
    iq = np.asarray(iq, dtype=np.complex64)
    if fmt == "cf32":
        iq.tofile(path)
    elif fmt == "cs16":
        inter = np.empty(2 * iq.size, dtype=np.int16)
        inter[0::2] = np.clip(np.round(iq.real * 32767), -32768, 32767).astype(np.int16)
        inter[1::2] = np.clip(np.round(iq.imag * 32767), -32768, 32767).astype(np.int16)
        inter.tofile(path)
    elif fmt == "cs8":
        inter = np.empty(2 * iq.size, dtype=np.int8)
        inter[0::2] = np.clip(np.round(iq.real * 127), -128, 127).astype(np.int8)
        inter[1::2] = np.clip(np.round(iq.imag * 127), -128, 127).astype(np.int8)
        inter.tofile(path)
    else:
        raise ValueError(f"unknown IQ format {fmt!r}")


_FMT_CODES = {"cf32": 0, "cs16": 1, "cs8": 2, "cu8": 3}
_FMT_SCALES = {"cf32": 1.0, "cs16": 1.0 / 32768.0, "cs8": 1.0 / 128.0,
               "cu8": 1.0 / 128.0}

_iqstream = None


def _load_iqstream():
    """Load the native background-prefetch stream reader
    (csrc/iqstream.cpp), building it first."""
    global _iqstream
    if _iqstream is not None:
        return _iqstream
    if os.environ.get("SONDETPU_NO_NATIVE"):
        _iqstream = False
        return _iqstream
    lib = _build_and_load("iqstream.cpp", ("-pthread",))
    if not lib:
        _iqstream = False
        return _iqstream
    try:
        lib.iqs_open.restype = ctypes.c_void_p
        lib.iqs_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
                                 ctypes.c_float, ctypes.c_int]
        lib.iqs_read.restype = ctypes.c_int64
        lib.iqs_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.iqs_close.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "iqs_open_raw"):
            lib.iqs_open_raw.restype = ctypes.c_void_p
            lib.iqs_open_raw.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                         ctypes.c_int64, ctypes.c_int]
            lib.iqs_read_raw.restype = ctypes.c_int64
            lib.iqs_read_raw.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p]
        _iqstream = lib
    except AttributeError:
        _iqstream = False
    return _iqstream


class StreamingIQSource:
    """Stream an IQ file or FIFO as float32 I/Q plane blocks, O(block) memory.

    A C++ reader thread (csrc/iqstream.cpp) prefetches and converts the
    next block while the caller's block is on the device, so file IO and
    sample conversion overlap device compute — the batched analogue of the
    reference's per-block worker threads with a double-buffered stream.
    Falls back to synchronous NumPy chunk reads when the library is absent.

    Yields ``(plane_i[block_len], plane_q[block_len], valid)`` — the exact
    layout the compiled pipeline ingests (complex64 stays host-side).
    """

    def __init__(self, path: str, block_len: int, fmt: Optional[str] = None,
                 depth: int = 4, raw_planes: bool = False):
        fmt = infer_format(path, fmt)
        if fmt not in _FMT_CODES:
            raise ValueError(f"unsupported streaming IQ format {fmt!r} "
                             f"(have {sorted(_FMT_CODES)})")
        if raw_planes and fmt not in ("cs16", "cs8"):
            raise ValueError("raw_planes streaming needs cs16/cs8")
        self.path = path
        self.fmt = fmt
        self.block_len = int(block_len)
        self.depth = int(depth)
        # raw_planes: yield int16/int8 planes for the device-dequant ingest
        # (PipelineConfig.input_dtype) — no host float conversion
        self.raw_planes = bool(raw_planes)
        self.input_dtype = {"cs16": "i16", "cs8": "i8"}.get(fmt) \
            if raw_planes else "f32"

    def blocks(self) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
        lib = _load_iqstream()
        if self.raw_planes:
            if lib and hasattr(lib, "iqs_open_raw"):
                yield from self._blocks_native_raw(lib)
            else:
                yield from self._blocks_numpy_raw()
        elif lib:
            yield from self._blocks_native(lib)
        else:
            yield from self._blocks_numpy()

    def _blocks_native_raw(self, lib):
        h = lib.iqs_open_raw(self.path.encode(), _FMT_CODES[self.fmt],
                             self.block_len, self.depth)
        if not h:
            raise OSError(f"cannot open IQ stream {self.path!r}")
        dt = np.int16 if self.fmt == "cs16" else np.int8
        try:
            while True:
                pi = np.empty(self.block_len, dtype=dt)
                pq = np.empty(self.block_len, dtype=dt)
                n = lib.iqs_read_raw(h, pi.ctypes.data, pq.ctypes.data)
                if n == -2:
                    continue    # stalled-FIFO timeout: lets Ctrl-C fire
                if n < 0:
                    # native mode-mismatch guard (iqstream.cpp): a scaled-
                    # float handle was passed to the raw reader — a caller
                    # bug, not end-of-stream
                    raise RuntimeError(
                        "iqs_read_raw returned %d (handle/mode mismatch)" % n)
                if n == 0:
                    return
                _count("native:iqs_read_raw")
                yield pi, pq, int(n)
        finally:
            lib.iqs_close(h)

    def _blocks_numpy_raw(self):
        dt = np.int16 if self.fmt == "cs16" else np.int8
        item = np.dtype(dt).itemsize
        want = 2 * self.block_len * item
        with open(self.path, "rb") as f:
            while True:
                buf = self._read_full(f, want, item)  # FIFO-safe refill
                raw = np.frombuffer(buf, dtype=dt)
                n = raw.size // 2
                if n == 0:
                    return
                pair = raw[: 2 * n].reshape(-1, 2)
                pi = np.zeros(self.block_len, dtype=dt)
                pq = np.zeros(self.block_len, dtype=dt)
                pi[:n] = pair[:, 0]
                pq[:n] = pair[:, 1]
                _count("numpy:stream_raw")
                yield pi, pq, int(n)
                if n < self.block_len:
                    return

    def _blocks_native(self, lib):
        h = lib.iqs_open(self.path.encode(), _FMT_CODES[self.fmt],
                         self.block_len, _FMT_SCALES[self.fmt], self.depth)
        if not h:
            raise OSError(f"cannot open IQ stream {self.path!r}")
        try:
            while True:
                pi = np.empty(self.block_len, dtype=np.float32)
                pq = np.empty(self.block_len, dtype=np.float32)
                n = lib.iqs_read(h, pi.ctypes.data, pq.ctypes.data)
                if n == -2:
                    continue    # stalled-FIFO timeout: lets Ctrl-C fire
                if n < 0:
                    raise RuntimeError(
                        "iqs_read returned %d (handle/mode mismatch)" % n)
                if n == 0:
                    return
                _count("native:iqs_read")
                yield pi, pq, int(n)
        finally:
            lib.iqs_close(h)

    @staticmethod
    def _read_full(f, nbytes: int, item: int = 1) -> bytes:
        """Read exactly nbytes unless EOF: FIFOs/pipes return short reads
        mid-stream, which must NOT end the stream (np.fromfile also needs a
        seekable file, so the fallback reads raw bytes). The result is
        trimmed to a multiple of ``item`` bytes (a capture cut mid-element
        must not poison np.frombuffer)."""
        chunks = []
        got = 0
        while got < nbytes:
            b = f.read(nbytes - got)
            if not b:
                break
            chunks.append(b)
            got += len(b)
        buf = b"".join(chunks)
        return buf[: len(buf) - len(buf) % item]

    def _blocks_numpy(self):
        dtype, bpc = _FORMATS[self.fmt]
        per_complex = 2 if self.fmt != "cf32" else 1
        item = np.dtype(dtype).itemsize
        want = self.block_len * per_complex * item
        with open(self.path, "rb") as f:
            while True:
                buf = self._read_full(f, want, item)
                if not buf:
                    return
                raw = np.frombuffer(buf, dtype=dtype)
                n = raw.size // per_complex
                if n == 0:
                    return
                iq = (raw.astype(np.complex64) if self.fmt == "cf32"
                      else convert_to_c64(raw[: 2 * (raw.size // 2)], self.fmt))
                pi = np.zeros(self.block_len, dtype=np.float32)
                pq = np.zeros(self.block_len, dtype=np.float32)
                pi[:n] = iq.real[:n]
                pq[:n] = iq.imag[:n]
                _count("numpy:stream")
                yield pi, pq, int(n)
                if n < self.block_len:         # true EOF (short final block)
                    return


class IntIQFileSource:
    """Stream a cs16/cs8 IQ file as RAW INTEGER (i, q) plane blocks.

    The device-dequant ingest path: pair with
    ``PipelineConfig(input_dtype=src.input_dtype)`` and the planes cross the
    host->device wire as int16/int8 (2x/4x narrower than float32); the
    compiled step dequantizes on device. Same block framing contract as
    IQFileSource (static shapes, zero-padded final block).
    """

    def __init__(self, path: str, block_len: int, fmt: Optional[str] = None,
                 loop: bool = False):
        self.block_len = int(block_len)
        self.loop = loop
        fmt = infer_format(path, fmt)
        dtype, _ = _FORMATS[fmt]
        raw = np.fromfile(path, dtype=dtype)
        self._pi, self._pq, self.input_dtype = \
            interleaved_to_int_planes(raw, fmt)

    @property
    def total_samples(self) -> int:
        return self._pi.size

    def blocks(self) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
        """Yield ``(i_plane[block_len], q_plane[block_len], valid_len)``."""
        n = self._pi.size
        pos = 0
        while True:
            if pos >= n:
                if not self.loop:
                    return
                pos = 0
            end = min(pos + self.block_len, n)
            valid = end - pos
            if valid == self.block_len:
                yield self._pi[pos:end], self._pq[pos:end], valid
            else:
                bi = np.zeros(self.block_len, dtype=self._pi.dtype)
                bq = np.zeros(self.block_len, dtype=self._pq.dtype)
                bi[:valid] = self._pi[pos:end]
                bq[:valid] = self._pq[pos:end]
                yield bi, bq, valid
            pos = end


class IQFileSource:
    """Stream an IQ file as fixed-size complex64 blocks.

    The block framer replacing the reference's ``dsp::stream`` double-buffer
    handoff (C1 in SURVEY.md §2.2): every block has identical static shape so
    the jitted pipeline compiles once; the final partial block is zero-padded
    and the valid length reported alongside.
    """

    def __init__(self, path: str, block_len: int, fmt: Optional[str] = None,
                 loop: bool = False):
        self.block_len = int(block_len)
        self.loop = loop
        self._iq = iq_from_file(path, fmt)

    @property
    def total_samples(self) -> int:
        return self._iq.size

    def blocks(self) -> Iterator[tuple[np.ndarray, int]]:
        """Yield ``(block[block_len] complex64, valid_len)`` tuples."""
        n = self._iq.size
        pos = 0
        while True:
            if pos >= n:
                if not self.loop:
                    return
                pos = 0
            end = min(pos + self.block_len, n)
            valid = end - pos
            if valid == self.block_len:
                yield self._iq[pos:end], valid
            else:
                block = np.zeros(self.block_len, dtype=np.complex64)
                block[:valid] = self._iq[pos:end]
                yield block, valid
            pos = end
