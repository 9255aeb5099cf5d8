"""ctypes bindings for the port's native host FEC (counterpart:
``sondetpu/fec/native.py``).

``csrc/sondefec.cpp`` (a copy of the JAX package's C++ FEC) is compiled
with the host's C++ compiler at first use into ``build/sondetpu_torch/``
beside the package, named by a hash of the source and flags, and loaded
with ctypes. RS(255,231) per suspect frame, BCH(63,51) for ims100 and the
per-block CRC16 run there; the NumPy implementations of this package stay
the oracle and run when no compiler or library is at hand. Nothing here
runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import subprocess
from typing import Optional, Tuple

import numpy as np

from sondetpu_torch import cxx

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def build() -> str:
    """Compile the C++ FEC unless the library already exists; returns its
    path."""
    return cxx.build("sondefec.cpp")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    try:
        lib = ctypes.CDLL(build())
    except (OSError, subprocess.SubprocessError):
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    lib.fec_rs_decode_batch.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, i32p, u8p]
    lib.fec_bch63_decode_batch.argtypes = [u8p, ctypes.c_int64, i32p, u8p]
    lib.fec_crc16_batch.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint16, u16p]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native library is built and loaded."""
    return _load() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def rs_decode(recv: np.ndarray, nroots: int, fcr: int, prim_poly: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Native RS decode: recv [batch, n] uint8 -> (corrected, nerr, ok).

    Semantics identical to fec.rs.ReedSolomon.decode (the NumPy oracle)."""
    lib = _load()
    assert lib is not None
    recv = np.ascontiguousarray(recv, dtype=np.uint8)
    batch, n = recv.shape
    out = recv.copy()
    nerr = np.zeros(batch, dtype=np.int32)
    ok = np.zeros(batch, dtype=np.uint8)
    lib.fec_rs_decode_batch(
        _u8p(out), batch, n, nroots, fcr, prim_poly,
        nerr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _u8p(ok))
    return out, nerr.astype(np.int64), ok.astype(bool)


def bch63_decode(bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Native BCH(63,51) t=2 decode: bits [batch, 63] -> (corrected, nerr, ok)."""
    lib = _load()
    assert lib is not None
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    batch = bits.shape[0]
    out = bits.copy()
    nerr = np.zeros(batch, dtype=np.int32)
    ok = np.zeros(batch, dtype=np.uint8)
    lib.fec_bch63_decode_batch(
        _u8p(out), batch,
        nerr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _u8p(ok))
    return out, nerr.astype(np.int64), ok.astype(bool)


def crc16_batch(data: np.ndarray, init: int = 0xFFFF) -> np.ndarray:
    """Native CRC16-CCITT over rows of data [batch, n] -> [batch] uint16."""
    lib = _load()
    assert lib is not None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    batch, n = data.shape
    out = np.zeros(batch, dtype=np.uint16)
    lib.fec_crc16_batch(
        _u8p(data), batch, n, init,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    return out
