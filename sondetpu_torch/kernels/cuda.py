"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with nvcc for Hopper (``sm_90a``), one process per
source, all at once, and linked into one shared library with a plain C
interface, at the first launch, and bound with ctypes: no PyTorch headers,
so the build takes seconds. The library lands in ``build/sondetpu_torch/``
beside the package, named by a hash of the sources, so an edited source is
rebuilt and a stale library is never loaded. Nothing here runs when the
module is imported.

``launches`` counts, per kernel, the launches that went through
:func:`launch`, and ``body_launches`` the launches of each compiled body of
a kernel that has several (``"fused_frontend:decim2_t41"`` and so on); a
run resets both with :func:`reset_launches` and reads them afterwards to
show which kernels and bodies it went through.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import tempfile
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                         "sondetpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
_SIGNATURES = {
    "sondetpu_frontend_tiles": [_I, _I],
    "sondetpu_fused_frontend": [_P, _P, _P, _P, _P, _P, _I, _F, _I, _I, _I,
                                _I, _I, _I, _I, _P, _P, _P],
    "sondetpu_corr": [_P, _P, _P, _I, _F, _I, _I, _I, _P, _P],
    "sondetpu_rs_clean": [_P, _P, _I, _I, _I, _P, _P],
    "sondetpu_pfb_fir_stream": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                                _P],
    "sondetpu_pfb_fir_timemajor": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "sondetpu_pfb_dft": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "sondetpu_dualtone_tiles": [_I],
    "sondetpu_dualtone_frontend": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _I,
                                   _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "sondetpu_afsk_frontend": [_P, _P, _P, _P, _P, _P, _I, _F, _I, _I, _I,
                               _P, _P],
    "sondetpu_demod_audio_parts": [_I],
    "sondetpu_demod_audio": [_P, _P, _P, _F, _I, _I, _P, _P, _P],
    "sondetpu_demod_fir": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "sondetpu_lane_fir": [_P, _P, _I, _I, _I, _P, _P],
    "sondetpu_plain_corr": [_P, _I, _P, _I, _I, _I, _LL, _P, _P],
    "sondetpu_plain_fir": [_P, _I, _P, _I, _I, _I, _I, _LL, _P, _P],
}

launches = {"fused_frontend": 0, "corr": 0, "rs_clean": 0,
            "pfb_fir_stream": 0, "pfb_fir_timemajor": 0, "pfb_dft": 0,
            "fused_dualtone_frontend": 0, "fused_afsk_frontend": 0,
            "fused_demod_fir": 0, "lane_fir": 0, "plain_corr": 0,
            "plain_fir": 0}
body_launches = {}       # "kernel:body" -> launches, for multi-body kernels
build_seconds = None     # wall time of this process's nvcc build, if any
_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    body_launches.clear()


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); the "
                           "sondetpu_torch kernels need nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libsondetpu_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds):
    """Run the commands in parallel; raise with the output of the first one
    that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = "nvcc failed (%d):\n%s\n%s" % (proc.returncode,
                                                     " ".join(cmd), out)
    if failed is not None:
        raise RuntimeError(failed)


def build() -> str:
    """Compile csrc/*.cu into the shared library unless it already exists;
    returns its path. Each source compiles in its own nvcc process, all at
    once, and one more links them. The library is written under a temporary
    name and renamed, so a concurrent build never leaves a partial file
    behind."""
    global build_seconds
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
            units = [p for p in _sources() if p.endswith(".cu")]
            objs = [os.path.join(objdir, os.path.basename(p) + ".o")
                    for p in units]
            _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, p]
                      for p, o in zip(units, objs)])
            _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_seconds = time.perf_counter() - t0
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(kernel: str, entry: str, *args, body: str | None = None) -> None:
    """Call C entry point ``entry`` with ``args`` (pointers as ints, the
    stream last), raise if it reports a CUDA error, and count one launch
    of ``kernel`` (and of its ``body``, where the entry point picks one of
    several)."""
    err = getattr(library(), entry)(*args)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")
    launches[kernel] += 1
    if body is not None:
        key = f"{kernel}:{body}"
        body_launches[key] = body_launches.get(key, 0) + 1


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 device: torch.device, shape=None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    (and of ``shape``, where given: None entries match any size)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if shape is not None and (t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape))):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
