"""Build the port's host C++ helpers (``csrc/*.cpp``) at first use.

Each source is compiled with the host's C++ compiler into a shared library
under ``build/sondetpu_torch/`` beside the package, named by a hash of the
source and the flags, so an edited source is rebuilt and a stale library is
never loaded. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

from sondetpu_torch.kernels.cuda import BUILD_DIR, CSRC

# portable x86-64-v2 (SSE4.2), as the JAX package's Makefile builds them
CXX_FLAGS = ["-O3", "-march=x86-64-v2", "-fPIC", "-shared", "-std=c++17"]


def library_path(source: str, extra_flags=()) -> str:
    """Where ``csrc/<source>`` builds with ``extra_flags``."""
    h = hashlib.sha256()
    with open(os.path.join(CSRC, source), "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS + list(extra_flags)).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build(source: str, extra_flags=()) -> str:
    """Compile ``csrc/<source>`` unless its library already exists; returns
    its path. Written under a temporary name and renamed, so a concurrent
    build never leaves a partial file behind."""
    path = library_path(source, extra_flags)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, *extra_flags, "-o", tmp,
                        os.path.join(CSRC, source)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path
