"""The port imports nothing of the JAX package.

sondetpu_torch and chip_smoke.py may import the standard library, numpy,
torch and the port itself, and no module of ``sondetpu``, not even one
that does not import jax: the port carries its own copies of what it needs
(held to their originals in test_torch_host.py).
"""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "sondetpu_torch", "**", "*.py"),
                       recursive=True)) + ["chip_smoke.py"]


def _is_jax_package(name) -> bool:
    return name is not None and (name == "sondetpu"
                                 or name.startswith("sondetpu."))


def jax_package_imports(path: str):
    """(line, module) of every import of sondetpu or sondetpu.* in the
    file, at any depth (module level or inside a function)."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names
                      if _is_jax_package(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _is_jax_package(node.module):
                found.append((node.lineno, node.module))
    return found


def test_the_walk_sees_the_port():
    assert "chip_smoke.py" in SOURCES
    assert os.path.join("sondetpu_torch", "runtime", "session.py") in SOURCES
    assert jax_package_imports(os.path.join("tests", "test_torch_host.py"))


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_nothing_of_sondetpu(path):
    assert jax_package_imports(path) == []


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_no_jax_or_ml_dtypes(path):
    """Neither jax nor ml_dtypes: the card's machine has neither."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    tops = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    tops |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module and n.level == 0}
    assert not tops & {"jax", "jaxlib", "ml_dtypes"}, tops


_PROBE = r"""
import sys
import sondetpu_torch.runtime.session
import sondetpu_torch.runtime.fleet
import sondetpu_torch.runtime.checkpoint
import sondetpu_torch.cli.main
import sondetpu_torch.bench.fer
import sondetpu_torch.dsp.resample
import sondetpu_torch.io
from sondetpu_torch.sondes import c50, dfm, imet4, m10, rs41
from sondetpu_torch.sondes.base import get_sonde
for name in ("rs41", "rs41x", "m10", "dfm", "imet4", "c50"):
    get_sonde(name)
from sondetpu_torch.fec.crc import crc16_ccitt_batch
from sondetpu_torch.fec.rs import ReedSolomon
import numpy as np
ReedSolomon(24).decode(np.zeros((2, 255), np.uint8))
crc16_ccitt_batch(np.zeros((2, 8), np.uint8))
sondetpu_torch.cli.main.main(["types"])
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("sondetpu", "jax", "ml_dtypes")))
"""


def test_session_fleet_and_families_load_no_sondetpu_module():
    res = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, cwd=REPO, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


_COLLECT_WITHOUT_JAX = r"""
import importlib.abc, sys
class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "sondetpu"):
            raise ImportError("refused in this process: " + name)
        return None
sys.meta_path.insert(0, _Refuse())
import pytest
sys.exit(pytest.main(["--noconftest", "-p", "no:cacheprovider", "-q",
                      "--collect-only", "tests/test_torch_cuda.py"]))
"""


def test_card_tests_need_neither_jax_nor_sondetpu():
    """tests/test_torch_cuda.py is meant for the card's machine, which has
    no jax: it imports neither jax nor the JAX package, and pytest collects
    it in a process that refuses both."""
    path = os.path.join("tests", "test_torch_cuda.py")
    assert jax_package_imports(path) == []
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    tops = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    tops |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert not tops & {"jax", "jaxlib", "ml_dtypes"}, tops
    res = subprocess.run([sys.executable, "-c", _COLLECT_WITHOUT_JAX],
                         capture_output=True, text=True, cwd=REPO, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "test_cuda_plain_path_matches_cpu" in res.stdout, res.stdout
