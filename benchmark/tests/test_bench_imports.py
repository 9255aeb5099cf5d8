"""Nothing the benchmark runs imports JAX or the JAX package, and the
yardstick (reference, frozen copies, traffic, metrics) imports nothing of
the program either. Top-level names are compared whole: the port's name
begins with the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)
NEVER = {"jax", "jaxlib", "flax", "sondetpu"}
# parts of the benchmark that may not reach the program under test
YARDSTICK = ("reference", "frozen", "gen", "metrics")


def _modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_module_imports(path):
    tops = set(_imports(path))
    assert not tops & NEVER, (path, tops & NEVER)
    rel = os.path.relpath(path, HERE).split(os.sep)[0]
    if rel in YARDSTICK:
        assert "sondetpu_torch" not in tops, path


def test_harness_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.harness.main,"
            " benchmark.control, benchmark.reference.cells,"
            " benchmark.gen.channel_ring, benchmark.gen.wideband_ring;"
            " bad = {m.split('.')[0] for m in sys.modules} & %r;"
            " print(sorted(bad)); sys.exit(1 if bad else 0)" % (REPO, NEVER))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
