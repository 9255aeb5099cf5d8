"""Running the port's command line beside the JAX package's on the CPU.

Both ``main(argv)`` run in this process, on the same input file, with the
same ``--ref-epoch``; the port with ``--device cpu`` (its kernels' plain
twins). :func:`decode_both` returns each one's JSONL lines and the bytes of
its GPX and PTU files, for a test to hold equal.
"""

import os

from sondetpu.cli import main as jcli
from sondetpu_torch.cli import main as tcli

REF_EPOCH = "1700000000"


def _read(path):
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return f.read()


def decode(which: str, argv, out_dir: str, sinks=("jsonl", "gpx", "ptu")):
    """``decode`` of one package (``"jax"`` or ``"port"``) with ``argv``
    plus its sinks under ``out_dir``; returns {sink: bytes} (None for a
    sink that was not written)."""
    os.makedirs(out_dir, exist_ok=True)
    args = ["decode", *argv, "--ref-epoch", REF_EPOCH]
    paths = {s: os.path.join(out_dir, f"out.{s}") for s in sinks}
    for s, p in paths.items():
        args += [f"--{s}", p]
    if which == "port":
        rc = tcli.main(args + ["--device", "cpu"])
    else:
        rc = jcli.main(args)
    assert rc == 0, (which, argv)
    return {s: _read(p) for s, p in paths.items()}


def decode_both(argv, tmp_path, sinks=("jsonl", "gpx", "ptu")):
    jax = decode("jax", argv, str(tmp_path / "jax"), sinks)
    port = decode("port", argv, str(tmp_path / "port"), sinks)
    return jax, port


def assert_same(jax, port, min_lines=1):
    """Equal JSONL lines (the telemetry from the frame bytes, exactly) and
    byte-equal GPX and PTU files; at least ``min_lines`` JSONL lines."""
    lines = jax["jsonl"].decode().splitlines()
    assert len(lines) >= min_lines, lines
    assert port["jsonl"].decode().splitlines() == lines
    for sink in ("gpx", "ptu"):
        assert port.get(sink) == jax.get(sink), sink
    return lines
