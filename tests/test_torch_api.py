"""The port's package surface: each package's ``__all__`` names what its
counterpart in the JAX package exports, and every name resolves on the
port (``from sondetpu_torch.dsp import fm_demod`` works as
``from sondetpu.dsp import fm_demod`` does)."""

import importlib

import pytest

import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

PACKAGES = ["", ".dsp", ".sync", ".fec", ".runtime", ".io", ".parallel",
            ".bench", ".sondes"]


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "top")
def test_all_equals_the_original(sub):
    orig = importlib.import_module("sondetpu" + sub)
    port = importlib.import_module("sondetpu_torch" + sub)
    assert set(port.__all__) == set(orig.__all__)
    for name in port.__all__:
        o, p = getattr(orig, name), getattr(port, name)
        if isinstance(o, type):
            assert isinstance(p, type) and p.__name__ == o.__name__, name
        elif callable(o):
            assert callable(p), name
        else:                   # constants: equal, or instances of one class
            assert type(p).__name__ == type(o).__name__, name
            if isinstance(o, (str, tuple)):
                assert p == o, name
