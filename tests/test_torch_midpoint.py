"""The midpoint DC on the CPU: ``kernels/midpoint.py:midpoint_dc`` (the
hand-written launch that ``runtime/pipeline.py``'s midpoint-DC steps make
for a CUDA tensor) checks its arguments as the card's entry would, runs
``midpoint_dc_plain`` for CPU tensors and launches nothing there; the
pipeline's ``midpoint_dc`` is that wrapper, called once a step of a
midpoint-DC family on both routes.

The kernel itself runs only on a card: ``tests/test_torch_cuda.py`` holds
it to its twin bit for bit. ``tests/test_torch_pipeline.py`` holds the
twin to ``jnp.quantile``.
"""

import numpy as np
import pytest
import torch

from sondetpu_torch.kernels import cuda
from sondetpu_torch.kernels import midpoint as kmid
from sondetpu_torch.runtime import pipeline as tpipe
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

T = torch.from_numpy


def _refused(case):
    x = torch.zeros((8, 64))
    return {"columns-strided": (x.t(), ValueError, "contiguous"),
            "float16": (x.half(), TypeError, "dtype"),
            "float64": (x.double(), TypeError, "dtype"),
            "int32": (x.int(), TypeError, "dtype"),
            "one-dim": (x[0], ValueError, r"\[C, n\]"),
            "three-dim": (x[None], ValueError, r"\[C, n\]"),
            "no-columns": (x[:, :0], ValueError, "no columns"),
            "not-a-tensor": (x.numpy(), ValueError, r"\[C, n\]")}[case]


@pytest.mark.parametrize("case", ["columns-strided", "float16", "float64",
                                  "int32", "one-dim", "three-dim",
                                  "no-columns", "not-a-tensor"])
def test_midpoint_dc_refuses_on_the_cpu(case):
    """The CPU refuses what the card's entry refuses, with the same errors,
    and launches nothing."""
    x, err, match = _refused(case)
    before = dict(cuda.launches)
    with pytest.raises(err, match=match):
        kmid.midpoint_dc(x)
    assert cuda.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_midpoint_dc_takes_rows_at_any_stride(dtype):
    """A view of a wider buffer's rows (the CPU K7 twin's metric is one)
    gives what its rows copied side by side give, and one row of one
    column what that element is."""
    rng = np.random.default_rng(5)
    wide = T(rng.normal(size=(9, 3010)).astype(np.float32)).to(dtype)
    got = kmid.midpoint_dc(wide[:, 3:])
    assert torch.equal(got, kmid.midpoint_dc(wide[:, 3:].contiguous()))
    assert torch.equal(kmid.midpoint_dc(wide[:1, 5:6]), wide[0, 5:6])


@pytest.mark.parametrize("n,want", [
    (1, ((0, 0, 0.0), (0, 0, 0.0))),
    (2, ((0, 1, np.float32(0.1)), (0, 1, np.float32(0.9)))),
    (10001, ((1000, 1000, 0.0), (9000, 9000, 0.0))),
    (192000, ((19199, 19200, np.float32(np.float32(0.1) * np.float32(191999))
               - 19199), (172799, 172800, np.float32(np.float32(0.9)
                                                     * np.float32(191999))
                          - 172799)))])
def test_quantile_ranks(n, want):
    """The ranks and weights the kernel takes by value: floor and ceil of
    q * (n - 1) in float32 and the float32 weight of the ceil (at n =
    10001, 0.9 * 10000 rounds to 9000 in float32)."""
    got = kmid.quantile_ranks(n)
    assert [(lo, hi) for lo, hi, _ in got] == [w[:2] for w in want]
    for (_, _, w), (_, _, ww) in zip(got, want):
        assert isinstance(w, np.float32) and w == np.float32(ww)


def test_pipeline_midpoint_dc_is_the_wrapper():
    """The pipeline's name is the wrapper itself: its two call sites go
    through ``kernels/midpoint.py``."""
    assert tpipe.midpoint_dc is kmid.midpoint_dc


@pytest.mark.parametrize("use_pallas", [True, False])
def test_ims100_step_calls_midpoint_dc_once(monkeypatch, use_pallas):
    """An ims100 step calls ``midpoint_dc`` once, on the kernel route (K7's
    metric; the twins on the CPU) and on the plain-op route (the
    discriminator audio), and launches no kernel on the CPU."""
    from sondetpu_torch.sondes.ims100 import IMS100Modulator, IMS100Truth

    cfg = tpipe.PipelineConfig(sonde="ims100", channels=8, block_len=48000,
                               use_pallas=use_pallas, input_dtype="i16")
    pipe = tpipe.Pipeline(cfg, "cpu")
    assert pipe._midpoint and pipe._plain != use_pallas
    iq = IMS100Modulator().modulate(
        [IMS100Truth(serial="2136051", frame_no=2 + j) for j in range(6)])
    iq = np.tile(iq[:48000], (8, 1))
    planes = tuple(np.clip(x * 32767, -32768, 32767).astype(np.int16)
                   for x in (iq.real, iq.imag))
    calls = []

    def counted(x):
        calls.append(tuple(x.shape))
        return kmid.midpoint_dc(x)

    monkeypatch.setattr(tpipe, "midpoint_dc", counted)
    cuda.reset_launches()
    pipe.step(pipe.init_state(), planes)
    assert calls == [(8, 48000)]
    assert not any(cuda.launches.values())
