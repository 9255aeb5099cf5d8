"""The plain-op front end's filter on the CPU: ``kernels/lane_fir.py:
plain_fir`` (the hand-written launch that ``dsp/fir.py:apply_windows``
makes for a CUDA tensor) checks its arguments as the card's entry would,
runs ``window_sum`` for CPU tensors and picks its body from the tap count
and the stride alone; ``apply_windows`` on a CPU tensor still makes its
eager passes and counts them in ``tap_passes``.

The kernel itself runs only on a card: ``tests/test_torch_cuda.py`` holds
it to ``window_sum`` bit for bit in every body.
"""

import numpy as np
import pytest
import torch

from sondetpu_torch.dsp import fir
from sondetpu_torch.dsp.fir import apply_windows, design_lowpass, window_sum
from sondetpu_torch.kernels import cuda
from sondetpu_torch.kernels.lane_fir import plain_fir, plain_fir_body
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

T = torch.from_numpy


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("ntaps,stride,body", [
    (41, 2, "t41_d2"), (41, 1, "t41_d1"), (41, 3, "runtime_t"),
    (40, 2, "runtime_t"), (20, 1, "runtime_t"), (43, 1, "runtime_t"),
    (300, 2, "runtime_t"), (1, 1, "runtime_t")])
def test_plain_fir_body(ntaps, stride, body):
    """The body follows the tap count and the stride alone: RS41's 41 taps
    at strides 2 and 1 compiled in, every other pair at run time."""
    assert plain_fir_body(ntaps, stride) == body


@pytest.mark.parametrize("case", ["no-taps", "two-dim-taps", "short-rows",
                                  "float64", "float16", "int32", "one-dim",
                                  "zero-stride"])
def test_plain_fir_refuses_bad_arguments(case):
    """The wrapper checks its arguments before it picks ``window_sum`` or
    the kernel, so the CPU refuses what the card would: one or more taps,
    rows with room for a window, float32 or bfloat16 rows of [C, n], a
    stride of 1 or more."""
    x, h, stride = torch.zeros((2, 300)), np.ones(41, np.float32), 1
    exc, match = ValueError, "taps"
    if case == "no-taps":
        h = np.ones(0, np.float32)
    elif case == "two-dim-taps":
        h = np.ones((2, 41), np.float32)
    elif case == "short-rows":
        x, match = torch.zeros((2, 39)), "shorter"
    elif case == "one-dim":
        x, match = torch.zeros(300), r"\[C, n\]"
    elif case == "zero-stride":
        stride, match = 0, "stride"
    else:
        x = x.to(getattr(torch, case))
        exc, match = TypeError, "dtype"
    with pytest.raises(exc, match=match):
        plain_fir(x, h, stride)


def test_plain_fir_refuses_unsupported_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        plain_fir(torch.empty((4, 200), device="meta"),
                  np.ones(41, np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ntaps,stride,ln", [
    (41, 2, 2000), (41, 1, 1001), (20, 1, 777), (40, 2, 640), (7, 3, 500),
    (300, 2, 1500), (41, 1, 41), (41, 1, 40)],
    ids=["t41-d2", "t41-d1", "t20", "t40-d2", "t7-d3", "t300-chained",
         "one-output", "no-output"])
def test_plain_fir_on_the_cpu_is_window_sum(dtype, ntaps, stride, ln):
    """CPU tensors run ``window_sum`` bit for bit (as int32 patterns):
    launch nothing, count no tap pass, and give float32 [C, (ln - T) //
    stride + 1], down to one output and none; a tap count above one
    launch's 256 is taken too."""
    rng = np.random.default_rng(ntaps * 10 + stride)
    x = T(rng.normal(size=(3, ln)).astype(np.float32)).to(dtype)
    x[:, ::7] = -0.0
    h = rng.normal(size=ntaps).astype(np.float32)
    fir.reset_tap_passes()
    before = cuda.launches["plain_fir"]
    got = plain_fir(x, h, stride)
    assert cuda.launches["plain_fir"] == before
    assert fir.tap_passes == {"apply_windows": 0}
    assert got.dtype == torch.float32
    assert got.shape == (3, (ln - ntaps) // stride + 1)
    assert torch.equal(_bits(got), _bits(window_sum(x, h, stride)))


def test_plain_fir_takes_no_rows_and_row_views():
    """No rows give an empty result; a row view with a stride of its own
    filters as its contiguous copy does."""
    h = design_lowpass(2400.0, 48000.0, 41)
    assert plain_fir(torch.zeros((0, 500)), h, 2).shape == (0, 230)
    buf = T(np.random.default_rng(1).normal(size=(4, 1300)).astype(
        np.float32))
    view = buf[:, 7:1207]
    assert torch.equal(_bits(plain_fir(view, h, 2)),
                       _bits(plain_fir(view.contiguous(), h, 2)))


@pytest.mark.parametrize("taps_kind", ["numpy", "tensor"])
def test_apply_windows_on_the_cpu_counts_tap_passes(taps_kind):
    """A CPU tensor still takes the eager passes: ``window_sum``'s result,
    one tap pass a tap, and no kernel launch; the taps may be NumPy or a
    tensor."""
    rng = np.random.default_rng(4)
    x = T(rng.normal(size=(5, 1041)).astype(np.float32))
    h = design_lowpass(5000.0, 48000.0, 41)
    taps = h if taps_kind == "numpy" else T(h)
    fir.reset_tap_passes()
    before = cuda.launches["plain_fir"]
    got = apply_windows(x, taps, stride=2)
    assert fir.tap_passes == {"apply_windows": 41}
    assert cuda.launches["plain_fir"] == before
    assert torch.equal(_bits(got), _bits(window_sum(x, h, 2)))
    fir.reset_tap_passes()
