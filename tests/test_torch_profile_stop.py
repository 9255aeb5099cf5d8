"""Pipeline.step with profile_stop against the JAX package on the CPU: the
original's checksum scalar of each stage on four routes. The signals are
tests/test_torch_gates.py's.

How far the float sums may differ, and the readings behind it (one
4800-sample block, 8 channels, from the initial state). The two packages'
stage outputs differ per element by ~1e-6 of their unit range (the filter
sums are taken in other orders; the timing estimate differs by ~1e-4
samples), so a sum differs by about that times the root of its element
count, and a sum of unit size also by its own rounding. The limit is
``1e-4 * |w| + 1.5e-6 * sqrt(N)``, plus one bfloat16 step ``2**-7 * |w|``
when the sum is bfloat16. Measured: every float32 sum of magnitude above
1 within 7.4e-6 of itself (the K7 timing sum, 48.0212 against 48.0209;
K1+K8's audio sum); the K7 metric's sum, which its block DC removal
leaves near zero, -6.39e-4 against JAX's -5.11e-4, a gap of 1.28e-4 under
its limit of 2.94e-4; the plain route's bfloat16 chanfilt sum equal. Each
case also asserts that its limit is below ``|w|``, so a stage that
returned zero would fail. The integer sums are held exactly; the syndrome
sums are zero here (no frame completes in a 0.1 s block from the initial
state), and the session tests hold the RS verdicts and validity exactly.
rs41 on K1 at "corr" is tests/test_torch_gates.py's
``test_formerly_refused_configs_match_jax[profile-stop]``.
"""

import math

import numpy as np
import pytest

from sondetpu.runtime import pipeline as jpipe
from sondetpu_torch.runtime import pipeline as tpipe
from test_torch_gates import CPU, _config, _f32_planes, _planes
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

_STAGES = ("chanfilt", "demod", "timing", "sample", "corr", "peaks",
           "gather", "syndrome")
_ROUTES = {"k1": dict(sonde="rs41"),
           "k7": dict(sonde="m10", compute_dtype="bf16", input_dtype="f32"),
           "k1-k8": dict(sonde="imet4"),
           "plain": dict(sonde="rs41", use_pallas=False,
                         compute_dtype="bf16")}
_CASES = [(r, s) for r in _ROUTES for s in _STAGES if (r, s) != ("k1", "corr")]
_PROFILE_BLOCK = 4800


@pytest.fixture(scope="module")
def profile_planes():
    return {r: _planes(kw["sonde"], 8, _PROFILE_BLOCK)
            for r, kw in _ROUTES.items()}


def _elements(cfg, route, stage):
    """The number of elements the original sums at ``stage`` (at most:
    the sample-rate stages count the block before any decimation)."""
    c, n = cfg.channels, cfg.block_len
    return {"chanfilt": (2 if route == "plain" else 1) * c * n,
            "demod": c * n, "timing": 2 * c,
            "sample": c * cfg.chips_per_block,
            "corr": c * cfg.buf_len}[stage]


@pytest.mark.parametrize("route,stage", _CASES,
                         ids=[f"{r}-{s}" for r, s in _CASES])
def test_profile_stop_matches_jax(profile_planes, route, stage):
    """Pipeline.step with profile_stop returns the original's scalar for
    each stage, on the K1, K7, K1+K8 and plain-op routes, one 4800-sample
    block from the initial state, in the original's dtype (int32 for peaks,
    gather and syndrome; the compute dtype for the plain route's chanfilt
    sum, float32 otherwise): the integer sums exactly, the float sums
    within the module docstring's limit, which is below |w|."""
    kw = _config(profile_stop=stage, block_len=_PROFILE_BLOCK,
                 **_ROUTES[route])
    qi, qq = profile_planes[route]
    if kw["input_dtype"] == "f32":
        qi, qq = _f32_planes(qi, qq)
    jp = jpipe.Pipeline(jpipe.PipelineConfig(**kw))
    tp = tpipe.Pipeline(tpipe.PipelineConfig(**kw), CPU)
    assert tp._route == {"k1": "fused", "k7": "dualtone", "k1-k8": "afsk",
                         "plain": None}[route]
    want = np.asarray(jp.step(jp.init_state(), (qi, qq)))
    got = tp.step(tp.init_state(), (qi, qq))
    assert got.shape == ()
    assert str(got.dtype).split(".")[-1] == {
        "float32": "float32", "int32": "int32",
        "bfloat16": "bfloat16"}[want.dtype.name]
    if want.dtype.name == "int32":
        assert int(got) == int(want)
        return
    w = float(want)
    tol = (1e-4 * abs(w)
           + 1.5e-6 * math.sqrt(_elements(tp.config, route, stage))
           + (2.0 ** -7 * abs(w) if want.dtype.name == "bfloat16" else 0.0))
    assert tol < abs(w), (w, tol)
    assert abs(float(got) - w) <= tol, (float(got), w, tol)
