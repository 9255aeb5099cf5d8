"""Tests that need an NVIDIA GPU: the port's CUDA kernels against their
plain twins, and the plain-op path on the card against the CPU.

This file imports neither jax nor the JAX package (sondetpu), so it runs
on a machine that has only torch and the CUDA toolkit; tests/conftest.py
sets JAX up, so leave it out there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device every test skips (the CUDA kernels have no CPU mode;
chip_smoke.py drives the same kernels and paths on the card).
"""

import numpy as np
import pytest
import torch

from sondetpu_torch.dsp.fir import design_lowpass
from sondetpu_torch.kernels import cuda
from sondetpu_torch.kernels.frontend import (fused_demod_fir,
                                             fused_demod_fir_plain)
from sondetpu_torch.kernels.lane_fir import lane_fir, lane_fir_plain
from sondetpu_torch.runtime import pipeline as tpipe
from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth

T = torch.from_numpy
CPU = torch.device("cpu")
FS = 48000.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs these on the card")
    return torch.device("cuda", 0)


def _bits(t):
    return t.view(torch.int32)


# K9 (rows, block, taps): the compiled body on a block of 4-sample
# multiples, on a block no tile divides, on one row and on a block of
# T - 1 samples; the run-time body at 33 taps
_DEMOD_CASES = ((16, 9600, 41), (3, 2 * 5376 + 7, 41), (1, 5000, 41),
                (8, 40, 41), (5, 7001, 33))


def test_cuda_demod_fir_and_lane_fir_match_twins(cuda_device):
    """K9 in both bodies: with the DC within 2e-5 of its twin (the block
    mean is summed in another order), without it bit-equal as int32
    patterns (a tenth of the carried tail is -0), two runs bit-equal, and
    each call two launches (the discriminator, then the FIR's body). K10
    equals its twin in both bodies."""
    rng = np.random.default_rng(6)
    for c, n, ntaps in _DEMOD_CASES:
        i, q = (T(rng.normal(size=(c, n)).astype(np.float32)).to(cuda_device)
                for _ in range(2))
        prev = T(rng.normal(size=(c, 2)).astype(np.float32)).to(cuda_device)
        atail = rng.normal(size=(c, ntaps - 1)).astype(np.float32)
        atail[:, ::10] = -0.0
        atail = T(atail).to(cuda_device)
        taps = design_lowpass(2640.0, FS, ntaps)
        body = "fused_demod_fir:" + ("t41" if ntaps == 41 else "runtime_t")
        for dc in (True, False):
            cuda.reset_launches()
            got = fused_demod_fir(i, q, prev, atail, taps, 3.18, dc)
            again = fused_demod_fir(i, q, prev, atail, taps, 3.18, dc)
            want = fused_demod_fir_plain(i, q, prev, atail, taps, 3.18, dc)
            assert cuda.body_launches == {"fused_demod_fir:audio": 2,
                                          body: 2}
            for g, a, w in zip(got, again, want):
                assert torch.equal(_bits(g), _bits(a))
                if dc:
                    torch.testing.assert_close(g, w, rtol=0, atol=2e-5)
                else:
                    assert torch.equal(_bits(g), _bits(w))
    x = T(rng.normal(size=(16, 9640)).astype(np.float32)).to(cuda_device)
    h = design_lowpass(0.1, 1.0, 41)
    assert torch.equal(lane_fir(x, h), lane_fir_plain(x, h))
    for ntaps, ln in ((1, 5003), (64, 7064), (33, 3841 * 2 + 39)):
        x = T(rng.normal(size=(3, ln)).astype(np.float32)).to(cuda_device)
        h = rng.normal(size=ntaps).astype(np.float32)
        cuda.reset_launches()
        got, want = lane_fir(x, h), lane_fir_plain(x, h)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert cuda.body_launches == {"lane_fir:runtime_t": 1}


def test_cuda_plain_path_matches_cpu(cuda_device):
    """The bf16 plain-op RS41 step (use_pallas=False) on the card equals
    the CPU's on validity, valid frame bytes and RS verdicts, 8 channels
    with three serials over 3 blocks, and launches no hand kernel."""
    block, n_blocks, c = 48000, 3, 8
    n = block * n_blocks
    rows = []
    for k, serial in enumerate(["S1234567", "T7654321", "R0420042"]):
        iq = RS41Modulator().modulate(
            [RS41Truth(serial=serial, frame_no=20 + j)
             for j in range(n // 25600 + 2)])[37 * k:37 * k + n]
        rng = np.random.default_rng(k)
        iq = iq + 0.1 * (rng.normal(size=n) + 1j * rng.normal(size=n))
        rows.append([np.clip(x * 32767, -32768, 32767).astype(np.int16)
                     for x in (iq.real, iq.imag)])
    qi = np.stack([rows[ch % 3][0] for ch in range(c)])
    qq = np.stack([rows[ch % 3][1] for ch in range(c)])
    cfg = tpipe.PipelineConfig(sonde="rs41", channels=c, block_len=block,
                               use_pallas=False, compute_dtype="bf16",
                               input_dtype="i16")
    gp, cp = tpipe.Pipeline(cfg, cuda_device), tpipe.Pipeline(cfg, CPU)
    gs, cs = gp.init_state(), cp.init_state()
    cuda.reset_launches()
    frames = 0
    for b in range(n_blocks):
        sl = slice(b * block, (b + 1) * block)
        gs, go = gp.step(gs, (qi[:, sl], qq[:, sl]))
        cs, co = cp.step(cs, (qi[:, sl], qq[:, sl]))
        v = co.frame_valid
        assert torch.equal(go.frame_valid.cpu(), v)
        assert torch.equal(go.frames.cpu()[v], co.frames[v])
        assert torch.equal(go.rs_clean.cpu(), co.rs_clean)
        frames += int(v.sum())
    assert gs.chipbuf.dtype == torch.bfloat16 and frames >= 3 * c
    assert not any(cuda.launches.values()), cuda.launches
