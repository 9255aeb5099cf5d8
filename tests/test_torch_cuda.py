"""Tests that need an NVIDIA GPU: the port's CUDA kernels against their
plain twins (K7 in every body, K9, K10), and the kernel path (rs41, ims100
and mrzn1), the plain-op path (rs41, and the dual-tone families m10,
ims100 and mrzn1), the DDC and AFC loop and the fleet on the card against
the CPU.

This file imports neither jax nor the JAX package (sondetpu), so it runs
on a machine that has only torch and the CUDA toolkit; tests/conftest.py
sets JAX up, so leave it out there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device every test skips (the CUDA kernels have no CPU mode;
chip_smoke.py drives the same kernels and paths on the card).
"""

import json

import numpy as np
import pytest
import torch

from sondetpu_torch.dsp.fir import design_lowpass
from sondetpu_torch.kernels import cuda
from sondetpu_torch.kernels.dualtone import (dualtone_body,
                                             fused_dualtone_frontend,
                                             fused_dualtone_plain,
                                             mixer_tables)
from sondetpu_torch.kernels.frontend import (HALO, fused_demod_fir,
                                             fused_demod_fir_plain)
from sondetpu_torch.kernels.lane_fir import lane_fir, lane_fir_plain
from sondetpu_torch.runtime import pipeline as tpipe
from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession
from sondetpu_torch.sondes.dfm import DFMModulator, DFMTruth
from sondetpu_torch.sondes.ims100 import IMS100Modulator, IMS100Truth
from sondetpu_torch.sondes.m10 import M10Modulator, M10Truth
from sondetpu_torch.sondes.modulate import freq_shift
from sondetpu_torch.sondes.mrzn1 import MRZN1Modulator, MRZN1Truth
from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth

T = torch.from_numpy
CPU = torch.device("cpu")
FS = 48000.0
BLOCK = 48000
SERIALS = ("S1234567", "T7654321", "R0420042")
# the AFC-tracked frequency, card against CPU: K1's block DC and K7's
# rotation sums are summed in another order on the card (within 1e-5 of
# their twins', chip_smoke.py), which moves the loop by beta * dev * 1e-5
# a block, ~0.01 Hz; CUDA's cosf and sinf are 2 ulp against the CPU's 1
AFC_HZ = 0.25


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


# K7 (the dual-tone front end): m10's deviation at 48 kHz
DEV = 12000.0


def _dualtone_inputs(seed, c, n):
    rng = np.random.default_rng(seed)
    return ([T(rng.normal(size=(c, n)).astype(np.float32)) for _ in range(2)]
            + [T(rng.normal(size=(c, HALO)).astype(np.float32))
               for _ in range(2)])


def test_cuda_dualtone_matches_twin(cuda_device):
    planes = [p.to(cuda_device) for p in _dualtone_inputs(12, 16, 48000)]
    tabs = [T(t).to(cuda_device) for t in mixer_tables(BLOCK, DEV / FS)]
    taps = design_lowpass(0.45 * FS, FS, 41)
    before = cuda.launches["fused_dualtone_frontend"]
    got = fused_dualtone_frontend(*planes, taps, *tabs, 5, True, False)
    want = fused_dualtone_plain(*planes, taps, *tabs, 5, True, False)
    assert cuda.launches["fused_dualtone_frontend"] == before + 1
    assert torch.equal(got[0], want[0])
    for k in (3, 4, 5):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("c,n,skip,afc,nb", [
    (16, 48000, True, False, 5), (13, 30001, True, False, 5),
    (9, 48000, True, True, 5), (8, 30001, True, False, 7),
    (1, 1003, True, True, 7), (5, 30001, False, False, 3),
    (3, 4800, False, True, 5), (8, 48000, False, False, 20),
    (11, 48000, False, True, 20),
], ids=["m10", "edge-c13", "skip-afc", "runtime-nb7", "edge-c1-afc",
        "chanfilt", "chanfilt-afc", "chanfilt-nb20", "chanfilt-nb20-afc"])
def test_cuda_dualtone_bodies_exact(cuda_device, c, n, skip, afc, nb):
    """Every body of the dual-tone front end: metric bit-equal to the twin,
    sums within 1e-5 relative, tails equal, on channel counts that are not
    a multiple of the block's eight rows and blocks that are not a multiple
    of the tile; nb 20 with the channel filter is ims100's and mrzn1's
    (their 10 kHz taps)."""
    planes = [p.to(cuda_device) for p in _dualtone_inputs(19, c, n)]
    dev_hz = 2400.0 if nb == 20 else DEV
    tabs = [T(t).to(cuda_device) for t in mixer_tables(n, dev_hz / FS)]
    taps = design_lowpass(10000.0 if nb == 20 else 0.45 * FS, FS, 41)
    cuda.reset_launches()
    got = fused_dualtone_frontend(*planes, taps, *tabs, nb, afc, skip)
    want = fused_dualtone_plain(*planes, taps, *tabs, nb, afc, skip)
    assert cuda.body_launches == {
        f"fused_dualtone_frontend:{dualtone_body(nb, skip, afc)}": 1}
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    for k in (3, 4, 5):
        scale = max(float(want[k].abs().max()), 1e-30)
        assert float((got[k] - want[k]).abs().max()) <= 1e-5 * scale


def _rs41_rows(n_blocks, c=8, offsets=None):
    """complex [c, n_blocks * BLOCK]: channel ch carries SERIALS[ch % 3]
    from its own point in the frame stream, moved off the channel centre
    by offsets[ch] Hz when given, with its own noise of std 0.1."""
    n = BLOCK * n_blocks
    rows = []
    for ch in range(c):
        k = ch % 3
        iq = RS41Modulator().modulate(
            [RS41Truth(serial=SERIALS[k], frame_no=20 + j)
             for j in range(n // 25600 + 2)])[37 * k:37 * k + n]
        if offsets is not None:
            iq = iq * np.exp(2j * np.pi * offsets[ch] * np.arange(n) / FS)
        rng = np.random.default_rng(ch)
        rows.append(iq + 0.1 * (rng.normal(size=n) + 1j * rng.normal(size=n)))
    return np.stack(rows)


def _cs16(rows):
    return tuple(np.clip(x * 32767, -32768, 32767).astype(np.int16)
                 for x in (rows.real, rows.imag))


def _card_equals_cpu(cfg, device, planes, n_blocks):
    """Steps the pipeline on the card and on the CPU over the blocks of
    ``planes``: validity, valid frame bytes and RS verdicts equal. Returns
    (card state, CPU state, valid frames)."""
    gp, cp = tpipe.Pipeline(cfg, device), tpipe.Pipeline(cfg, CPU)
    gs, cs = gp.init_state(), cp.init_state()
    frames = 0
    for b in range(n_blocks):
        blk = tuple(x[:, b * BLOCK:(b + 1) * BLOCK] for x in planes)
        gs, go = gp.step(gs, blk)
        cs, co = cp.step(cs, blk)
        v = co.frame_valid
        assert torch.equal(go.frame_valid.cpu(), v)
        assert torch.equal(go.frames.cpu()[v], co.frames[v])
        assert torch.equal(go.rs_clean.cpu(), co.rs_clean)
        frames += int(v.sum())
    return gs, cs, frames


def test_cuda_pipeline_matches_cpu(cuda_device):
    """The RS41 kernel path on the card equals the CPU's (twins) on valid
    slots, byte for byte, 8 channels with three serials over 3 blocks."""
    cfg = tpipe.PipelineConfig(sonde="rs41", channels=8, block_len=BLOCK,
                               use_pallas=True, input_dtype="i16")
    cuda.reset_launches()
    _, _, frames = _card_equals_cpu(cfg, cuda_device, _cs16(_rs41_rows(3)), 3)
    assert frames >= 3 * 8
    assert all(cuda.launches[k] == 3 for k in ("fused_frontend", "corr",
                                                "rs_clean"))


def test_cuda_plain_path_matches_cpu(cuda_device):
    """The bf16 plain-op RS41 step (use_pallas=False) on the card equals
    the CPU's on validity, valid frame bytes and RS verdicts, 8 channels
    with three serials over 3 blocks, and launches no hand kernel."""
    cfg = tpipe.PipelineConfig(sonde="rs41", channels=8, block_len=BLOCK,
                               use_pallas=False, compute_dtype="bf16",
                               input_dtype="i16")
    cuda.reset_launches()
    gs, _, frames = _card_equals_cpu(cfg, cuda_device, _cs16(_rs41_rows(3)),
                                     3)
    assert gs.chipbuf.dtype == torch.bfloat16 and frames >= 3 * 8
    assert not any(cuda.launches.values()), cuda.launches


DUALTONE_SERIALS = {"m10": ("910-2-12345", "A05-3-54321", "C12-1-00042"),
                    "ims100": ("2136051", "2136052", "2136053"),
                    "mrzn1": (40, 41, 42)}


def _dualtone_rows(sonde, n_blocks, c=8):
    """complex [c, n_blocks * BLOCK]: channel ch carries serial ch % 3 of
    the family from its own point in the frame stream, with its own noise
    of std 0.05."""
    n = BLOCK * n_blocks
    rows = []
    for ch in range(c):
        k = ch % 3
        serial = DUALTONE_SERIALS[sonde][k]
        if sonde == "m10":
            iq = M10Modulator().modulate(
                [M10Truth(serial=serial, frame_no=5 + j)
                 for j in range(n // 8000 + 3)])
        elif sonde == "ims100":
            iq = IMS100Modulator().modulate(
                [IMS100Truth(serial=serial, frame_no=2 + j)
                 for j in range(n // 11520 + 3)])
        else:
            iq = MRZN1Modulator().modulate(
                [MRZN1Truth(serial_lo=serial, frame_no=1 + j)
                 for j in range(n // 5120 + 3)])
        iq = iq[37 * k:37 * k + n]
        rng = np.random.default_rng(40 + ch)
        rows.append(iq + 0.05 * (rng.normal(size=n)
                                 + 1j * rng.normal(size=n)))
    return np.stack(rows)


@pytest.mark.parametrize("sonde,afc", [("ims100", False), ("mrzn1", False),
                                       ("ims100", True), ("mrzn1", True)])
def test_cuda_dualtone_families_match_cpu(cuda_device, sonde, afc):
    """ims100 and mrzn1 on the kernel path, 8 channels with three serials,
    3 blocks: the card equals the CPU on validity and valid frame bytes,
    K7's channel-filter body (its _afc body with afc) once a block; with
    afc the tracked frequencies within AFC_HZ of the CPU's."""
    cfg = tpipe.PipelineConfig(sonde=sonde, channels=8, block_len=BLOCK,
                               use_pallas=True, input_dtype="i16", afc=afc)
    cuda.reset_launches()
    gs, cs, frames = _card_equals_cpu(cfg, cuda_device,
                                      _cs16(_dualtone_rows(sonde, 3)), 3)
    assert frames >= 3 * 8
    body = "fused_dualtone_frontend:chanfilt" + ("_afc" if afc else "")
    assert cuda.body_launches == {body: 3}, cuda.body_launches
    if afc:
        torch.testing.assert_close(gs.aux[-1].cpu(), cs.aux[-1], rtol=0,
                                   atol=AFC_HZ)


@pytest.mark.parametrize("sonde", ["m10", "ims100", "mrzn1"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_plain_dualtone_matches_cpu(cuda_device, sonde, dtype):
    """The plain-op dual-tone step (use_pallas=False) on the card equals
    the CPU's on validity and valid frame bytes, 8 channels with three
    serials over 3 blocks, and launches no hand kernel."""
    cfg = tpipe.PipelineConfig(sonde=sonde, channels=8, block_len=BLOCK,
                               use_pallas=False, compute_dtype=dtype,
                               input_dtype="i16")
    cuda.reset_launches()
    gs, _, frames = _card_equals_cpu(cfg, cuda_device,
                                     _cs16(_dualtone_rows(sonde, 3)), 3)
    assert frames >= 3 * 8
    assert gs.chipbuf.dtype == (torch.bfloat16 if dtype == "bf16"
                                else torch.float32)
    assert not any(cuda.launches.values()), cuda.launches


@pytest.mark.parametrize("sonde", ["rs41", "m10"])
def test_cuda_ddc_afc_matches_cpu(cuda_device, sonde):
    """Fine offsets and the AFC loop on the card: 8 channels, each off the
    channel centre by its own offset (rs41: within +/-7 kHz, beyond the 5
    kHz channel filter without the DDC; m10: +800 Hz, the loop from a zero
    seed), 3 blocks. The card equals the CPU on validity, valid frame bytes
    and RS verdicts, the tracked frequencies within AFC_HZ; rs41 runs K1,
    m10 K7's AFC body."""
    n_blocks = 3
    if sonde == "rs41":
        offs = tuple(float(f) for f in np.linspace(-7012.5, 6987.5, 8))
        planes = _cs16(_rs41_rows(n_blocks, offsets=offs))
        kw = dict(fine_offsets=offs, input_dtype="i16")
        body = "fused_frontend:decim2_t41"
    else:
        n = n_blocks * BLOCK
        iq = M10Modulator().modulate(
            [M10Truth(frame_no=i) for i in range(n // 8240 + 2)])[:n]
        iq = iq * np.exp(2j * np.pi * 800.0 * np.arange(n) / FS)
        rng = np.random.default_rng(9)
        rows = iq + 0.05 * (rng.normal(size=(8, n))
                            + 1j * rng.normal(size=(8, n)))
        planes = tuple(np.ascontiguousarray(x, np.float32)
                       for x in (rows.real, rows.imag))
        kw = {}
        body = "fused_dualtone_frontend:skip_nb5_afc"
    cfg = tpipe.PipelineConfig(sonde=sonde, channels=8, block_len=BLOCK,
                               use_pallas=True, afc=True, **kw)
    cuda.reset_launches()
    gs, cs, frames = _card_equals_cpu(cfg, cuda_device, planes, n_blocks)
    assert frames > 0
    assert cuda.body_launches.get(body) == n_blocks, cuda.body_launches
    torch.testing.assert_close(gs.aux[-1].cpu(), cs.aux[-1], rtol=0,
                               atol=AFC_HZ)


# the fleet: an rs41, an m10 and a dfm carrier in bins 1, 3 and 6 of an
# 8-bin wideband stream
N_BINS = 8
FLEET_PLAN = ((1, "rs41"), (3, "m10"), (6, "dfm"))


def _fleet_wideband(n_blocks=3):
    """complex64 [n_blocks * N_BINS * BLOCK]: the plan's carriers, each from
    the port's modulator at the wideband rate, moved to its bin's centre,
    plus seeded noise of std 0.02."""
    fs_wide = N_BINS * FS
    n = n_blocks * N_BINS * BLOCK
    sig = {"rs41": RS41Modulator().modulate(
        [RS41Truth(frame_no=40 + i) for i in range(2 * n_blocks)], fs=fs_wide),
        "m10": M10Modulator().modulate(
            [M10Truth(frame_no=8 + i) for i in range(6 * n_blocks)],
            fs=fs_wide),
        "dfm": DFMModulator().modulate(
            [DFMTruth(frame_no=2 + i) for i in range(5 * n_blocks)],
            fs=fs_wide)}
    wide = np.zeros(n, np.complex64)
    for k, family in FLEET_PLAN:
        center = (k if k < N_BINS / 2 else k - N_BINS) * FS
        x = freq_shift(sig[family][:n], center / fs_wide)
        wide[:x.size] += x
    rng = np.random.default_rng(11)
    return wide + (0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
                   ).astype(np.complex64)


def _telemetry_text(telem):
    return {k: json.dumps(t.to_dict(), sort_keys=True)
            for k, t in telem.items()}


def test_cuda_fleet_matches_cpu(cuda_device):
    """The 8-bin fleet on the card gives the CPU's telemetry (twins), and
    launches the PFB and dual-tone kernels."""
    wide = _fleet_wideband()
    w = N_BINS * BLOCK
    chans = [FleetChannel(b, s) for b, s in FLEET_PLAN]
    gpu = FleetSession(chans, N_BINS, cuda_device)
    cpu = FleetSession(chans, N_BINS, "cpu")
    cuda.reset_launches()
    for i in range(0, wide.size, w):
        gpu.process_wideband(wide[i:i + w])
        cpu.process_wideband(wide[i:i + w])
    assert all(cuda.launches[k] > 0 for k in ("pfb_fir_stream", "pfb_dft",
                                               "fused_dualtone_frontend"))
    assert sorted(gpu.telemetry) == [0, 1, 2]
    assert _telemetry_text(gpu.telemetry) == _telemetry_text(cpu.telemetry)
