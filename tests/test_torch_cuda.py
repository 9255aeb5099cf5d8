"""Tests that need an NVIDIA GPU: the port's CUDA kernels against their
plain twins (K1 and K7 in every body, on float32 and bfloat16 input, K4-K6
in float32 and bfloat16, K9, K10), and the kernel path (rs41, ims100 and
mrzn1), the plain-op path (rs41, and the dual-tone families m10, ims100
and mrzn1), the configs the kernel gates send to the plain-op path, the
jnp AFSK front end, the bfloat16 kernel routes, the DDC and AFC loop and
the fleet (float32, and bfloat16 with AFSK bins) on the card against the
CPU; the correlator in every body, the RS syndrome flag, the AFSK tone
kernel and the plain correlation's division; the peak pick against its
eager twin at every family's shape and on its edge rows, once a group
step on every route; the midpoint DC against its twin (four
torch.kthvalue selects) on ties, NaN, signed zeros, infinities, rows too
tied for shared memory and K7's metric at [2048, 192000], once an ims100
step and without a sync; the plain-op front end's
filter (``plain_fir``) against ``window_sum`` in every body and the plain
step against its eager tap passes; and the command line's device pieces
(the resampler, ``decode``) on the card against the CPU.

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

from sondetpu_torch.dsp.channelizer import PFBChannelizer
from sondetpu_torch.dsp import fir
from sondetpu_torch.dsp.fir import (apply_windows, conv1d, design_lowpass,
                                    window_sum)
from sondetpu_torch.dsp.resample import DeviceStreamingResampler
from sondetpu_torch.fec.rs import ReedSolomon
from sondetpu_torch.kernels import cuda
from sondetpu_torch.kernels.afsk import (afsk_tables, fused_afsk_frontend,
                                         fused_afsk_frontend_plain)
from sondetpu_torch.kernels.corr import corr_kernel, corr_plain
from sondetpu_torch.kernels.dualtone import (dualtone_body,
                                             fused_dualtone_frontend,
                                             fused_dualtone_plain,
                                             mixer_tables)
from sondetpu_torch.kernels.frontend import (HALO, WALK_EDGE_CASES,
                                             frontend_body, fused_demod_fir,
                                             fused_demod_fir_plain,
                                             fused_frontend,
                                             fused_frontend_plain)
from sondetpu_torch.kernels.midpoint import midpoint_dc, midpoint_dc_plain
from sondetpu_torch.kernels.lane_fir import (lane_fir, lane_fir_plain,
                                             plain_corr, plain_corr_body,
                                             plain_corr_plain, plain_fir,
                                             plain_fir_body)
from sondetpu_torch.kernels.peak_cases import (EDGE_CASES, THRESHOLDS,
                                               edge_case_rows, planted_rows)
from sondetpu_torch.kernels.peak_pick import (find_frame_starts_plain,
                                              peak_pick)
from sondetpu_torch.kernels.syndrome import (rs_clean_flags_kernel,
                                             rs_clean_plain)
from sondetpu_torch.kernels.pfb import (pfb_dft, pfb_dft_plain, pfb_fir_plain,
                                        pfb_fir_stream, pfb_fir_timemajor)
from sondetpu_torch.kernels.pfb_cases import (BF16_EDGE_CASES,
                                              bf16_edge_planes, misaligned)
from sondetpu_torch.runtime import pipeline as tpipe
from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession
from sondetpu_torch.sondes.c50 import C50Modulator, C50Truth
from sondetpu_torch.sondes.dfm import DFMModulator, DFMTruth
from sondetpu_torch.sondes.imet4 import IMET4Modulator, IMET4Truth
from sondetpu_torch.sondes.ims100 import IMS100Modulator, IMS100Truth
from sondetpu_torch.sondes.m10 import M10Modulator, M10Truth
from sondetpu_torch.sondes.modulate import freq_shift
from sondetpu_torch.sondes.mrzn1 import MRZN1Modulator, MRZN1Truth
from sondetpu_torch.sondes.rs41 import (SPEC, RS41Modulator, RS41Truth,
                                        RS41XModulator)
from sondetpu_torch.sondes import SUPPORTED_TYPES
from sondetpu_torch.sondes import imet4 as timet4
from sondetpu_torch.sondes import m10 as tm10
from sondetpu_torch.sync import correlator as tcorrelator

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


@pytest.mark.parametrize("c,n,skip,afc,nb,ntaps,skew", [
    (16, 48000, True, False, 5, 41, False),
    (13, 30001, True, False, 5, 41, False),
    (9, 48000, True, True, 5, 41, False),
    (8, 30001, True, False, 7, 41, False),
    (1, 1003, True, True, 7, 41, False),
    (5, 30001, False, False, 3, 41, False),
    (3, 4800, False, True, 5, 41, False),
    (8, 48000, False, False, 20, 41, False),
    (11, 48000, False, True, 20, 41, False),
    (13, 30001, False, False, 20, 41, False),
    (5, 30001, False, True, 20, 41, False),
    (1, 1003, False, True, 20, 41, False),
    (9, 30001, False, False, 20, 41, True),
    (9, 48000, False, True, 20, 41, True),
    (8, 48000, False, False, 20, 33, False),
    (11, 30001, False, True, 20, 33, False),
    (8, 48000, False, False, 19, 41, False),
    (13, 30001, False, True, 21, 41, False),
], ids=["m10", "edge-c13", "skip-afc", "runtime-nb7", "edge-c1-afc",
        "chanfilt", "chanfilt-afc", "chanfilt-nb20", "chanfilt-nb20-afc",
        "nb20-edge-c13", "nb20-edge-c5-afc", "nb20-edge-c1-n1003-afc",
        "nb20-misaligned", "nb20-misaligned-afc", "t33-nb20",
        "t33-nb20-afc-edge-c11", "chanfilt-nb19",
        "chanfilt-nb21-afc-edge-c13"])
def test_cuda_dualtone_bodies_exact(cuda_device, c, n, skip, afc, nb, ntaps,
                                    skew):
    """Every body of the dual-tone front end: metric bit-equal to the twin,
    sums within 1e-5 relative, tails equal, on channel counts that are not
    a multiple of the block's eight rows, blocks that are not a multiple
    of the tile and planes off 16-byte alignment (skew, the element-wise
    staging); nb 20 with the channel filter is ims100's and mrzn1's (their
    10 kHz taps), compiled in with 41 taps, at run time with 33 or beside
    nb 19 and 21."""
    planes = [p.to(cuda_device) for p in _dualtone_inputs(19, c, n)]
    if skew:
        planes = [misaligned(p) for p in planes]
    dev_hz = 2400.0 if nb >= 19 else DEV
    tabs = [T(t).to(cuda_device) for t in mixer_tables(n, dev_hz / FS)]
    taps = design_lowpass(10000.0 if nb >= 19 else 0.45 * FS, FS, ntaps)
    cuda.reset_launches()
    got = fused_dualtone_frontend(*planes, taps, *tabs, nb, afc, skip)
    want = fused_dualtone_plain(*planes, taps, *tabs, nb, afc, skip)
    assert cuda.body_launches == {
        "fused_dualtone_frontend:"
        f"{dualtone_body(nb, skip, afc, ntaps=ntaps)}": 1}
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


def _plain_route_bodies(cfg, steps):
    """The launches by body in ``steps`` steps of a pipeline of ``cfg`` of
    the two kernels that stand in for plain ops: the plain correlation, one
    a template a step, of the body its length names, on every route but
    the fused front end's (which runs K2); on the plain-op route also the
    plain filter, one a filter a step (the channel filter's two planes
    unless the dual-tone gate skips it, then the matched filter, the
    dual-tone boxcar over its four planes or the AFSK boxcar's four)."""
    if tpipe._route(cfg) == "fused":
        return {}
    pipe = tpipe.Pipeline(cfg, CPU)
    out = {}

    def add(key, n):
        out[key] = out.get(key, 0) + n * steps

    for t in pipe._np_templates:
        add("plain_corr:" + plain_corr_body(len(t)), 1)
    if pipe._plain:
        if not pipe._skip_chanfilt:
            add("plain_fir:" + plain_fir_body(cfg.ntaps, cfg.decim), 2)
        if pipe._afsk:
            add("plain_fir:" + plain_fir_body(pipe._afsk_win, 1), 4)
        else:
            add("plain_fir:" + plain_fir_body(cfg.ntaps, 1), 1)
    return out


def _only_plain_kernels(cfg, steps):
    """True when the plain correlation and the plain filter are the only
    hand kernels launched since the counts were reset, as many times as
    :func:`_plain_route_bodies` says, beside the peak pick, once a step,
    and on the midpoint-DC families (ims100, mrzn1) the midpoint DC, once
    a step where the plain-op step removes a DC (dc_block or afc)."""
    want = {"peak_pick": steps}
    if cfg.spec.extra.get("dc_mode") == "midpoint" and (cfg.dc_block
                                                        or cfg.afc):
        want["midpoint_dc"] = steps
    for key, n in _plain_route_bodies(cfg, steps).items():
        kernel = key.split(":")[0]
        want[kernel] = want.get(kernel, 0) + n
    return {k: v for k, v in cuda.launches.items() if v} == want


def test_cuda_pipeline_matches_cpu(cuda_device):
    """The RS41 kernel path on the card equals the CPU's (twins) on valid
    slots, byte for byte, 8 channels with three serials over 3 blocks."""
    cfg = tpipe.PipelineConfig(sonde="rs41", channels=8, block_len=BLOCK,
                               use_pallas=True, input_dtype="i16")
    cuda.reset_launches()
    _, _, frames = _card_equals_cpu(cfg, cuda_device, _cs16(_rs41_rows(3)), 3)
    assert frames >= 3 * 8
    assert all(cuda.launches[k] == 3 for k in ("fused_frontend", "corr",
                                                "rs_clean", "peak_pick"))


def test_cuda_plain_path_matches_cpu(cuda_device):
    """The bf16 plain-op RS41 step (use_pallas=False) on the card equals
    the CPU's on validity, valid frame bytes and RS verdicts, 8 channels
    with three serials over 3 blocks, and launches no hand kernel but the
    plain correlation, once a block, and the plain filter, three times."""
    cfg = tpipe.PipelineConfig(sonde="rs41", channels=8, block_len=BLOCK,
                               use_pallas=False, compute_dtype="bf16",
                               input_dtype="i16")
    cuda.reset_launches()
    gs, _, frames = _card_equals_cpu(cfg, cuda_device, _cs16(_rs41_rows(3)),
                                     3)
    assert gs.chipbuf.dtype == torch.bfloat16 and frames >= 3 * 8
    assert _only_plain_kernels(cfg, 3), cuda.launches


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_plain_path_packs_what_the_eager_filters_pack(cuda_device,
                                                           monkeypatch,
                                                           dtype):
    """The plain-op RS41 step (f32: the command line's default route) on
    the card packs bit for bit what it packed with the eager tap passes in
    place of the plain filter, over 3 blocks of 8 channels with three
    serials: every field of every block's output and the carried state; its
    filters are three plain_fir launches a step (t41_d2 for the channel
    filter's two planes, t41_d1 for the matched filter). Its valid frames and RS verdicts equal the CPU's."""
    cfg = tpipe.PipelineConfig(sonde="rs41", channels=8, block_len=BLOCK,
                               use_pallas=False, compute_dtype=dtype,
                               input_dtype="i16")
    planes = _cs16(_rs41_rows(3))
    blocks = [tuple(x[:, b * BLOCK:(b + 1) * BLOCK] for x in planes)
              for b in range(3)]

    def run():
        pipe = tpipe.Pipeline(cfg, cuda_device)
        state, outs = pipe.init_state(), []
        for blk in blocks:
            state, out = pipe.step(state, blk)
            outs.append(out)
        return state, outs

    cuda.reset_launches()
    gs, gouts = run()
    assert cuda.body_launches == {"plain_fir:t41_d2": 6,
                                  "plain_fir:t41_d1": 3,
                                  "plain_corr:t64": 3}
    monkeypatch.setattr(tpipe, "apply_windows", fir.window_sum)
    es, eouts = run()
    for b, (g, e) in enumerate(zip(gouts, eouts)):
        for name in g._fields:
            assert torch.equal(getattr(g, name), getattr(e, name)), (b, name)
    for name in ("chan_tail_i", "chan_tail_q", "fm_prev", "chipbuf",
                 "buf_fill"):
        assert torch.equal(getattr(gs, name), getattr(es, name)), name
    assert torch.equal(gs.fir.tail, es.fir.tail)
    monkeypatch.undo()
    _card_equals_cpu(cfg, cuda_device, planes, 3)


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
    K7's channel-filter body (its _afc body with afc) and the plain
    correlation once a block; with afc the tracked frequencies within
    AFC_HZ of the CPU's."""
    cfg = tpipe.PipelineConfig(sonde=sonde, channels=8, block_len=BLOCK,
                               use_pallas=True, input_dtype="i16", afc=afc)
    cuda.reset_launches()
    gs, cs, frames = _card_equals_cpu(cfg, cuda_device,
                                      _cs16(_dualtone_rows(sonde, 3)), 3)
    assert frames >= 3 * 8
    body = ("fused_dualtone_frontend:chanfilt_t41_nb20"
            + ("_afc" if afc else ""))
    assert cuda.body_launches == {body: 3, **_plain_route_bodies(cfg, 3)}, \
        cuda.body_launches
    if afc:
        torch.testing.assert_close(gs.aux[-1].cpu(), cs.aux[-1], rtol=0,
                                   atol=AFC_HZ)


@pytest.mark.parametrize("sonde", ["m10", "ims100", "mrzn1"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_plain_dualtone_matches_cpu(cuda_device, sonde, dtype):
    """The plain-op dual-tone step (use_pallas=False) on the card equals
    the CPU's on validity and valid frame bytes, 8 channels with three
    serials over 3 blocks, and launches no hand kernel but the plain
    correlation (m10: its syncword and alternate), once a block."""
    cfg = tpipe.PipelineConfig(sonde=sonde, channels=8, block_len=BLOCK,
                               use_pallas=False, compute_dtype=dtype,
                               input_dtype="i16")
    cuda.reset_launches()
    gs, _, frames = _card_equals_cpu(cfg, cuda_device,
                                     _cs16(_dualtone_rows(sonde, 3)), 3)
    assert frames >= 3 * 8
    assert gs.chipbuf.dtype == (torch.bfloat16 if dtype == "bf16"
                                else torch.float32)
    assert _only_plain_kernels(cfg, 3), cuda.launches


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


# --- K1 (moved here, jax-free inputs) and K1, K7 on bfloat16 input ----------

def _frontend_args(seed, c, n, decim, ntaps=41, delta=False,
                   dtype=torch.float32, device=CPU):
    """K1's arguments: seeded planes and tails, RS41's channel filter and
    a lowpass matched filter, or the exact delay [0, ..., 0, 1]."""
    rng = np.random.default_rng(seed)
    planes = [T(rng.normal(size=s).astype(np.float32)).to(device, dtype)
              for s in ((c, n), (c, n), (c, HALO), (c, HALO))]
    ct = design_lowpass(5000.0, FS, ntaps)
    if delta:
        mt = np.zeros(ntaps, np.float32)
        mt[-1] = 1.0
    else:
        mt = design_lowpass(2640.0, FS / decim, ntaps)
    return planes, ct, mt, float(np.float32(FS / decim / (2 * np.pi * 2400)))


@pytest.mark.parametrize("decim", [1, 2])
def test_cuda_fused_frontend_matches_twin(cuda_device, decim):
    planes, ct, mt, scale = _frontend_args(11, 16, 48000, decim,
                                           device=cuda_device)
    before = cuda.launches["fused_frontend"]
    got = fused_frontend(*planes, ct, mt, scale, decim, True)
    want = fused_frontend_plain(*planes, ct, mt, scale, decim, True)
    assert cuda.launches["fused_frontend"] == before + 1
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=1e-5)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("taps", ["lowpass", "delta"])
@pytest.mark.parametrize("ntaps", [41, 33])
@pytest.mark.parametrize("decim", [1, 2])
def test_cuda_fused_frontend_bodies_exact(cuda_device, decim, ntaps, taps):
    """Every body of the front end (41 taps at compile time or T at run
    time, matched FIR or identity) equals its twin bit for bit before the
    DC, on a block that is not a multiple of the tile."""
    planes, ct, mt, _ = _frontend_args(14, 3, 2 * 4803, decim, ntaps,
                                       taps == "delta", device=cuda_device)
    cuda.reset_launches()
    got = fused_frontend(*planes, ct, mt, 3.2, decim, False)
    want = fused_frontend_plain(*planes, ct, mt, 3.2, decim, False)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=1e-5)
    body = frontend_body(decim, ntaps, taps == "delta")
    assert cuda.body_launches == {f"fused_frontend:{body}": 1}


_BF16_BODIES = (
    [pytest.param("k1", d, t, delta, None, id=f"k1-decim{d}-t{t}"
                  + ("-identity" if delta else ""))
     for d in (1, 2) for t in (41, 33) for delta in (False, True)]
    + [pytest.param("k1", d, 41, delta, edge, id=f"k1-decim{d}-t41"
                    + ("-identity" if delta else "") + f"-{edge}")
       for d in (1, 2) for delta in (False, True)
       for edge in WALK_EDGE_CASES]
    + [pytest.param("k7", nb, skip, afc, None, id=f"k7-{body}")
       for nb, skip, afc, body in (
           (5, True, False, "skip_nb5"), (5, True, True, "skip_nb5_afc"),
           (7, True, False, "skip_runtime_nb"),
           (7, True, True, "skip_runtime_nb_afc"),
           (19, False, False, "chanfilt"), (21, False, True, "chanfilt_afc"),
           (20, False, False, "chanfilt_t41_nb20"),
           (20, False, True, "chanfilt_t41_nb20_afc"))])


@pytest.mark.parametrize("kernel,a,b,c,edge", _BF16_BODIES)
def test_cuda_bf16_input_equals_f32_on_widened(cuda_device, monkeypatch,
                                               kernel, a, b, c, edge):
    """K1 and K7 in every body on bfloat16 planes and tails (the body
    named with _bf16) give bit for bit what the float32 body gives on the
    same values widened to float32, on 13 channels (not a multiple of K7's
    eight rows) and a block no tile divides; the carried tails are the
    bfloat16 input. K1's walking bodies (41 taps) also on the inputs of
    kernels/frontend.py:WALK_EDGE_CASES, DC included."""
    from sondetpu_torch.kernels import frontend as kfront

    bf = torch.bfloat16
    rows, n = 13, 30001
    if kernel == "k1":
        decim, ntaps, delta = a, b, c
        misaligned_planes, walk = False, None
        if edge is not None:
            rows, n, misaligned_planes, walk = WALK_EDGE_CASES[edge]
            n *= decim
        n += n % 2 if decim == 2 else 0
        planes, ct, mt, scale = _frontend_args(15, rows, n, decim, ntaps,
                                               delta, bf, cuda_device)
        if misaligned_planes:
            planes = [misaligned(p) for p in planes]
            assert planes[0].data_ptr() % 16 == 2
        if walk is not None:
            monkeypatch.setattr(kfront, "frontend_walk",
                                lambda c, tiles, sms: walk)
        cuda.reset_launches()
        got = fused_frontend(*planes, ct, mt, scale, decim, True)
        want = fused_frontend(*(p.float() for p in planes), ct, mt, scale,
                              decim, True)
        body = "fused_frontend:" + frontend_body(decim, ntaps, delta, True)
    else:
        nb, skip, afc = a, b, c
        rng = np.random.default_rng(16)
        planes = [T(rng.normal(size=s).astype(np.float32)).to(cuda_device, bf)
                  for s in ((rows, n), (rows, n), (rows, HALO), (rows, HALO))]
        taps = design_lowpass(0.45 * FS, FS, 41)
        tabs = [T(t).to(cuda_device) for t in mixer_tables(n, 0.25)]
        cuda.reset_launches()
        got = fused_dualtone_frontend(*planes, taps, *tabs, nb, afc, skip)
        want = fused_dualtone_frontend(*(p.float() for p in planes), taps,
                                       *tabs, nb, afc, skip)
        body = ("fused_dualtone_frontend:"
                + dualtone_body(nb, skip, afc, True))
    assert cuda.body_launches.get(body) == 1, cuda.body_launches
    for g, w in zip(got, want):
        if g.dtype == bf:
            continue
        assert torch.equal(g, w)
    assert got[1].dtype == bf and torch.equal(got[1], planes[0][:, -HALO:])
    assert torch.equal(got[2], planes[1][:, -HALO:])


def _pfb_planes(device, m, n, seed):
    rng = np.random.default_rng(seed)
    return [T(rng.normal(size=s).astype(np.float32)).to(device)
            for s in ((m, n), (m, n), (8, n), (8, n))]


def test_cuda_pfb_kernels_match_twins(cuda_device):
    n, m = 512, 300
    x_i, x_q, t_i, t_q = _pfb_planes(cuda_device, m, n, 10)
    hcol = PFBChannelizer(n, cuda_device)._hcol_t
    got = pfb_fir_stream(x_i, x_q, t_i, t_q, hcol)
    want = pfb_fir_plain(torch.cat([t_i, x_i]), torch.cat([t_q, x_q]), hcol)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got_tm = pfb_fir_timemajor(torch.cat([t_i, x_i]), torch.cat([t_q, x_q]),
                               hcol)
    assert torch.equal(got_tm[0], got[0]) and torch.equal(got_tm[1], got[1])
    y = pfb_dft(*got)
    w = pfb_dft_plain(*got)
    for a, b in zip(y, w):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("n", [4, 6])
def test_cuda_channelizer_outside_the_dft_kernel(cuda_device, n):
    """N outside the DFT kernel's powers of two from 8 to 4096 (the 4-bin
    AutoFleet of tests/data/jax_autofleet_checkpoint.py): the channelizer
    runs the branch FIR kernel and the DFT's plain twin on the card, equal
    to the CPU within 1e-4 of max|y|."""
    rng = np.random.default_rng(n)
    x = [rng.normal(size=n * 4000).astype(np.float32) for _ in range(2)]
    card, cpu = PFBChannelizer(n, cuda_device), PFBChannelizer(n, "cpu")
    cuda.reset_launches()
    _, *got = card(card.init_state(), *(T(a).to(cuda_device) for a in x))
    _, *want = cpu(cpu.init_state(), *(T(a) for a in x))
    assert cuda.launches["pfb_dft"] == 0
    assert cuda.launches["pfb_fir_stream"] == 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


def _bf16_bits(t):
    return t.view(torch.int16)


# (n, m, edge case or None, K6 on a misaligned copy): the fleet's 2048
# bins and 16 on a ragged m, K4/K5 on each edge-value plane, an odd N
# (K4's paired columns on scalar loads and stores; no K6 there), and K6 on
# m that no 16-row cluster tile divides (one tile with an empty block, one
# whose second block has one row) and on planes its bulk copies cannot take
@pytest.mark.parametrize("n, m, case, skew", [
    pytest.param(2048, 1003, None, False, id="2048"),
    pytest.param(16, 1003, None, False, id="16"),
    *(pytest.param(2048, 1003, c, False, id=f"2048-{c}")
      for c in BF16_EDGE_CASES),
    pytest.param(2047, 1003, None, False, id="2047-odd"),
    pytest.param(2048, 5, None, False, id="2048-m5"),
    pytest.param(2048, 9, None, False, id="2048-m9"),
    pytest.param(2048, 1003, None, True, id="2048-misaligned")])
def test_cuda_bf16_pfb_kernels_match_twins(cuda_device, n, m, case, skew):
    """K4 and K5 in bfloat16 equal their twin run in bfloat16 as int16 bit
    patterns (every product and sum rounded to bfloat16, body bf16; a
    flushed subnormal or a lost signed zero would show); K6 on bfloat16 u
    (its n2048_bf16 or radix2_bf16 body) within one bfloat16 step at
    max|y| plus 1e-4 of max|y| (K6's float32 tolerance) of the float32
    transform of the widened u."""
    bf = torch.bfloat16
    if case is None:
        x_i, x_q, t_i, t_q = _pfb_planes(cuda_device, m, n, 12)
        hcol = PFBChannelizer(n, cuda_device)._hcol_t
    else:
        vi, vq, taps = bf16_edge_planes(case, 8 + m, n, 12)
        t_i, x_i, t_q, x_q = (T(a).to(cuda_device) for a in (
            vi[:8], vi[8:], vq[:8], vq[8:]))
        hcol = (PFBChannelizer(n, cuda_device)._hcol_t if taps is None
                else T(taps).to(cuda_device))
    cuda.reset_launches()
    got = pfb_fir_stream(x_i, x_q, t_i, t_q, hcol, bf)
    want = pfb_fir_plain(torch.cat([t_i, x_i]), torch.cat([t_q, x_q]), hcol,
                         bf)
    assert got[0].dtype == bf
    for a, b in zip(got, want):
        assert torch.equal(_bf16_bits(a), _bf16_bits(b))
    vv = [torch.cat([t, x[:5]]) for t, x in ((t_i, x_i), (t_q, x_q))]
    tm = pfb_fir_timemajor(*vv, hcol, bf)
    tw = pfb_fir_plain(*vv, hcol, bf)
    for a, b in zip(tm, tw):
        assert torch.equal(_bf16_bits(a), _bf16_bits(b))
    bodies = {"pfb_fir_stream:bf16": 1, "pfb_fir_timemajor:bf16": 1}
    if n & (n - 1) == 0 and case is None:
        u = [misaligned(v) for v in got] if skew else got
        y = pfb_dft(*u)
        w = pfb_dft_plain(*(v.float() for v in got))
        for a, b in zip(y, w):
            top = float(b.abs().max())
            ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
            assert a.dtype == bf
            assert float((a.float() - b).abs().max()) <= ulp + 1e-4 * top
        body = "n2048_bf16" if n == 2048 else "radix2_bf16"
        bodies[f"pfb_dft:{body}"] = 1
    assert cuda.body_launches == bodies, cuda.body_launches


# --- the configs of the kernel gates, the jnp AFSK front end, bf16 routes ------

def _family_rows(sonde, n, fs=FS, c=8, noise=0.05):
    """cs16 (i, q) [c, n] at rate fs: channel ch carries truth ch % 3 of
    the family from its own point in the frame stream, with its own
    noise."""
    rows = []
    for ch in range(c):
        k = ch % 3
        m = n + 37 * k
        if sonde == "rs41":
            iq = RS41Modulator().modulate(
                [RS41Truth(serial=SERIALS[k], frame_no=20 + j)
                 for j in range(m // 25000 + 2)], fs=fs)
        elif sonde == "m10":
            iq = M10Modulator().modulate(
                [M10Truth(serial=DUALTONE_SERIALS["m10"][k], frame_no=5 + j)
                 for j in range(m // 8000 + 2)], fs=fs)
        elif sonde == "ims100":
            iq = IMS100Modulator().modulate(
                [IMS100Truth(serial=DUALTONE_SERIALS["ims100"][k],
                             frame_no=2 + j)
                 for j in range(m // 11000 + 2)], fs=fs)
        elif sonde == "imet4":
            iq = IMET4Modulator().modulate(
                [IMET4Truth(frame_no=1 + j, lat=40.0 + k)
                 for j in range(m // 20000 + 2)], fs=fs)
        else:
            iq = C50Modulator().modulate(
                [C50Truth(serial_num=12345 + k, frame_no=1 + j)
                 for j in range(m // 10000 + 2)], fs=fs)
        iq = iq[37 * k:37 * k + n]
        rng = np.random.default_rng(60 + ch)
        rows.append(iq + noise * (rng.normal(size=n)
                                  + 1j * rng.normal(size=n)))
    return _cs16(np.stack(rows))


# id -> (config, blocks, the bodies launched per block on the card)
_ROUTED = {
    "channels-12": (dict(sonde="rs41", channels=12), 3, {}),
    "block-200": (dict(sonde="m10", block_len=200), 240, {}),
    "fractional-sps": (dict(sonde="rs41", fs=50000.0, block_len=50000), 3,
                       {"fused_frontend:decim2_t41": 1,
                        "corr:sign_l64": 1, "rs_clean:c384": 1}),
    "ims100-48100": (dict(sonde="ims100", fs=48100.0, block_len=48100), 3,
                     {"fused_dualtone_frontend:chanfilt_t41_nb20": 1}),
    "imet4-plain": (dict(sonde="imet4", use_pallas=False), 3, {}),
    "c50-plain": (dict(sonde="c50", use_pallas=False), 3, {}),
    "imet4-l-not-dividing": (dict(sonde="imet4", block_len=48040), 3, {}),
    "m10-bf16-kernel": (dict(sonde="m10", compute_dtype="bf16"), 3,
                        {"fused_dualtone_frontend:skip_nb5_bf16": 1}),
    "ims100-bf16-kernel": (dict(sonde="ims100", compute_dtype="bf16"), 3,
                           {"fused_dualtone_frontend:"
                            "chanfilt_t41_nb20_bf16": 1}),
    "m10-fm-fallback-bf16": (dict(sonde="m10", block_len=48005,
                                  compute_dtype="bf16"), 3,
                             {"fused_frontend:decim1_t41_bf16": 1,
                              "corr:long_l": 1, "corr:sign_l64": 1}),
}


@pytest.mark.parametrize("case", list(_ROUTED))
def test_cuda_routed_configs_match_cpu(cuda_device, case):
    """Each config on the card equals the CPU (twins) on validity, valid
    frame bytes and RS verdicts block by block, and launches exactly the
    bodies of its route, with the plain correlation once a template a
    block on every route but the fused one: no other where a kernel gate
    fails (12 channels, a 200-sample block, a block the AFSK tones' period
    does not divide) or use_pallas is off (the jnp AFSK front end); K1 and
    K7 with
    linear_interp at 50 and 48.1 kHz; the bfloat16 bodies of K7, and of K1
    with K2 on the widened bfloat16 ring on m10's FM fallback (m10's
    80-chip template and M20's 64-chip alternate)."""
    import warnings

    kw, n_blocks, bodies = _ROUTED[case]
    kw = {**dict(channels=8, block_len=BLOCK, use_pallas=True,
                 input_dtype="i16"), **kw}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # m10's FM fallback warns
        cfg = tpipe.PipelineConfig(**kw)
        gp, cp = tpipe.Pipeline(cfg, cuda_device), tpipe.Pipeline(cfg, CPU)
    block = cfg.block_len
    qi, qq = _family_rows(cfg.sonde, n_blocks * block, cfg.fs,
                          cfg.channels)
    gs, cs = gp.init_state(), cp.init_state()
    cuda.reset_launches()
    frames = 0
    for b in range(n_blocks):
        blk = (qi[:, b * block:(b + 1) * block],
               qq[:, b * block:(b + 1) * block])
        gs, go = gp.step(gs, blk)
        cs, co = cp.step(cs, blk)
        v = co.frame_valid
        assert torch.equal(go.frame_valid.cpu(), v), f"block {b}"
        assert torch.equal(go.frames.cpu()[v], co.frames[v])
        assert torch.equal(go.rs_clean.cpu(), co.rs_clean)
        frames += int(v.sum())
    assert frames >= cfg.channels
    assert cuda.body_launches == {
        **{k: n_blocks * v for k, v in bodies.items()},
        **_plain_route_bodies(cfg, n_blocks)}
    if not bodies:
        assert _only_plain_kernels(cfg, n_blocks), cuda.launches


def test_cuda_bf16_fleet_with_afsk_bins_matches_cpu(cuda_device):
    """A 16-bin fleet in bfloat16 with the default use_pallas (every group
    on its kernel route) and rs41, m10, dfm, imet4 and c50 carriers: the
    card gives the CPU's telemetry, every carrier decodes, and the PFB runs
    its bf16 bodies."""
    n_bins, n_blocks = 16, 2
    fs_wide = n_bins * FS
    plan = ((2, "rs41"), (4, "m10"), (7, "dfm"), (10, "imet4"), (13, "c50"))
    n = n_blocks * n_bins * BLOCK
    sig = {"rs41": RS41Modulator().modulate(
        [RS41Truth(frame_no=40 + i) for i in range(5)], fs=fs_wide),
        "m10": M10Modulator().modulate(
            [M10Truth(frame_no=8 + i) for i in range(14)], fs=fs_wide),
        "dfm": DFMModulator().modulate(
            [DFMTruth(frame_no=2 + k) for k in range(11)], fs=fs_wide),
        "imet4": IMET4Modulator().modulate(
            [IMET4Truth(frame_no=1 + k) for k in range(3)], fs=fs_wide),
        "c50": C50Modulator().modulate(
            [C50Truth(frame_no=1 + k) for k in range(10)], fs=fs_wide)}
    wide = np.zeros(n, np.complex64)
    for k, family in plan:
        center = (k if k < n_bins / 2 else k - n_bins) * FS
        x = freq_shift(sig[family][:n], center / fs_wide)
        wide[:x.size] += x
    rng = np.random.default_rng(16)
    wide += (0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
             ).astype(np.complex64)
    chans = [FleetChannel(b, s) for b, s in plan]
    gpu = FleetSession(chans, n_bins, cuda_device, compute_dtype="bf16")
    cpu = FleetSession(chans, n_bins, "cpu", compute_dtype="bf16")
    cuda.reset_launches()
    w = n_bins * BLOCK
    for i in range(0, n, w):
        gpu.process_wideband(wide[i:i + w])
        cpu.process_wideband(wide[i:i + w])
    assert cuda.body_launches.get("pfb_fir_stream:bf16") == n_blocks
    assert cuda.body_launches.get("pfb_dft:radix2_bf16") == n_blocks
    assert cuda.launches["fused_afsk_frontend"] == 2 * n_blocks
    assert sorted(gpu.telemetry) == list(range(len(plan)))
    assert _telemetry_text(gpu.telemetry) == _telemetry_text(cpu.telemetry)


# --- K2, K3 and K8 against their twins, the plain correlation's division ----
# (moved here from tests/test_torch_kernels.py and tests/test_torch_afsk.py,
# whose imports of jax kept them off the card; the inputs come from numpy
# and the port's own modules)

def _signs(L, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, L) * 2 - 1).astype(dtype)


def _corrupt(rng, frames, covered):
    """XOR 1-3 random bytes of ``covered`` into about half the rows (fewer
    errors than the code's distance, so each such row is dirty)."""
    bad = rng.random(len(frames)) < 0.5
    for r in np.nonzero(bad)[0]:
        pos = rng.choice(covered, size=rng.integers(1, 4), replace=False)
        frames[r, pos] ^= rng.integers(1, 256, size=pos.size).astype(np.uint8)
    return frames, ~bad


def _frames_clean_and_corrupt(seed, rows, fb=320):
    rng = np.random.default_rng(seed)
    mod = RS41Modulator() if fb == 320 else RS41XModulator()
    base = np.stack([mod.build_frame(RS41Truth(frame_no=k), fb != 320)
                     for k in range(8)])
    return _corrupt(rng, base[rng.integers(0, 8, size=rows)],
                    np.arange(8, fb))


# a frame of 61 bytes (not a multiple of 4) with one 8-root codeword, and
# one of 267 bytes with two interleaved 32-root codewords (the c512 body)
_EDGE_LAYOUTS = {
    "odd61": (61, {"data_start": 9, "parity_start": 1, "nroots": 8,
                   "interleave": 1, "fcr": 0, "prim": 0x11D}),
    "c512": (267, {"data_start": 66, "parity_start": 2, "nroots": 32,
                   "interleave": 2, "fcr": 0, "prim": 0x11D}),
}


def _layout_case(name, seed, rows):
    """(frames, truth, layout) of rs41 (320 B), rs41x (518 B) or an edge
    layout, its parity filled in by the RS encoder."""
    if name not in _EDGE_LAYOUTS:
        fb = 320 if name == "rs41" else 518
        return (*_frames_clean_and_corrupt(seed, rows, fb), SPEC.extra["rs"])
    fb, layout = _EDGE_LAYOUTS[name]
    rng = np.random.default_rng(seed)
    ds, ps, nroots = (layout[k] for k in ("data_start", "parity_start",
                                          "nroots"))
    ilv = layout["interleave"]
    nrs = (fb - ds) // ilv
    frames = rng.integers(0, 256, size=(rows, fb)).astype(np.uint8)
    rs = ReedSolomon(nroots, layout["fcr"], layout["prim"])
    covered = []
    for i in range(ilv):
        data = ds + ilv * np.arange(nrs) + i
        parity = ps + nroots * i + np.arange(nroots)
        frames[:, parity] = rs.encode(frames[:, data])[:, nrs:]
        covered += [data, parity]
    return (*_corrupt(rng, frames, np.concatenate(covered)), layout)


def test_cuda_corr_and_rs_clean_match_twins(cuda_device):
    rng = np.random.default_rng(12)
    buf = T(rng.normal(size=(16, 7360)).astype(np.float32)).to(cuda_device)
    tmpl = T(SPEC.sync_chip_template()).to(cuda_device)
    assert torch.equal(corr_kernel(buf, tmpl), corr_plain(buf, tmpl))
    for name in ("rs41", "rs41x", "odd61", "c512"):
        frames, truth, layout = _layout_case(name, 13, 67)
        fr = T(frames).to(cuda_device)
        got = rs_clean_flags_kernel(fr, layout)
        assert torch.equal(got, rs_clean_plain(fr, layout))
        np.testing.assert_array_equal(got.cpu().numpy(), truth)
    with pytest.raises(ValueError, match="contiguous"):
        corr_kernel(buf.t().contiguous().t(), tmpl)


@pytest.mark.parametrize("label,c,n,kind,L,body", [
    ("rs41", 16, 7360, "rs41", 64, "sign_l64"),
    ("rounded-l64", 16, 7360, "normal", 64, "rounded_l64"),
    ("dfm", 8, 10560, "dfm", 32, "sign_l32"),
    ("rounded-l32", 8, 4000, "normal", 32, "rounded_l32"),
    ("sign-runtime", 8, 4001, "signs", 48, "sign_runtime_l"),
    ("rounded-runtime", 8, 4001, "normal", 20, "rounded_runtime_l"),
    ("long", 4, 9001, "normal", 300, "long_l"),
    ("edge-c1", 1, 4099, "rs41", 64, "sign_l64"),
    ("edge-c3-l32", 3, 3871, "signs", 32, "sign_l32"),
])
def test_cuda_corr_bodies_exact(cuda_device, label, c, n, kind, L, body):
    """Every body of the correlator equals its twin bit for bit, on
    buffers that are not a multiple of the tile (nor, for some, of four)."""
    from sondetpu_torch.sondes.dfm import SPEC as DFM_SPEC

    rng = np.random.default_rng(17)
    t = {"rs41": SPEC.sync_chip_template, "dfm": DFM_SPEC.sync_chip_template,
         "signs": lambda: _signs(L, 18),
         "normal": lambda: rng.normal(size=L).astype(np.float32)}[kind]()
    assert len(t) == L
    buf = T(rng.normal(size=(c, n)).astype(np.float32)).to(cuda_device)
    cuda.reset_launches()
    got = corr_kernel(buf, t)
    assert torch.equal(got, corr_plain(buf, T(t).to(cuda_device)))
    assert cuda.body_launches == {f"corr:{body}": 1}


# family -> (win, mark/fs, space/fs): one symbol of boxcar, Bell-202 and
# C50 tones at 48 kHz
_AFSK = {"imet4": (40, 1200.0 / FS, 2200.0 / FS),
         "c50": (20, 2400.0 / FS, 4800.0 / FS)}


@pytest.mark.parametrize("family", ["imet4", "c50"])
def test_cuda_afsk_matches_twin(cuda_device, family):
    win, fm, fsp = _AFSK[family]
    rng = np.random.default_rng(5)
    audio = T(rng.normal(size=(16, BLOCK)).astype(np.float32)).to(cuda_device)
    atail = T(rng.normal(size=(16, HALO)).astype(np.float32)).to(cuda_device)
    tabs = [T(t).to(cuda_device) for t in afsk_tables(BLOCK, fm, fsp)]
    before = cuda.launches["fused_afsk_frontend"]
    got = fused_afsk_frontend(audio, atail, tabs, win)
    want = fused_afsk_frontend_plain(audio, atail, tabs, win)
    assert cuda.launches["fused_afsk_frontend"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _templates():
    spec = timet4.SPEC
    imet = [spec.sync_chip_template()] + [
        spec.sync_chip_template(bits=np.asarray(b))
        for b in spec.extra["alt_sync_bits"]]
    return [("m10", tm10.SPEC.sync_chip_template())] + [
        (f"imet4-{k}", t) for k, t in enumerate(imet)]


@pytest.mark.parametrize("name,tmpl", _templates(),
                         ids=[n for n, _ in _templates()])
def test_cuda_correlate_syncword_divides_by_l(cuda_device, name, tmpl):
    """On the card the plain correlation also divides by L: on +/-1 chips
    each output is the window sum s over L correctly rounded (float64
    division rounded to float32), and equals the CPU's, not
    s * float32(1/L)."""
    rng = np.random.default_rng(len(tmpl))
    chips = (rng.integers(0, 2, size=(64, 9600)) * 2 - 1).astype(np.float32)
    got = tcorrelator.correlate_syncword(T(chips).to(cuda_device), tmpl).cpu()
    want = (conv1d(T(chips), tmpl).double() / len(tmpl)).float()
    assert torch.equal(got, want)
    assert torch.equal(got, tcorrelator.correlate_syncword(T(chips), tmpl))


# the plain correlation kernel: every family's template length (c50 16,
# imet4 20, ims100 and mrzn1 24, dfm 32, rs41 and m10's alternate 64, m10
# 80) and a run-time length above 80
_PLAIN_CORR_LENGTHS = (16, 20, 24, 32, 64, 80, 100)


def _plain_corr_rows(rng, c, ln, dtype, device, offset=0, pad=0):
    """[c, ln] rows of normal values with +0 and -0 spread through them, as
    a view starting ``offset`` elements into a buffer with ``pad`` extra
    columns a row (so a row stride of ln + pad)."""
    flat = rng.normal(size=c * (ln + pad) + offset).astype(np.float32)
    flat[::5] = 0.0
    flat[2::9] = -0.0
    buf = T(flat).to(device, dtype)
    return buf[offset:].view(c, ln + pad)[:, :ln]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("L", _PLAIN_CORR_LENGTHS)
def test_cuda_plain_corr_bit_equal(cuda_device, L, dtype):
    """The plain correlation kernel equals the plain formula (conv1d / L)
    bit for bit, compared as int32 patterns, on the card and against the
    CPU: rows a multiple of 4 long and not, more than one tile, a row view
    that starts off 16 bytes and one with a row stride of its own; a sign
    template and, at the run-time length, a template of normal taps (which
    a bfloat16 row takes rounded to bfloat16). One launch a call, of the
    body its length names."""
    rng = np.random.default_rng(100 + L)
    t = (rng.normal(size=L) if L == 100 else
         rng.integers(0, 2, size=L) * 2.0 - 1.0).astype(np.float32)
    body = f"plain_corr:{plain_corr_body(L)}"
    for c, ln, offset, pad in ((6, 4096, 0, 0), (3, 3840 * 2 + L + 6, 0, 0),
                               (5, 2001, 0, 0), (4, 5000, 1, 0),
                               (3, 4099, 0, 3), (1, L, 0, 0)):
        x = _plain_corr_rows(rng, c, ln, dtype, cuda_device, offset, pad)
        cuda.reset_launches()
        got = plain_corr(x, t)
        assert cuda.body_launches == {body: 1}
        assert cuda.launches["plain_corr"] == 1
        want = plain_corr_plain(x, t)
        assert torch.equal(_bits(got), _bits(want)), (c, ln, offset, pad)
        cpu = plain_corr_plain(x.cpu(), t)
        assert torch.equal(_bits(got).cpu(), _bits(cpu)), (c, ln, offset, pad)


# the plain filter: (id, taps, stride): RS41's two compiled bodies, run-time
# tap counts even and odd at both strides, a run-time stride and a tap count
# that chains two launches
_PLAIN_FIR_CASES = (("t41-d2", 41, 2), ("t41-d1", 41, 1), ("t20", 20, 1),
                    ("t40-d2", 40, 2), ("t23-d2", 23, 2), ("t7-d3", 7, 3),
                    ("t300-d2-chained", 300, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ntaps,stride", [c[1:] for c in _PLAIN_FIR_CASES],
                         ids=[c[0] for c in _PLAIN_FIR_CASES])
def test_cuda_plain_fir_bit_equal(cuda_device, ntaps, stride, dtype):
    """The plain filter equals window_sum bit for bit, compared as int32
    patterns, on the card (window_sum's eager passes) and against the CPU:
    rows over many tiles, rows not a multiple of 4 long, a row view that
    starts off 16 bytes and one with a row stride of its own, one output a
    row; one launch a call, of the body the taps and stride name (two
    chained launches above 256 taps count as one call). No rows give an
    empty result and launch nothing; apply_windows on a CUDA tensor is
    the same launch."""
    rng = np.random.default_rng(7 * ntaps + stride)
    h = rng.normal(size=ntaps).astype(np.float32)
    body = f"plain_fir:{plain_fir_body(ntaps, stride)}"
    for c, ln, offset, pad in ((6, 9000, 0, 0),
                               (3, stride * 2 * 15 * 256 + ntaps + 5, 0, 0),
                               (5, 2001, 0, 0), (4, 5000, 1, 0),
                               (3, 4099, 0, 3), (3, 4096, 0, 4),
                               (2, ntaps, 0, 0)):
        x = _plain_corr_rows(rng, c, ln, dtype, cuda_device, offset, pad)
        cuda.reset_launches()
        got = plain_fir(x, h, stride)
        assert cuda.body_launches == {body: 1}
        assert got.shape == (c, (ln - ntaps) // stride + 1)
        want = window_sum(x, h, stride)
        assert torch.equal(_bits(got), _bits(want)), (c, ln, offset, pad)
        cpu = window_sum(x.cpu(), h, stride)
        assert torch.equal(_bits(got).cpu(), _bits(cpu)), (c, ln, offset, pad)
    cuda.reset_launches()
    empty = plain_fir(torch.zeros((0, 500), dtype=dtype, device=cuda_device),
                      h, stride)
    assert empty.shape == (0, (500 - ntaps) // stride + 1)
    assert cuda.launches["plain_fir"] == 0
    got = apply_windows(x, h, stride)
    assert cuda.body_launches == {body: 1}
    assert torch.equal(_bits(got), _bits(window_sum(x, h, stride)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_plain_fir_zero_row_sign(cuda_device, dtype):
    """A zero row against all-negative taps: every product is -0, added to
    a +0 accumulator, so the card gives +0 as window_sum does."""
    x = torch.zeros((3, 4000), dtype=dtype, device=cuda_device)
    for ntaps, stride in ((41, 2), (41, 1), (20, 1), (300, 2)):
        neg = -np.ones(ntaps, np.float32)
        got = plain_fir(x, neg, stride)
        assert torch.equal(_bits(got), torch.zeros_like(_bits(got)))
        assert torch.equal(_bits(got), _bits(window_sum(x, neg, stride)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_plain_corr_zero_row_sign(cuda_device, dtype):
    """A zero row against an all-negative template: every product is -0,
    added to a +0 accumulator, so the card gives +0 as conv1d does (a
    first product not added to zero would give -0)."""
    x = torch.zeros((3, 4000), dtype=dtype, device=cuda_device)
    for L in (80, 64, 24):
        got = plain_corr(x, -np.ones(L, np.float32))
        assert torch.equal(_bits(got), torch.zeros_like(_bits(got)))
        assert torch.equal(_bits(got), _bits(plain_corr_plain(x, -np.ones(
            L, np.float32))))


def test_cuda_correlate_syncword_runs_the_kernel(cuda_device, tmp_path):
    """correlate_syncword on the card is one launch of the kernel a
    template (m10's, on a bfloat16 ring), with no copy to the card and no
    synchronizing call."""
    rng = np.random.default_rng(3)
    chips = T((rng.integers(0, 2, size=(16, 9600)) * 2 - 1).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    tmpl = tm10.SPEC.sync_chip_template()
    torch.cuda.synchronize()
    cuda.reset_launches()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("probe.corr"):
            got = tcorrelator.correlate_syncword(chips, tmpl)
        torch.cuda.synchronize()
    assert cuda.body_launches == {"plain_corr:t80": 1}
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    calls = _runtime_calls_in(path, "probe.corr")
    assert not [n for n in calls if n.startswith("cudaMemcpy")
                or n.endswith("Synchronize")], calls
    assert torch.equal(_bits(got), _bits(plain_corr_plain(chips, tmpl)))


def _runtime_calls_in(trace_path, span_name):
    """The CUDA runtime calls that start inside a range named ``span_name``
    in a chrome trace, as names."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("name") == span_name]
    assert spans, f"no {span_name} span in the trace"
    return [e["name"] for e in events
            if e.get("ph") == "X"
            and e.get("cat") == "cuda_runtime"
            and any(a <= e["ts"] < b for a, b in spans)]


def test_cuda_fleet_m10_group_corr_is_two_launches(cuda_device, tmp_path):
    """One step of a bf16 fleet with an m10 group (the benchmark fleet's
    dtype): m10's correlation is exactly two launches of the plain
    correlation kernel (its syncword, L = 80, and its alternate, L = 64),
    and ``sondetpu.corr`` makes no copy to the card and no synchronizing
    call."""
    chans = [FleetChannel(b, s) for b, s in FLEET_PLAN]
    assert "m10" in {s for _, s in FLEET_PLAN}
    fleet = FleetSession(chans, N_BINS, cuda_device, compute_dtype="bf16")
    wide = _fleet_wideband()[:N_BINS * BLOCK]
    wi = T(np.ascontiguousarray(wide.real, np.float32)).to(cuda_device)
    wq = T(np.ascontiguousarray(wide.imag, np.float32)).to(cuda_device)
    fleet.step(wi, wq)                       # warm: builds the library
    torch.cuda.synchronize()
    cuda.reset_launches()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fleet.step(wi, wq)
        torch.cuda.synchronize()
    assert cuda.launches["plain_corr"] == 2
    assert {k: v for k, v in cuda.body_launches.items()
            if k.startswith("plain_corr")} == {"plain_corr:t80": 1,
                                               "plain_corr:t64": 1}
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    calls = _runtime_calls_in(path, "sondetpu.corr")
    assert not [n for n in calls if n.startswith("cudaMemcpy")
                or n.endswith("Synchronize")], calls
    assert sum(n.startswith("cudaLaunch") for n in calls) >= 2, calls


# --- the peak pick -----------------------------------------------------------

# every registered family's peak pick as its pipeline runs it, at the
# default 1-s block and the benchmark's 4-s block; rows: one, seven, the
# fleet's dfm, m10 and rs41 groups and the RS41 cells' channels
FAMILY_PEAKS = [(s, b) for s in SUPPORTED_TYPES for b in (48000, 192000)]
PEAK_ROWS = (1, 7, 204, 614, 1230, 2048)


def _peak_pick_equals_twin(corr, threshold, k, md):
    before = cuda.launches["peak_pick"]
    s, ok = peak_pick(corr, threshold, k, md)
    assert cuda.launches["peak_pick"] == before + 1
    ws, wok = find_frame_starts_plain(corr, threshold, k, md)
    assert s.dtype == torch.int32 and ok.dtype == torch.bool
    assert torch.equal(s, ws) and torch.equal(ok, wok)


@pytest.mark.parametrize("sonde,block", FAMILY_PEAKS)
def test_cuda_peak_pick_matches_twin_at_family_shapes(cuda_device, sonde,
                                                      block):
    """The kernel is torch.equal to the eager twin on the card at the
    family's peak-pick shape (n, k_slots and distance from its pipeline)
    for 1 to 2048 rows: quantized rows with planted ties and peaks at
    float32(threshold) and one ulp either side, under a threshold that
    rounds up and one that rounds down to float32."""
    pipe = tpipe.Pipeline(tpipe.PipelineConfig(sonde=sonde, channels=1,
                                               block_len=block), CPU)
    n, k, md = pipe.peak_shape()
    for c in PEAK_ROWS:
        for seed, threshold in enumerate(THRESHOLDS):
            corr = planted_rows(c, n, md, threshold, 100 * c + seed,
                                cuda_device)
            _peak_pick_equals_twin(corr, threshold, k, md)


@pytest.mark.parametrize("label,n,k,md,kind", EDGE_CASES,
                         ids=[c[0] for c in EDGE_CASES])
def test_cuda_peak_pick_edge_cases(cuda_device, label, n, k, md, kind):
    """The kernel equals the twin on the pick's edges: every candidate
    suppressed before the last round, n not a multiple of the half-window
    and a last window of one column, second candidates that tie or fall on
    the masked column, one-column windows, a window wider than the row,
    rows under the threshold and -inf columns."""
    for c in (1, 7, 33):
        for seed, threshold in enumerate(THRESHOLDS):
            corr = T(edge_case_rows(kind, c, n, seed)).to(cuda_device)
            _peak_pick_equals_twin(corr, threshold, k, md)


def test_cuda_peak_pick_once_a_group_step(cuda_device, tmp_path):
    """``cuda.launches["peak_pick"]`` counts one launch a group step: an
    RS41 step on the kernel route, one on the plain-op route, and a fleet
    step of three groups (rs41, m10, dfm); ``sondetpu.peaks`` copies
    nothing to the card and does not synchronize."""
    for use_pallas in (True, False):
        cfg = tpipe.PipelineConfig(sonde="rs41", channels=8, block_len=BLOCK,
                                   use_pallas=use_pallas, input_dtype="i16")
        pipe = tpipe.Pipeline(cfg, cuda_device)
        blk = _cs16(_rs41_rows(1))
        pipe.step(pipe.init_state(), blk)
        torch.cuda.synchronize()
        cuda.reset_launches()
        pipe.step(pipe.init_state(), blk)
        assert cuda.launches["peak_pick"] == 1, (use_pallas, cuda.launches)
    chans = [FleetChannel(b, s) for b, s in FLEET_PLAN]
    fleet = FleetSession(chans, N_BINS, cuda_device, compute_dtype="bf16")
    assert len(fleet.groups) == 3
    wide = _fleet_wideband()[:N_BINS * BLOCK]
    wi = T(np.ascontiguousarray(wide.real, np.float32)).to(cuda_device)
    wq = T(np.ascontiguousarray(wide.imag, np.float32)).to(cuda_device)
    fleet.step(wi, wq)
    torch.cuda.synchronize()
    cuda.reset_launches()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fleet.step(wi, wq)
        torch.cuda.synchronize()
    assert cuda.launches["peak_pick"] == 3, cuda.launches
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    calls = _runtime_calls_in(path, "sondetpu.peaks")
    assert not [n for n in calls if n.startswith("cudaMemcpy")
                or n.endswith("Synchronize")], calls
    assert sum(n.startswith("cudaLaunch") for n in calls) >= 3, calls


# --- the midpoint DC -----------------------------------------------------------

def _midpoint_equals_twin(x):
    """One launch of the kernel equals the twin on the card: NaN at the same
    rows and every other value bit for bit (the signed zeros too: the
    twin's torch.kthvalue selects by the kernel's key order on the card)."""
    before = cuda.launches["midpoint_dc"]
    got = midpoint_dc(x)
    assert cuda.launches["midpoint_dc"] == before + 1
    want = midpoint_dc_plain(x)
    assert got.dtype == x.dtype and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got[~nan].view(bits), want[~nan].view(bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [48000, 191999, 10001, 7, 2, 1])
def test_cuda_midpoint_dc_matches_twin(cuda_device, n, dtype):
    """The cases of tests/test_torch_pipeline.py::test_midpoint_dc_equals_
    jnp_quantile on the card: rows of seeded noise at many scales, rows of
    integer ties, a constant row and a row holding a NaN."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(64, n))
         * rng.uniform(1e-3, 1e3, size=(64, 1))).astype(np.float32)
    x[:8] = np.round(x[:8])
    x[8] = 0.25
    x[9, n // 2] = np.nan
    _midpoint_equals_twin(T(x).to(cuda_device, dtype))


def _tied_rows(n=192000):
    """Rows whose ranks fall in more equal keys than shared memory holds,
    so that the select goes on over the row to the last key bit: 190,000
    equal values and a few others (the ranks in the tie), the tie at the
    10th percentile alone, and two ties, one a quantile each."""
    rng = np.random.default_rng(3)
    x = np.full((4, n), 0.5, np.float32)
    x[0, :2000] = rng.normal(size=2000)
    x[1, :n // 2] = -1.0
    x[1, n // 2:] = rng.normal(size=n - n // 2)
    x[2, :n // 2] = -0.75
    x[2, n // 2:] = 0.75
    x[3, :1000] = rng.normal(size=1000)
    x[3, 1000:2000] = 0.5000001
    return x


def _inf_zero_rows(n=1001):
    """Rows with -inf, +inf, -0 and +0 at the selected ranks (n = 1001:
    ranks 100 and 900, weight 0), and one where a quantile's two ranks
    are -inf and +inf (n = 1002: weight 0.1 between them)."""
    x = np.zeros((5, n), np.float32)
    x[0, :200] = -np.inf
    x[0, 800:] = np.inf
    x[1, :500] = -0.0
    x[2] = np.where(np.arange(n) % 2, -0.0, 0.0)
    x[3, :101] = -np.inf
    x[3, 101:] = np.inf
    x[4, :899] = -0.0
    x[4, 899:] = np.inf
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_midpoint_dc_edge_rows(cuda_device, dtype):
    """The kernel equals the twin on rows too tied for shared memory (the
    passes over the row that follow), on infinities and signed zeros at the
    ranks, and on rows that start off the kernel's 32-byte chunks: a view
    of a wider buffer's rows, and the same rows copied side by side."""
    _midpoint_equals_twin(T(_tied_rows()).to(cuda_device, dtype))
    for n in (1001, 1002):
        _midpoint_equals_twin(T(_inf_zero_rows(n)).to(cuda_device, dtype))
    rng = np.random.default_rng(7)
    wide = T(rng.normal(size=(33, 30010)).astype(np.float32))
    wide = wide.to(cuda_device, dtype)
    _midpoint_equals_twin(wide[:, 3:])
    _midpoint_equals_twin(wide[:, 3:].contiguous())


def test_cuda_midpoint_dc_of_the_ims100_metric(cuda_device):
    """The kernel equals the twin on K7's metric of ims100 blocks at the
    benchmark's shape, [2048, 192000] (8 noisy channels, each on 256 rows),
    in float32 and in bfloat16."""
    cfg = tpipe.PipelineConfig(sonde="ims100", channels=2048,
                               block_len=4 * BLOCK, use_pallas=True,
                               input_dtype="i16")
    pipe = tpipe.Pipeline(cfg, cuda_device)
    qi, qq = _cs16(_dualtone_rows("ims100", 4))
    scale = float(np.float32(1.0 / 32768.0))
    i, q = (T(p).to(cuda_device).repeat(256, 1).to(torch.float32) * scale
            for p in (qi, qq))
    st = pipe.init_state()
    met = fused_dualtone_frontend(
        i, q, st.chan_tail_i, st.chan_tail_q, pipe._chan_taps,
        pipe._mix_cos, pipe._mix_sin, pipe._nb,
        skip_chanfilt=pipe._skip_chanfilt)[0]
    del i, q
    assert met.shape == (2048, 4 * BLOCK) and met.dtype == torch.float32
    _midpoint_equals_twin(met)
    _midpoint_equals_twin(met.to(torch.bfloat16))


def test_cuda_midpoint_dc_refuses_what_the_twin_refuses(cuda_device):
    """A tensor whose rows do not hold their elements side by side, a
    float16, float64 or one-dimensional tensor raises on the card as on the
    CPU, and launches nothing."""
    x = torch.zeros((8, 64), device=cuda_device)
    before = cuda.launches["midpoint_dc"]
    with pytest.raises(ValueError, match="contiguous"):
        midpoint_dc(x.t())
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="dtype"):
            midpoint_dc(x.to(dtype))
    with pytest.raises(ValueError, match=r"\[C, n\]"):
        midpoint_dc(x[0])
    assert cuda.launches["midpoint_dc"] == before


@pytest.mark.parametrize("use_pallas", [True, False])
def test_cuda_midpoint_once_an_ims100_step(cuda_device, monkeypatch,
                                           tmp_path, use_pallas):
    """``cuda.launches["midpoint_dc"]`` counts one launch an ims100 step, on
    the kernel route and on the plain-op route; no step calls
    torch.kthvalue; ``sondetpu.midpoint`` copies nothing to the card and
    does not synchronize."""
    cfg = tpipe.PipelineConfig(sonde="ims100", channels=8, block_len=BLOCK,
                               use_pallas=use_pallas, input_dtype="i16")
    pipe = tpipe.Pipeline(cfg, cuda_device)
    assert pipe._midpoint and pipe._plain != use_pallas
    blk = _cs16(_dualtone_rows("ims100", 1))
    pipe.step(pipe.init_state(), blk)
    torch.cuda.synchronize()

    def refuse(*args, **kwargs):
        raise AssertionError("torch.kthvalue called by a step on the card")

    monkeypatch.setattr(torch, "kthvalue", refuse)
    cuda.reset_launches()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        pipe.step(pipe.init_state(), blk)
        torch.cuda.synchronize()
    assert cuda.launches["midpoint_dc"] == 1, cuda.launches
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    calls = _runtime_calls_in(path, "sondetpu.midpoint")
    assert not [n for n in calls if n.startswith("cudaMemcpy")
                or n.endswith("Synchronize")], calls
    assert sum(n.startswith("cudaLaunch") for n in calls) == 1, calls


# --- the command line's device pieces ----------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "i16"])
def test_cuda_resampler_matches_cpu(cuda_device, dtype):
    """The device resampler on the card against the same op on the CPU
    over three blocks: the same products and sums in the same order, each
    rounded once (CUDA's elementwise multiply and add do not fuse)."""
    gpu = DeviceStreamingResampler(50000.0, 48000.0, 48000, cuda_device,
                                   input_dtype=dtype)
    cpu = DeviceStreamingResampler(50000.0, 48000.0, 48000, "cpu",
                                   input_dtype=dtype)
    rng = np.random.default_rng(6)
    sg, sc = gpu.init_state(), cpu.init_state()
    for _ in range(3):
        x = rng.normal(scale=0.3, size=(2, gpu.in_len))
        if dtype == "i16":
            x = np.round(x * 32767).astype(np.int16)
        else:
            x = x.astype(np.float32)
        sg, gi, gq = gpu(sg, x[0], x[1])
        sc, ci, cq = cpu(sc, x[0], x[1])
        assert gi.device.type == "cuda"
        assert torch.equal(gi.cpu(), ci) and torch.equal(gq.cpu(), cq)


def test_cuda_cli_decode_equals_cpu(cuda_device, tmp_path):
    """``decode`` of rs41 cs16 files on the card (from the file, with
    --stream, with --rate 50000, and at 8 channels with device dequant and
    use_pallas) writes the JSONL, GPX and PTU bytes of the same runs on the
    CPU."""
    from sondetpu_torch.cli import main as cli
    from sondetpu_torch.cli.config import FrameworkConfig

    iq = {}
    for fs in ("48000", "50000"):
        iq[fs] = str(tmp_path / f"x{fs}.cs16")
        assert cli.main(["synth", "--sonde", "rs41", "--frames", "8",
                         "--fs", fs, "--format", "cs16",
                         "--out", iq[fs]]) == 0
    cfg = str(tmp_path / "cfg.json")
    FrameworkConfig(device_dequant=True, use_pallas=True).save(cfg)
    cases = (["--iq", iq["48000"]], ["--iq", iq["48000"], "--stream"],
             ["--iq", iq["50000"], "--rate", "50000"],
             ["--iq", iq["48000"], "--config", cfg, "--channels", "8"])
    for k, case in enumerate(cases):
        outs = {}
        for dev in ("cuda", "cpu"):
            d = tmp_path / f"{dev}{k}"
            d.mkdir()
            rc = cli.main(["decode", "--sonde", "rs41", "--ref-epoch",
                           "1.7e9", "--device", dev,
                           "--jsonl", str(d / "o.jsonl"),
                           "--gpx", str(d / "o.gpx"),
                           "--ptu", str(d / "o.csv"), *case])
            assert rc == 0
            outs[dev] = [(d / f).read_bytes()
                         for f in ("o.jsonl", "o.gpx", "o.csv")]
        assert outs["cuda"] == outs["cpu"], case
        assert outs["cuda"][0].count(b"\n") >= 4, case
