"""Each kernel module of the port against the JAX package's Pallas kernel.

On the CPU every wrapper runs its plain torch twin, and the JAX kernels run
in interpret mode, as tests/test_pallas.py runs them. The same
numpy-seeded inputs go to both. The CUDA kernels themselves are compared
with their twins on the card (tests/test_torch_cuda.py, which imports no
jax, and chip_smoke.py).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sondetpu.dsp.fir import design_lowpass
from sondetpu.pallas.corr import corr_kernel as jax_corr_kernel
from sondetpu.pallas.frontend import HALO as JAX_HALO
from sondetpu.pallas.frontend import fast_atan2 as jax_fast_atan2
from sondetpu.pallas.frontend import frontend_chunk
from sondetpu.pallas.frontend import fused_frontend as jax_fused_frontend
from sondetpu.pallas.syndrome import rs_clean_flags_pallas
from sondetpu.sondes.rs41 import SPEC, RS41Modulator, RS41Truth, RS41XModulator
from sondetpu.sync.correlator import correlate_syncword as jax_correlate_syncword
from sondetpu.sync.correlator import find_frame_starts as jax_find_frame_starts
from sondetpu.sync.timing import oerder_meyr_tau as jax_oerder_meyr_tau
from sondetpu_torch.fec.rs import ReedSolomon
from sondetpu_torch.fec.syndrome import layout_matrix
from sondetpu_torch.kernels import cuda
from sondetpu_torch.kernels.corr import (corr_body, corr_kernel, corr_plain,
                                         is_sign_template)
from sondetpu_torch.dsp.fir import apply_windows
from sondetpu_torch.kernels.frontend import (HALO, WALK_MAX, fast_atan2,
                                             frontend_walk, fused_frontend,
                                             fused_frontend_plain,
                                             is_delay_taps)
from sondetpu_torch.kernels.peak_cases import (EDGE_CASES, THRESHOLDS,
                                               edge_case_rows, planted_rows)
from sondetpu_torch.kernels.peak_pick import (PLAN_BYTES, peak_pick,
                                              shared_bytes)
from sondetpu_torch.kernels.syndrome import (pack_syndrome_columns,
                                             rs_clean_flags_kernel,
                                             rs_clean_plain, syndrome_body)
from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig
from sondetpu_torch.sondes import SUPPORTED_TYPES
from sondetpu_torch.sync.correlator import find_frame_starts
from sondetpu_torch.sync.timing import oerder_meyr_tau, spectral_line_tables
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

FS, DEV, NTAPS = 48000.0, 2400.0, 41
RS = SPEC.extra["rs"]


def _frontend_inputs(seed, c, n, decim):
    rng = np.random.default_rng(seed)
    i, q = (rng.normal(size=(c, n)).astype(np.float32) for _ in range(2))
    ti, tq = (rng.normal(size=(c, HALO)).astype(np.float32) for _ in range(2))
    ct = design_lowpass(5000.0, FS, NTAPS)
    mt = design_lowpass(2640.0, FS / decim, NTAPS)
    scale = np.float32(FS / decim / (2 * np.pi * DEV))
    return i, q, ti, tq, ct, mt, scale


def test_fast_atan2_matches_jax():
    rng = np.random.default_rng(0)
    y = np.concatenate([rng.normal(size=4000), [0.0, -0.0, 1.0, -1.0, 0.0]])
    x = np.concatenate([rng.normal(size=4000), [0.0, 1.0, 0.0, -1.0, -1.0]])
    y, x = y.astype(np.float32), x.astype(np.float32)
    want = np.asarray(jax_fast_atan2(jnp.asarray(y), jnp.asarray(x)))
    got = fast_atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.arctan2(y, x), atol=2e-5)


@pytest.mark.parametrize("decim", [1, 2])
@pytest.mark.parametrize("n", [12800, 4800])   # chunk multiple and not
def test_fused_frontend_matches_pallas(decim, n):
    """filt within 3e-4 (as tests/test_pallas.py: XLA and torch sum the
    taps in different orders), dc within 2e-5, tails exact."""
    assert HALO == JAX_HALO
    i, q, ti, tq, ct, mt, scale = _frontend_inputs(decim + n, 8, n, decim)
    want = jax_fused_frontend(
        jnp.asarray(i), jnp.asarray(q), jnp.asarray(ti), jnp.asarray(tq),
        jnp.asarray(ct[None]), jnp.asarray(mt[None]), jnp.asarray([[scale]]),
        ntaps=NTAPS, decim=decim, chunk=frontend_chunk(n), dc_block=True,
        interpret=True)
    got = fused_frontend(*(torch.from_numpy(x) for x in (i, q, ti, tq)),
                         ct, mt, float(scale), decim, True)
    assert got[0].shape == (8, n // decim)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=3e-4)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=2e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_fused_frontend_stream_continuity():
    """Two consecutive blocks with the carried tails equal one block of
    twice the length (the virtual stream reads the tail at negative
    indices), dc_block off."""
    i, q, ti, tq, ct, mt, scale = _frontend_inputs(7, 8, 9600, 2)
    t = [torch.from_numpy(x) for x in (i, q, ti, tq)]
    whole = fused_frontend_plain(*t, ct, mt, float(scale), 2, False)
    a = fused_frontend_plain(t[0][:, :4800], t[1][:, :4800], t[2], t[3],
                             ct, mt, float(scale), 2, False)
    b = fused_frontend_plain(t[0][:, 4800:], t[1][:, 4800:], a[1], a[2],
                             ct, mt, float(scale), 2, False)
    torch.testing.assert_close(torch.cat([a[0], b[0]], -1), whole[0],
                               rtol=0, atol=0)
    torch.testing.assert_close((a[3] + b[3]) / 2, whole[3], rtol=0, atol=1e-6)


def _delta(t, dtype=np.float32):
    h = np.zeros(t, dtype)
    h[-1] = 1.0
    return h


@pytest.mark.parametrize("taps,want", [
    (_delta(41), True), (_delta(33), True), (_delta(41, np.float64), True),
    (np.where(_delta(41) == 0, -0.0, 1.0).astype(np.float32), True),
    (2.0 * _delta(41), False), (np.roll(_delta(41), -1), False),
    (_delta(41) + np.float32(1e-12) * (np.arange(41) == 3), False),
    (np.where(_delta(41) == 1, np.nextafter(np.float32(1), np.float32(2)),
              0).astype(np.float32), False),
    (np.zeros(41, np.float32), False),
    (design_lowpass(2640.0, FS, NTAPS), False),
], ids=["delta41", "delta33", "delta-f64", "negative-zeros", "scaled",
        "shifted", "noisy", "one-ulp-high", "zeros", "lowpass"])
def test_is_delay_taps(taps, want):
    """The host check that picks the front end's identity body: true only
    for an exact [0, ..., 0, 1]."""
    assert is_delay_taps(taps) is want


@pytest.mark.parametrize("channels,tiles,sms,want", [
    (2048, 86, 132, (8, 11)),     # [2048, 192000] decim 1 on an H100
    (2048, 43, 132, (8, 6)),      # RS41's decim 2
    (256, 86, 132, (5, 18)),
    (2048, 3, 132, (1, 3)),
    (8, 86, 132, (1, 86)),        # too few blocks to walk: a block a tile
    (1, 1, 132, (1, 1)),
    (2048, 86, 66, (8, 11)),
], ids=["m10-fallback", "rs41", "c256", "short-rows", "c8", "one-tile",
        "half-card"])
def test_frontend_walk(channels, tiles, sms, want):
    """The host's choice of tiles a block walks for K1's walking bodies,
    and the kernel's even split of each row among its blocks: every block
    takes between one tile and the walk, and the blocks cover the row."""
    walk = frontend_walk(channels, tiles, sms)
    blocks = -(-tiles // walk)          # the kernel's grid: blocks a row
    assert (walk, blocks) == want
    assert 1 <= walk <= WALK_MAX
    bounds = [b * tiles // blocks for b in range(blocks + 1)]
    sizes = np.diff(bounds)
    assert bounds[0] == 0 and bounds[-1] == tiles
    assert sizes.min() >= 1 and sizes.max() <= walk


def test_delay_taps_fir_is_the_delayed_input():
    """What the identity body relies on: the tap loop over [0, ..., 0, 1],
    every product and sum rounded alone, returns the input T - 1 samples
    earlier exactly (finite input, zeros and negatives included)."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(8, 2000 + 40)).astype(np.float32) * 1e3
    x[:, ::7] = 0.0
    x[:, 1::11] = -0.0
    xt = torch.from_numpy(x)
    got = apply_windows(xt, _delta(41))
    assert torch.equal(got, xt[:, :2000])


def test_corr_matches_pallas():
    rng = np.random.default_rng(1)
    buf = rng.normal(size=(8, 7360)).astype(np.float32)
    tmpl = SPEC.sync_chip_template()
    want = np.asarray(jax_corr_kernel(jnp.asarray(buf), jnp.asarray(tmpl[None]),
                                      interpret=True))
    got = corr_kernel(torch.from_numpy(buf), torch.from_numpy(tmpl))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        corr_plain(torch.from_numpy(buf), torch.from_numpy(tmpl)).numpy(),
        got.numpy())
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_correlate_syncword(jnp.asarray(buf), tmpl)),
        atol=1e-5)


def _signs(L, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, L) * 2 - 1).astype(dtype)


@pytest.mark.parametrize("tmpl,want", [
    (SPEC.sync_chip_template(), True), (_signs(32), True),
    (_signs(64, dtype=np.float64), True), (np.ones(1, np.float32), True),
    (np.where(_signs(64) > 0, 1.0, 0.0).astype(np.float32), False),
    (np.where(_signs(64) > 0, 1.0, -0.0).astype(np.float32), False),
    (np.full(64, 0.5, np.float32), False),
    (np.where(np.arange(64) == 5, np.nan, _signs(64)).astype(np.float32),
     False),
    (np.where(np.arange(64) == 7, np.nextafter(np.float32(1), np.float32(2)),
              _signs(64)).astype(np.float32), False),
    (np.where(np.arange(64) < 32, _signs(64), 0.5).astype(np.float32), False),
    (np.zeros(0, np.float32), False),
    (_signs(64).reshape(8, 8), False),
], ids=["rs41", "signs32", "signs-f64", "one", "zeros-and-ones",
        "negative-zero", "halves", "nan", "one-ulp-high", "mixed", "empty",
        "2-d"])
def test_is_sign_template(tmpl, want):
    """The host check that picks the correlator's sign body: true only when
    every tap is exactly +1.0 or -1.0 in float32."""
    assert is_sign_template(tmpl) is want


@pytest.mark.parametrize("length,sign,want", [
    (64, True, "sign_l64"), (32, True, "sign_l32"), (48, True,
                                                     "sign_runtime_l"),
    (1, True, "sign_runtime_l"), (64, False, "rounded_l64"),
    (32, False, "rounded_l32"), (20, False, "rounded_runtime_l"),
    (65, True, "long_l"), (80, False, "long_l"), (2048, True, "long_l"),
])
def test_corr_body(length, sign, want):
    """The correlator body for a template: compiled L = 64 or 32, L at run
    time up to 64, the shared-template body above."""
    assert corr_body(length, sign) == want


def test_sign_template_products_are_exact():
    """What the sign body relies on: t * x for t = +/-1 is x or -x exactly
    (zeros, subnormals, huge and non-finite values included), so a fused
    multiply-add rounds once the sum the twin rounds."""
    rng = np.random.default_rng(15)
    x = np.concatenate([rng.normal(size=4000) * 10.0 ** rng.integers(
        -40, 38, 4000), [0.0, -0.0, 1e-45, -1e-45, 3e38, np.inf, -np.inf]]
    ).astype(np.float32)
    for t in (np.float32(1.0), np.float32(-1.0)):
        got = (torch.from_numpy(x) * torch.tensor(t)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      (x if t > 0 else -x).view(np.uint32))


def test_corr_kernel_takes_a_host_template():
    """The pipeline hands the correlator its NumPy template: the same
    result as a tensor template."""
    rng = np.random.default_rng(16)
    buf = torch.from_numpy(rng.normal(size=(4, 900)).astype(np.float32))
    t = SPEC.sync_chip_template()
    assert torch.equal(corr_kernel(buf, t),
                       corr_kernel(buf, torch.from_numpy(t)))


def _frames_clean_and_corrupt(seed, rows, fb=320):
    """[rows, fb] RS41 frames (320 standard, 518 extended); about half
    carry 1-3 corrupted bytes in the RS-covered region. Returns (frames,
    clean truth)."""
    rng = np.random.default_rng(seed)
    mod = RS41Modulator() if fb == 320 else RS41XModulator()
    base = np.stack([mod.build_frame(RS41Truth(frame_no=k), fb != 320)
                     for k in range(8)])
    assert base.shape == (8, fb)
    return _corrupt(rng, base[rng.integers(0, 8, size=rows)],
                    np.arange(8, fb))


def _corrupt(rng, frames, covered):
    """XOR 1-3 random bytes of ``covered`` into about half the rows (fewer
    errors than the code's distance, so each such row is dirty)."""
    bad = rng.random(len(frames)) < 0.5
    for r in np.nonzero(bad)[0]:
        pos = rng.choice(covered, size=rng.integers(1, 4), replace=False)
        frames[r, pos] ^= rng.integers(1, 256, size=pos.size).astype(np.uint8)
    return frames, ~bad


# layouts beside RS41's: a frame of 61 bytes (not a multiple of 4) with one
# 8-root codeword (64 columns), and one of 267 bytes with two interleaved
# 32-root codewords (512 columns, the kernel's c512 body)
EDGE_LAYOUTS = {
    "odd61": (61, {"data_start": 9, "parity_start": 1, "nroots": 8,
                   "interleave": 1, "fcr": 0, "prim": 0x11D}),
    "c512": (267, {"data_start": 66, "parity_start": 2, "nroots": 32,
                   "interleave": 2, "fcr": 0, "prim": 0x11D}),
}


def _layout_frames(seed, rows, fb, layout):
    """[rows, fb] frames of random data with each interleaved codeword's
    parity filled in by the RS encoder, about half then corrupted."""
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
    return _corrupt(rng, frames, np.concatenate(covered))


def _layout_case(name, seed, rows):
    """(frames, truth, fb, layout) of a named layout: rs41 (320 B), rs41x
    (518 B) or one of EDGE_LAYOUTS."""
    if name in EDGE_LAYOUTS:
        fb, layout = EDGE_LAYOUTS[name]
        return (*_layout_frames(seed, rows, fb, layout), fb, layout)
    fb = 320 if name == "rs41" else 518
    return (*_frames_clean_and_corrupt(seed, rows, fb), fb, RS)


@pytest.mark.parametrize("fb", [320, 518], ids=["rs41", "rs41x"])
def test_rs_clean_matches_pallas(fb):
    frames, truth = _frames_clean_and_corrupt(2, 40, fb)
    want = np.asarray(rs_clean_flags_pallas(jnp.asarray(frames.reshape(5, 8, fb)),
                                            RS, interpret=True))
    got = rs_clean_flags_kernel(torch.from_numpy(frames.reshape(5, 8, fb)), RS)
    assert got.dtype == torch.bool and got.shape == (5, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().reshape(-1), truth)


def _column_parity_clean(frames, wt):
    """The CUDA kernel's word loop in NumPy: the frames as little-endian
    words (zero past the row), acc[c] = XOR_k (F[k] & WT[k, c]), clean iff
    every popcount(acc[c]) is even."""
    rows, fb = frames.shape
    nw = wt.shape[0]
    padded = np.zeros((rows, 4 * nw), np.uint8)
    padded[:, :fb] = frames
    words = padded.view("<u4")
    acc = np.zeros((rows, wt.shape[1]), np.uint32)
    for k in range(nw):
        acc ^= words[:, k:k + 1] & wt[k][None, :]
    return ((np.bitwise_count(acc) & 1) == 0).all(axis=1)


@pytest.mark.parametrize("name,body", [
    ("rs41", "c384"), ("rs41x", "c384"), ("odd61", "c384"),
    ("c512", "c512")])
def test_rs_clean_column_parity_form(name, body):
    """The CUDA kernel's algorithm over pack_syndrome_columns, run in
    NumPy, equals the twin's float product and the truth, at 320 and 518
    bytes and on the edge layouts."""
    frames, truth, fb, layout = _layout_case(name, 3, 24)
    w = layout_matrix(fb, layout)
    assert syndrome_body(w.shape[1]) == body
    wt = pack_syndrome_columns(w)
    width = int(body[1:])
    assert wt.shape == (-(-fb // 4), width) and wt.dtype == np.uint32
    unpacked = (wt[:, None, :] >> np.arange(32, dtype=np.uint32)[None, :, None]
                ) & 1
    unpacked = unpacked.reshape(-1, width)
    np.testing.assert_array_equal(unpacked[:8 * fb, :w.shape[1]],
                                  w.astype(np.uint32))
    assert not unpacked[8 * fb:].any() and not unpacked[:, w.shape[1]:].any()
    np.testing.assert_array_equal(_column_parity_clean(frames, wt), truth)
    np.testing.assert_array_equal(
        rs_clean_plain(torch.from_numpy(frames), layout).numpy(), truth)


def test_syndrome_body_refuses_wide_matrices():
    assert syndrome_body(1) == "c384" and syndrome_body(385) == "c512"
    for bad in (0, 513):
        with pytest.raises(ValueError, match="syndrome columns"):
            syndrome_body(bad)


def _quantized_corr():
    rng = np.random.default_rng(4)
    corr = np.round(rng.uniform(-1, 1, size=(8, 7297)) * 4) / 4
    corr[:, ::700] = 0.9
    return corr.astype(np.float32)


def _peak_pick_matches_jax(corr, threshold, k, md):
    ws, wok = jax_find_frame_starts(jnp.asarray(corr), threshold, k, md)
    gs, gok = find_frame_starts(torch.from_numpy(corr), threshold, k, md)
    assert gs.dtype == torch.int32 and gok.dtype == torch.bool
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gok.numpy(), np.asarray(wok))


# every registered family's peak pick as its pipeline runs it, at the
# default 1-s block and at the benchmark's 4-s block
FAMILY_PEAKS = [(s, b) for s in SUPPORTED_TYPES for b in (48000, 192000)]


@pytest.mark.parametrize("case", ["k3_md640", "k9_md64"]
                         + [f"{s}_{b}" for s, b in FAMILY_PEAKS])
def test_find_frame_starts_matches_jax(case):
    """Exact starts and ok flags, including ties (quantized values) and
    peaks below the threshold: on quantized rows, and at each family's
    peak-pick shape (n, k_slots and the distance from its pipeline) on
    rows with planted ties and peaks at float32(threshold) and one ulp
    either side, under a threshold that rounds up and one that rounds
    down to float32."""
    if case.startswith("k"):
        k, md = (3, 640) if case == "k3_md640" else (9, 64)
        _peak_pick_matches_jax(_quantized_corr(), 0.6, k, md)
        return
    sonde, block = case.rsplit("_", 1)
    pipe = Pipeline(PipelineConfig(sonde=sonde, channels=1,
                                   block_len=int(block)), torch.device("cpu"))
    n, k, md = pipe.peak_shape()
    for seed, threshold in enumerate(THRESHOLDS):
        corr = planted_rows(3, n, md, threshold, seed).numpy()
        _peak_pick_matches_jax(corr, threshold, k, md)


@pytest.mark.parametrize("label,n,k,md,kind", EDGE_CASES,
                         ids=[c[0] for c in EDGE_CASES])
def test_find_frame_starts_edge_cases_match_jax(label, n, k, md, kind):
    """The edges of the pick against the original: every candidate
    suppressed before the last round, the -inf padding of a row that is
    not a multiple of the half-window (down to a last window of one
    column), second candidates that tie with the first or fall on the
    masked column, one-column windows, a window wider than the row and
    -inf columns."""
    for seed, threshold in enumerate(THRESHOLDS):
        _peak_pick_matches_jax(edge_case_rows(kind, 4, n, seed), threshold,
                               k, md)


def test_peak_pick_refuses_other_dtypes_and_plans():
    """float32 only, at least one pick, and a candidate set inside the
    kernel's shared memory: refused alike on every device, with no
    fallback."""
    corr = torch.from_numpy(_quantized_corr())
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(TypeError, match="expected float32"):
            peak_pick(corr.to(dtype), 0.6, 3, 640)
    with pytest.raises(ValueError, match="max_peaks"):
        peak_pick(corr, 0.6, 0, 640)
    with pytest.raises(ValueError, match="shared memory"):
        peak_pick(corr, 0.6, 3, 2)
    assert shared_bytes(7297, 3, 2) > PLAN_BYTES >= shared_bytes(7297, 3, 6)
    # the largest plan a registered family's 4-s block takes: c50's
    pipe = Pipeline(PipelineConfig(sonde="c50", channels=1, block_len=192000),
                    torch.device("cpu"))
    assert shared_bytes(*pipe.peak_shape()) < PLAN_BYTES / 2


def test_oerder_meyr_tau_matches_jax():
    rng = np.random.default_rng(5)
    x = np.repeat(rng.choice([-1.0, 1.0], size=(8, 4800)), 5, axis=-1)
    x = np.roll(x, 3, axis=-1).astype(np.float32) + 0.05 * rng.normal(
        size=(8, 24000)).astype(np.float32)
    want = np.asarray(jax_oerder_meyr_tau(jnp.asarray(x), 5.0))
    cw, sw = (torch.from_numpy(t) for t in spectral_line_tables(24000, 5.0))
    got = oerder_meyr_tau(torch.from_numpy(x), 5.0, cw, sw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_wrappers_reject_unsupported_devices():
    """A tensor on neither the CPU nor a CUDA device is refused; nothing
    falls back."""
    meta = torch.empty((8, 512), device="meta")
    taps = design_lowpass(5000.0, FS, NTAPS)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_frontend(meta, meta, meta[:, :HALO], meta[:, :HALO], taps,
                       taps, 1.0, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        corr_kernel(meta, torch.empty(64, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        rs_clean_flags_kernel(torch.empty((4, 320), dtype=torch.uint8,
                                          device="meta"), RS)
    with pytest.raises(ValueError, match="unsupported device"):
        peak_pick(meta, 0.6, 3, 64)
    with pytest.raises(ValueError, match="decim"):
        fused_frontend_plain(torch.zeros(8, 512), torch.zeros(8, 512),
                             torch.zeros(8, HALO), torch.zeros(8, HALO),
                             taps, taps, 1.0, 3)


def test_check_tensor_refuses_bad_arguments():
    cpu = torch.device("cpu")
    x = torch.zeros((4, 6))
    cuda.check_tensor("x", x, torch.float32, cpu, (4, None))
    for bad, exc in ((x.t(), ValueError), (x.double(), TypeError),
                     (x[:, :3].contiguous(), None)):
        if exc is None:
            with pytest.raises(ValueError, match="shape"):
                cuda.check_tensor("x", bad, torch.float32, cpu, (4, 6))
        else:
            with pytest.raises(exc):
                cuda.check_tensor("x", bad, torch.float32, cpu, (None, None))
    with pytest.raises(ValueError, match="expected meta"):
        cuda.check_tensor("x", x, torch.float32, torch.device("meta"))
    with pytest.raises(TypeError):
        cuda.check_tensor("x", np.zeros(3), torch.float32, cpu)


def test_kernel_library_is_named_by_its_sources():
    """The build is keyed by a hash of csrc/ and the flags, under the
    ignored build/ directory; nothing is built at import."""
    path = cuda.library_path()
    assert path.startswith(cuda.BUILD_DIR)
    assert cuda.BUILD_DIR.endswith("build/sondetpu_torch")
    assert {p.rsplit("/", 1)[-1] for p in cuda._sources()} >= {
        "frontend.cu", "corr.cu", "syndrome.cu", "common.cuh"}
    assert path == cuda.library_path()
    assert cuda._lib is None or torch.cuda.is_available()


@pytest.mark.parametrize("source", cuda._sources(),
                         ids=lambda p: p.rsplit("/", 1)[-1])
def test_kernel_library_has_one_build(source):
    """Every kernel is built one way, as it ships: no source holds a
    preprocessor conditional, and the flags are a constant that defines
    no macro."""
    with open(source) as f:
        conditionals = [line for line in f
                        if re.match(r"\s*#\s*(if|ifdef|ifndef|elif)\b", line)]
    assert conditionals == []
    assert isinstance(cuda.NVCC_FLAGS, tuple)
    assert not any(flag.startswith("-D") for flag in cuda.NVCC_FLAGS)
