"""The port's PFB channelizer and its kernel modules against the JAX package.

On the CPU the wrappers run their plain torch twins, and the JAX Pallas
kernels run in interpret mode, as tests/test_pfb_pallas.py runs them. The
same numpy-seeded inputs go to both. The CUDA kernels themselves are held
to their twins on the card (the tests at the end, skipped without a CUDA
device, and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sondetpu.dsp.channelizer import PFBChannelizer as JaxPFB
from sondetpu.dsp.channelizer import bin_and_offset as jax_bin_and_offset
from sondetpu.pallas.pfb import (dft_perm, dft_weights, pfb_dft_perm,
                                 pfb_fir_stream as jax_fir_stream,
                                 pfb_fir_timemajor as jax_fir_timemajor,
                                 tile_shape)
from sondetpu_torch.dsp.channelizer import PFBChannelizer, bin_and_offset
from sondetpu_torch.kernels import cuda
from sondetpu_torch.kernels.pfb import (pfb_dft, pfb_dft_plain, pfb_fir_plain,
                                        pfb_fir_stream, pfb_fir_timemajor,
                                        twiddle_table)
from sondetpu_torch.kernels.pfb_cases import (BF16_EDGE_CASES,
                                              bf16_edge_planes)
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

T = torch.from_numpy


def _planes(seed, *shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("n", [256, 512])
def test_pfb_fir_twins_match_pallas(n):
    """K4 (split tail and block) and K5 (pre-concatenated) twins against
    the Pallas kernels at m = 64 rows, two column tiles at N = 512:
    atol 1e-6 (XLA may contract the tap products into FMAs; the twin
    rounds each one). K4 and K5 agree exactly."""
    m = 64
    x_i, x_q = _planes(n, m, n)
    t_i, t_q = _planes(n + 1, 8, n)
    hcol = JaxPFB(n)._hcol
    tm, tn = tile_shape(m, n, 8)
    tn = min(tn, 256)
    want = jax_fir_stream(*(jnp.asarray(a) for a in (x_i, x_q, t_i, t_q, hcol)),
                          8, tm, tn, interpret=True)
    got = pfb_fir_stream(T(x_i), T(x_q), T(t_i), T(t_q), T(hcol))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    vv_i, vv_q = np.concatenate([t_i, x_i]), np.concatenate([t_q, x_q])
    want = jax_fir_timemajor(jnp.asarray(vv_i), jnp.asarray(vv_q),
                             jnp.asarray(hcol), 8, tm, tn, interpret=True)
    got_tm = pfb_fir_timemajor(T(vv_i), T(vv_q), T(hcol))
    for g, w, s in zip(got_tm, want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
        assert torch.equal(g, s)


def test_pfb_dft_twin_matches_pallas():
    """K6's twin (natural channel order) against the Pallas DFT at N = 512,
    GR = 4, through its row permutation: y_port[k] == y_tpu[dft_perm[k]],
    atol 1e-5 x max|y|."""
    n, m, gr = 512, 64, 4
    u_i, u_q = _planes(7, m, n)
    wc, ws = dft_weights(n, gr)
    want = pfb_dft_perm(jnp.asarray(u_i), jnp.asarray(u_q), jnp.asarray(wc),
                        jnp.asarray(ws), gr, 32, interpret=True)
    got = pfb_dft(T(u_i), T(u_q))
    perm = dft_perm(n, gr)
    for g, w in zip(got, want):
        w = np.asarray(w)[perm]
        assert g.shape == (n, m)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_pfb_dft_twin_is_the_dft():
    """The twin is sum_j u[r, j] exp(-2 pi i j k / N), channel-major; the
    f64 twiddle table is cos/sin(2 pi x / N)."""
    n, m = 16, 5
    u_i, u_q = _planes(8, m, n)
    u = u_i.astype(np.float64) + 1j * u_q
    jk = np.outer(np.arange(n), np.arange(n))
    want = (u @ np.exp(-2j * np.pi * jk / n)).T
    y_i, y_q = pfb_dft_plain(T(u_i), T(u_q))
    np.testing.assert_allclose(y_i.numpy(), want.real, atol=1e-5)
    np.testing.assert_allclose(y_q.numpy(), want.imag, atol=1e-5)
    c, s = twiddle_table(n)
    x = np.arange(n // 2)
    np.testing.assert_array_equal(c, np.cos(2 * np.pi * x / n).astype(
        np.float32))
    np.testing.assert_array_equal(s, np.sin(2 * np.pi * x / n).astype(
        np.float32))


@pytest.mark.parametrize("n", [4, 6, 16, 512])
def test_channelizer_matches_jax(n):
    """Three streamed blocks (tail carried) then one block shorter than
    the filter history (the pfb_fir_timemajor path): outputs within
    atol 1e-5 x max|y| of the JAX channelizer, carried tails equal. N = 4
    and 6 lie outside the DFT kernel's powers of two from 8 to 4096: the
    channelizer takes its plain twin there on any device."""
    jp, tp = JaxPFB(n), PFBChannelizer(n, "cpu")
    assert tp._dft_kernel == (n >= 8)
    np.testing.assert_array_equal(tp._hcol, jp._hcol)
    np.testing.assert_array_equal(tp.center_freqs(8 * 48000.0),
                                  jp.center_freqs(8 * 48000.0))
    js, ts = jp.init_state(), tp.init_state()
    rng = np.random.default_rng(n)
    for w in (n * 40, n * 40, n * 40, n * 3):
        x_i, x_q = (rng.normal(size=w).astype(np.float32) for _ in range(2))
        js, jy_i, jy_q = jp(js, jnp.asarray(x_i), jnp.asarray(x_q))
        ts, ty_i, ty_q = tp(ts, T(x_i), T(x_q))
        for g, want in ((ty_i, jy_i), (ty_q, jy_q)):
            want = np.asarray(want)
            assert g.shape == want.shape == (n, w // n)
            np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        np.testing.assert_array_equal(ts.tail_i.numpy(), np.asarray(js.tail_i))
        np.testing.assert_array_equal(ts.tail_q.numpy(), np.asarray(js.tail_q))


def test_channelizer_puts_a_tone_in_its_bin():
    n, m = 16, 256
    tp = PFBChannelizer(n, "cpu")
    k = 3
    t = np.arange(n * m)
    x = np.exp(2j * np.pi * k * t / n).astype(np.complex64)
    _, y_i, y_q = tp(tp.init_state(), T(x.real.copy()), T(x.imag.copy()))
    power = (y_i[:, 64:] ** 2 + y_q[:, 64:] ** 2).mean(dim=1)
    assert int(torch.argmax(power)) == k
    assert float(power[k]) > 1e3 * float(power[(k + 4) % n])
    for hz in (3 * 48000.0 + 700.0, -2 * 48000.0 - 300.0, 8 * 48000.0):
        assert bin_and_offset(hz, 48000.0, n) == jax_bin_and_offset(
            hz, 48000.0, n)
        assert tp.bin_and_offset(hz, 48000.0) == bin_and_offset(hz, 48000.0, n)


def test_pfb_wrappers_refuse_what_the_kernels_do_not_cover():
    meta = torch.empty((64, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pfb_fir_stream(meta, meta, meta[:8], meta[:8], meta[:8])
    with pytest.raises(ValueError, match="unsupported device"):
        pfb_fir_timemajor(meta, meta, meta[:8])
    with pytest.raises(ValueError, match="unsupported device"):
        pfb_dft(meta, meta)
    tp = PFBChannelizer(16, "cpu")
    with pytest.raises(ValueError, match="multiple of 16"):
        tp(tp.init_state(), torch.zeros(100), torch.zeros(100))
    assert {"pfb.cu", "pfb_dft.cu"} <= {p.rsplit("/", 1)[-1]
                                        for p in cuda._sources()}


def test_pfb_fir_plain_is_the_tap_loop():
    """The twin against a direct NumPy evaluation of
    u[r, j] = sum_t hcol[t, j] vv[r + 7 - t + (j == 0), j] in float64."""
    n, m = 32, 20
    vv_i, vv_q = _planes(9, 8 + m, n)
    hcol = JaxPFB(n)._hcol
    u_i, _ = pfb_fir_plain(T(vv_i), T(vv_q), T(hcol))
    want = np.zeros((m, n))
    for r in range(m):
        for j in range(n):
            s = 1 if j == 0 else 0
            want[r, j] = sum(float(hcol[t, j]) * float(vv_i[r + 7 - t + s, j])
                             for t in range(8))
    np.testing.assert_allclose(u_i.numpy(), want, atol=1e-5)


# --- bfloat16 -------------------------------------------------------------------

def _bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _flush(x):
    """float32 x with every subnormal replaced by a zero of its sign."""
    return torch.where(x.abs() < 2.0 ** -126, x * 0, x)


def _fir_flushed(vv, hcol, tpp=8):
    """The bf16 twin's operations as XLA runs them on the CPU: each product
    and sum in float32 with subnormal operands and results flushed to zeros
    of their sign, then rounded to bfloat16."""
    bf, f = torch.bfloat16, torch.float32
    m = vv.shape[0] - tpp
    rows = m + tpp - 1
    vv, hcol = vv.to(bf).to(f), hcol.to(bf).to(f)
    vvs = torch.cat([vv[1:rows + 1, :1], vv[:rows, 1:]], dim=1)
    acc = None
    for t in range(tpp):
        o = tpp - 1 - t
        s = _flush(_flush(vvs[o:o + m]) * _flush(hcol[t][None, :]))
        s = s.to(bf).to(f)
        acc = s if acc is None else _flush(_flush(acc) + s).to(bf).to(f)
    return acc.to(bf)


@pytest.mark.parametrize("n, case", [
    pytest.param(n, case, id=f"{n}" + (f"-{case}" if case else ""))
    for case in (None, *BF16_EDGE_CASES) for n in (16, 512)])
def test_bf16_fir_twin_equals_xla(n, case):
    """The bf16 branch FIR twin (input and taps rounded to bfloat16, every
    product and running sum rounded to bfloat16, from the product of tap 0)
    against the JAX channelizer's bf16 slice-sum under jit on the CPU, the
    path its bf16 PFBChannelizer takes there, as int16 bit patterns: on
    normal planes and on the edge planes of kernels/pfb_cases.py (exact
    ties, bfloat16 subnormals, sums that overflow near bfloat16's largest
    value, signed zeros), the inputs where a packed bfloat16 product or sum
    that rounded otherwise would part from the twin. XLA on the CPU rounds
    each bfloat16 product and sum as PyTorch does, but flushes subnormal
    float32 operands and results to zeros of their sign, where the twin
    (and the card's bfloat16 arithmetic) keeps them: on the subnormal and
    signed-zero planes JAX equals the twin's operations with that flush,
    and the twin's own subnormal outputs are checked to be there. The
    stream and time-major wrappers' CPU routes are the twin."""
    import jax
    m, tpp = 200, 8
    rows = m + tpp - 1
    jp = JaxPFB(n, dtype="bf16")
    if case is None:
        (vv_i, vv_q), taps = _planes(n + 1, tpp + m, n), None
    else:
        vv_i, vv_q, taps = bf16_edge_planes(case, tpp + m, n, n + 1)
    taps = jp._hcol if taps is None else taps
    hcol = jnp.asarray(taps, jnp.bfloat16)

    @jax.jit
    def fir(vv):
        vv = vv.astype(jnp.bfloat16)
        vvs = jnp.concatenate([vv[1:rows + 1, :1], vv[:rows, 1:]], axis=1)
        acc = None
        for t in range(tpp):
            s = vvs[tpp - 1 - t:tpp - 1 - t + m, :] * hcol[t][None, :]
            acc = s if acc is None else acc + s
        return acc

    want = [np.asarray(fir(jnp.asarray(v))).view(np.int16)
            for v in (vv_i, vv_q)]
    bf = torch.bfloat16
    got = pfb_fir_plain(T(vv_i), T(vv_q), T(taps), bf)
    flushes = case in ("subnormal", "signed_zero")
    for g, w, v in zip(got, want, (vv_i, vv_q)):
        assert g.dtype == bf
        if flushes:
            np.testing.assert_array_equal(
                _fir_flushed(T(v), T(taps)).view(torch.int16).numpy(), w)
            tiny = (g.float().abs() < 2.0 ** -126) & (g != 0)
            assert bool(tiny.any())
        else:
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w)
    if case == "near_max":
        assert bool(torch.isinf(got[0].float()).any())
    if case == "signed_zero":
        assert bool(((got[0] == 0) & torch.signbit(got[0].float())).any())
    stream = pfb_fir_stream(T(vv_i[tpp:]), T(vv_q[tpp:]), T(vv_i[:tpp]),
                            T(vv_q[:tpp]), T(taps), bf)
    tm = pfb_fir_timemajor(T(vv_i), T(vv_q), T(taps), bf)
    for a, b, c in zip(got, stream, tm):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        assert torch.equal(a.view(torch.int16), c.view(torch.int16))


@pytest.mark.parametrize("n", [16, 512])
def test_bf16_channelizer_matches_jax(n):
    """PFBChannelizer(n, dtype="bf16") against the JAX one: three streamed
    blocks and one shorter than the filter history; y in bfloat16 within 4
    bfloat16 steps at max|y| of JAX's, the carried tails float32 and equal.
    Not bit for bit: the FIR is (test_bf16_fir_twin_equals_xla), but JAX's
    DFT rounds its stages to bfloat16 (each matrix product, twiddle
    product and sum: 3 roundings at N = 16, 7 at N = 512 = 16 x 32) where
    the port's transforms in float32 and rounds once (measured: 1 step)."""
    jp, tp = JaxPFB(n, dtype="bf16"), PFBChannelizer(n, "cpu", "bf16")
    js, ts = jp.init_state(), tp.init_state()
    rng = np.random.default_rng(n + 2)
    for w in (n * 40, n * 40, n * 40, n * 3):
        x_i, x_q = (rng.normal(size=w).astype(np.float32) for _ in range(2))
        js, jy_i, jy_q = jp(js, jnp.asarray(x_i), jnp.asarray(x_q))
        ts, ty_i, ty_q = tp(ts, T(x_i), T(x_q))
        for g, want in ((ty_i, jy_i), (ty_q, jy_q)):
            want = np.asarray(want).astype(np.float32)
            assert g.dtype == torch.bfloat16 and g.shape == (n, w // n)
            top = np.abs(want).max()
            np.testing.assert_allclose(g.float().numpy(), want, rtol=0,
                                       atol=4 * _bf16_ulp(top))
        assert ts.tail_i.dtype == torch.float32
        np.testing.assert_array_equal(ts.tail_i.numpy(), np.asarray(js.tail_i))
        np.testing.assert_array_equal(ts.tail_q.numpy(), np.asarray(js.tail_q))


def test_bf16_dft_twin_rounds_the_f32_transform_once():
    """pfb_dft's CPU route on bfloat16 u: torch.fft of the widened planes,
    rounded to bfloat16 once."""
    u_i, u_q = (T(a).to(torch.bfloat16) for a in _planes(21, 64, 16))
    got = pfb_dft(u_i, u_q)
    want = pfb_dft_plain(u_i.float(), u_q.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))
