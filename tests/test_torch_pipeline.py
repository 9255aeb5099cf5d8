"""The port's RS41 kernel path against the JAX package's use_pallas=True
pipeline (Pallas kernels in interpret mode on the CPU), end to end.

The same numpy-made IQ (RS41Modulator + seeded noise, quantized to cs16)
goes through both. Valid-slot bytes, validity and RS verdicts must be
equal exactly, and the decoded telemetry identical. Bytes of invalid slots
are not compared: they come from sub-threshold argmax picks.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sondetpu.pallas.corr import corr_kernel as jax_corr_kernel
from sondetpu.runtime import pipeline as jpipe
from sondetpu.runtime.session import DecoderSession as JaxSession
from sondetpu.sondes.rs41 import RS41Modulator, RS41Truth, RS41XModulator
from sondetpu.sync.correlator import find_frame_starts as jax_find_frame_starts
from sondetpu_torch.kernels.corr import corr_kernel
from sondetpu_torch.runtime import pipeline as tpipe
from sondetpu_torch.runtime.session import DecoderSession
from sondetpu_torch.sync.correlator import find_frame_starts
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

C, BLOCK = 8, 48000
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _planes(serials, n_blocks, seed=0, noise=0.1, extended=False):
    """int16 (i, q) [C, n_blocks*BLOCK]: channel ch carries
    serials[ch % len(serials)], each with its own seeded noise. Extended:
    518-byte rs41x frames (41440 samples each) with an ozone reading of
    2.25 mPa."""
    n = n_blocks * BLOCK
    mod, per = (RS41XModulator(), 41440) if extended else (RS41Modulator(),
                                                           25600)
    rows = {}
    for k, s in enumerate(serials):
        iq = mod.modulate(
            [RS41Truth(serial=s, frame_no=20 + j,
                       o3_mpa=2.25 if extended else None)
             for j in range(n // per + 2)])[:n]
        rng = np.random.default_rng(seed + k)
        iq = iq + noise * (rng.normal(size=n) + 1j * rng.normal(size=n))
        rows[k] = (np.clip(iq.real * 32767, -32768, 32767).astype(np.int16),
                   np.clip(iq.imag * 32767, -32768, 32767).astype(np.int16))
    qi = np.stack([rows[ch % len(serials)][0] for ch in range(C)])
    qq = np.stack([rows[ch % len(serials)][1] for ch in range(C)])
    return qi, qq


def _config(**kw):
    return dict(sonde="rs41", channels=C, block_len=BLOCK, use_pallas=True,
                compute_dtype="f32", input_dtype="i16", **kw)


def _starts(chipbuf_np, cfg, corr_fn, find_fn, wrap):
    tmpl = cfg.spec.sync_chip_template()
    if wrap is torch.from_numpy:
        corr = corr_fn(torch.from_numpy(chipbuf_np), torch.from_numpy(tmpl))
    else:
        corr = corr_fn(wrap(chipbuf_np), wrap(tmpl[None, :]), interpret=True)
    min_dist = max(cfg.min_frame_chips // 4, tmpl.shape[0])
    starts, _ = find_fn(corr, cfg.sync_threshold, cfg.k_slots, min_dist)
    return np.asarray(starts)


def _assert_block_equal(jo, to, jstate, tstate, cfg):
    jv = np.asarray(jo.frame_valid)
    tv = to.frame_valid.numpy()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(to.frames.numpy()[tv], np.asarray(jo.frames)[jv])
    np.testing.assert_array_equal(to.rs_clean.numpy(), np.asarray(jo.rs_clean))
    np.testing.assert_allclose(to.soft_rms.numpy(), np.asarray(jo.soft_rms),
                               rtol=1e-5)
    js = _starts(np.asarray(jstate.chipbuf), cfg, jax_corr_kernel,
                 jax_find_frame_starts, jax.numpy.asarray)
    ts = _starts(tstate.chipbuf.numpy(), cfg, corr_kernel, find_frame_starts,
                 torch.from_numpy)
    np.testing.assert_array_equal(ts[tv], js[jv])
    # the packed wire buffer agrees wherever it carries valid-slot bytes,
    # validity, verdicts: unpack and compare those
    t_un = tpipe.unpack_block_output(to.packed.numpy(), cfg.k_slots,
                                     cfg.wire_ncols)
    j_un = jpipe.unpack_block_output(np.asarray(jo.packed), cfg.k_slots,
                                     cfg.wire_ncols)
    np.testing.assert_array_equal(t_un[0][tv], j_un[0][jv])
    np.testing.assert_array_equal(t_un[1], j_un[1])
    np.testing.assert_array_equal(t_un[2], j_un[2])
    return int(jv.sum())


@pytest.mark.parametrize("serials", [["S1234567"],
                                     ["S1234567", "T7654321", "R0420042"]],
                         ids=["identical", "three-serials"])
def test_port_matches_jax_pipeline(serials):
    """4 blocks at C=8: per block validity, RS verdicts, valid-slot bytes
    and starts equal exactly; soft_rms within rtol 1e-5."""
    qi, qq = _planes(serials, 4)
    jp = jpipe.Pipeline(jpipe.PipelineConfig(**_config()))
    tp = tpipe.Pipeline(tpipe.PipelineConfig(**_config()), CPU)
    assert jp._pallas
    js, ts = jp.init_state(), tp.init_state()
    frames = 0
    for b in range(4):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        js, jo = jp.step(js, (qi[:, sl], qq[:, sl]))
        ts, to = tp.step(ts, (qi[:, sl], qq[:, sl]))
        frames += _assert_block_equal(jo, to, js, ts, tp.config)
        np.testing.assert_allclose(ts.timing.pos.numpy(),
                                   np.asarray(js.timing.pos), atol=5e-3)
        np.testing.assert_array_equal(ts.buf_fill.numpy(),
                                      np.asarray(js.buf_fill))
    assert frames >= C * 5


def test_state_from_numpy_carries_the_jax_state():
    """JAX runs 2 blocks; its state moves to the port, which runs block 3
    as the JAX package does. The port's state then moves back
    (state_to_numpy) and JAX runs block 4 from it."""
    qi, qq = _planes(["S1234567", "T7654321"], 4, seed=3)
    jp = jpipe.Pipeline(jpipe.PipelineConfig(**_config()))
    tp = tpipe.Pipeline(tpipe.PipelineConfig(**_config()), CPU)
    js = jp.init_state()
    blocks = [(qi[:, b * BLOCK:(b + 1) * BLOCK], qq[:, b * BLOCK:(b + 1) * BLOCK])
              for b in range(4)]
    for b in range(2):
        js, _ = jp.step(js, blocks[b])
    ts = tpipe.state_from_numpy(js, CPU)
    assert ts.chan_tail_i.shape == (C, 256) and ts.chipbuf.dtype == torch.float32
    np.testing.assert_array_equal(ts.chipbuf.numpy(), np.asarray(js.chipbuf))
    js, jo = jp.step(js, blocks[2])
    ts, to = tp.step(ts, blocks[2])
    assert _assert_block_equal(jo, to, js, ts, tp.config) > 0
    back = tpipe.state_to_numpy(ts)
    js2 = jpipe.PipelineState(
        chan_tail_i=back.chan_tail_i, chan_tail_q=back.chan_tail_q,
        fm_prev=back.fm_prev, fir=jpipe.FIRState(tail=back.fir.tail),
        timing=jpipe.TimingState(pos=back.timing.pos,
                                 locked=back.timing.locked),
        chipbuf=back.chipbuf, buf_fill=back.buf_fill, aux=back.aux)
    _, jo4 = jp.step(js2, blocks[3])
    ts, to4 = tp.step(ts, blocks[3])
    np.testing.assert_array_equal(to4.frame_valid.numpy(),
                                  np.asarray(jo4.frame_valid))
    v = to4.frame_valid.numpy()
    np.testing.assert_array_equal(to4.frames.numpy()[v],
                                  np.asarray(jo4.frames)[v])


@pytest.mark.parametrize("pipelined", [False, True])
def test_session_telemetry_matches_jax_session(pipelined):
    qi, qq = _planes(["S1234567", "T7654321", "R0420042"], 3, seed=5)
    jsess = JaxSession(jpipe.PipelineConfig(**_config()), pipelined=pipelined)
    tsess = DecoderSession(tpipe.PipelineConfig(**_config()), CPU,
                           pipelined=pipelined)
    jup, tup = [], []
    for b in range(3):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        jup += jsess.process_block((qi[:, sl], qq[:, sl]))
        tup += tsess.process_block((qi[:, sl], qq[:, sl]))
    jup += jsess.flush()
    tup += tsess.flush()
    assert len(tup) == len(jup) > 0
    assert ([(ch, repr(u.to_dict())) for ch, u in tup]
            == [(ch, repr(u.to_dict())) for ch, u in jup])
    assert sorted(tsess.telemetry) == list(range(C))
    for ch in range(C):
        assert (repr(tsess.telemetry[ch].to_dict())
                == repr(jsess.telemetry[ch].to_dict()))
    assert tsess.telemetry[4].serial == "T7654321"
    for key in ("frames_raw", "frames_decoded", "updates", "blocks"):
        assert tsess.metrics.to_dict()[key] == jsess.metrics.to_dict()[key]
    np.testing.assert_allclose(tsess.metrics.last_rms, jsess.metrics.last_rms,
                               rtol=1e-5)


def test_rs41x_session_matches_jax_session():
    """rs41x (518-byte frames, K3's second shape): per block validity,
    valid-slot bytes and RS verdicts equal the JAX session's, and the
    updates and telemetry are equal, the ozone aux data included."""
    qi, qq = _planes(["S1234567"], 3, seed=11, extended=True)
    cfg = {**_config(), "sonde": "rs41x"}
    jp = jpipe.Pipeline(jpipe.PipelineConfig(**cfg))
    tp = tpipe.Pipeline(tpipe.PipelineConfig(**cfg), CPU)
    js, ts = jp.init_state(), tp.init_state()
    jsess = JaxSession(jpipe.PipelineConfig(**cfg))
    tsess = DecoderSession(tpipe.PipelineConfig(**cfg), CPU)
    jup, tup, frames = [], [], 0
    for b in range(3):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        block = (qi[:, sl], qq[:, sl])
        js, jo = jp.step(js, block)
        ts, to = tp.step(ts, block)
        jv = np.asarray(jo.frame_valid)
        np.testing.assert_array_equal(to.frame_valid.numpy(), jv)
        assert to.frames.shape[-1] == 518
        np.testing.assert_array_equal(to.frames.numpy()[jv],
                                      np.asarray(jo.frames)[jv])
        np.testing.assert_array_equal(to.rs_clean.numpy(),
                                      np.asarray(jo.rs_clean))
        frames += int(jv.sum())
        jup += jsess.process_block(block)
        tup += tsess.process_block(block)
    jup += jsess.flush()
    tup += tsess.flush()
    assert frames >= C and len(tup) == len(jup) > 0
    assert ([(ch, repr(u.to_dict())) for ch, u in tup]
            == [(ch, repr(u.to_dict())) for ch, u in jup])
    assert sorted(tsess.telemetry) == list(range(C))
    for ch in range(C):
        t = tsess.telemetry[ch]
        assert repr(t.to_dict()) == repr(jsess.telemetry[ch].to_dict())
        assert t.serial == "S1234567" and t.aux_data == "O3=2.25mPa", t


def test_session_fetches_suspect_frames_in_full():
    """Heavy noise leaves some frames RS-suspect: the compact readback path
    fetches their full frames, and the telemetry still equals the JAX
    session's."""
    qi, qq = _planes(["S1234567"], 2, seed=9, noise=0.62)
    jsess = JaxSession(jpipe.PipelineConfig(**_config()))
    tsess = DecoderSession(tpipe.PipelineConfig(**_config()), CPU)
    suspects = 0
    for b in range(2):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        jsess.process_block((qi[:, sl], qq[:, sl]))
        ts = tsess.state
        tsess.process_block((qi[:, sl], qq[:, sl]))
        _, out = tsess.pipeline.step(ts, (qi[:, sl], qq[:, sl]))
        suspects += int((out.frame_valid & ~out.rs_clean).sum())
    assert 0 < suspects < tsess.metrics.frames_raw
    assert tsess.metrics.frames_decoded == jsess.metrics.frames_decoded
    for ch in jsess.telemetry:
        assert (repr(tsess.telemetry[ch].to_dict())
                == repr(jsess.telemetry[ch].to_dict()))


_NO_JAX = r"""
import importlib.abc, sys
class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes"):
            raise ImportError("jax is refused in this process: " + name)
        return None
sys.meta_path.insert(0, _Refuse())
import pkgutil, numpy as np, torch
import sondetpu_torch
for m in pkgutil.walk_packages(sondetpu_torch.__path__, "sondetpu_torch."):
    __import__(m.name)
from sondetpu_torch.runtime.pipeline import PipelineConfig
from sondetpu_torch.runtime.session import DecoderSession
from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth
iq = RS41Modulator().modulate([RS41Truth(frame_no=i) for i in range(5)])
iq = np.tile(iq[None, :48000], (8, 1))
s = DecoderSession(PipelineConfig(sonde="rs41", channels=8, block_len=48000,
                                  use_pallas=True), torch.device("cpu"))
s.process_block(iq)
assert s.telemetry[0].serial == "S1234567", s.telemetry
from sondetpu_torch.sondes.m10 import M10Modulator, M10Truth
iq = M10Modulator().modulate([M10Truth(frame_no=i) for i in range(8)])
m10 = DecoderSession(PipelineConfig(sonde="m10", channels=8, block_len=48000,
                                    use_pallas=True), torch.device("cpu"))
m10.process_block(np.tile(iq[None, :48000], (8, 1)))
assert m10.telemetry[0].serial == "910-2-12345", m10.telemetry
from sondetpu_torch.sondes.imet4 import IMET4Modulator, IMET4Truth
iq = IMET4Modulator().modulate([IMET4Truth(frame_no=i) for i in range(3)])
imet = DecoderSession(PipelineConfig(sonde="imet4", channels=8,
                                     block_len=48000, use_pallas=True),
                      torch.device("cpu"))
imet.process_block(np.tile(iq[None, :48000], (8, 1)))
assert abs(imet.telemetry[0].lat - 40.0) < 1e-5, imet.telemetry
from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession
fleet = FleetSession([FleetChannel(1, "rs41"), FleetChannel(3, "m10"),
                      FleetChannel(6, "dfm")], 8, torch.device("cpu"))
fleet.process_wideband(np.zeros(8 * 48000, np.complex64))
assert not any(k.split(".")[0] in ("jax", "jaxlib") for k in sys.modules)
print("OK", s.metrics.frames_decoded + m10.metrics.frames_decoded
      + imet.metrics.frames_decoded)
"""


def test_port_imports_and_decodes_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _NO_JAX], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("OK ")
    assert int(res.stdout.split()[1]) > 0


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """chip_smoke.py names no module of jax or of the JAX package in its
    own imports: only the standard library, numpy, torch and the port."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert names, "no imports found"
    tops = {n.split(".")[0] for n in names}
    allowed = set(sys.stdlib_module_names) | {"numpy", "torch",
                                              "sondetpu_torch"}
    assert tops <= allowed, sorted(tops - allowed)


def _jax_midpoint(x):
    return 0.5 * (jnp.quantile(x, 0.10, axis=-1)
                  + jnp.quantile(x, 0.90, axis=-1))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [48000, 191999, 10001, 7, 2, 1])
def test_midpoint_dc_equals_jnp_quantile(n, dtype):
    """midpoint_dc equals the original's 0.5 * (q10 + q90) bit for bit, in
    float32 and bfloat16, on rows of seeded noise at many scales, rows with
    ties, a constant row and a row holding a NaN (NaN in both). At n =
    10001 the position 0.9 * 10000 rounds to 9000 in float32 (8999.9998 in
    float64), so the order statistic itself depends on the float32
    product."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(64, n))
         * rng.uniform(1e-3, 1e3, size=(64, 1))).astype(np.float32)
    x[:8] = np.round(x[:8])
    x[8] = 0.25
    x[9, n // 2] = np.nan
    if dtype == "bf16":
        xt = torch.from_numpy(x).to(torch.bfloat16)
        xj = jnp.asarray(xt.view(torch.int16).numpy()).view(jnp.bfloat16)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    want = np.asarray(jax.jit(_jax_midpoint)(xj).astype(jnp.float32))
    got = tpipe.midpoint_dc(xt)
    assert got.dtype == xt.dtype and got.shape == (64,)
    got = got.to(torch.float32).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert nan[9] and nan.sum() == 1
    assert torch.equal(torch.from_numpy(got[~nan]),
                       torch.from_numpy(want[~nan]))
    if n == 10001:
        pos = np.float32(0.9) * np.float32(n - 1)
        assert pos == 9000.0 and np.float64(np.float32(0.9)) * (n - 1) < 9000


def test_pipeline_refuses_mismatched_planes():
    tp = tpipe.Pipeline(tpipe.PipelineConfig(**_config()), CPU)
    st = tp.init_state()
    with pytest.raises(ValueError, match="iq planes"):
        tp.step(st, (np.zeros((C, BLOCK - 2), np.int16),
                     np.zeros((C, BLOCK - 2), np.int16)))
    with pytest.raises(TypeError, match="integer"):
        tp.step(st, np.zeros((C, BLOCK), np.complex64))


def test_fetch_frames_matches_frames():
    qi, qq = _planes(["S1234567"], 1)
    tp = tpipe.Pipeline(tpipe.PipelineConfig(**_config()), CPU)
    _, out = tp.step(tp.init_state(), (qi, qq))
    got = tp.fetch_frames(out.frames, [0, 3, 7], [1, 0, 2])
    np.testing.assert_array_equal(got, out.frames.numpy()[[0, 3, 7], [1, 0, 2]])
    assert tp.fetch_frames(out.frames, [], []).shape == (0, 320)

