"""The port's checkpoint and resume against the JAX package's.

- A session checkpoint the JAX package wrote (the committed bf16 fixture of
  ``tests/data/jax_checkpoint.py``: rs41, 8 channels, full calibration, AFC
  on; and a live f32 one) loads into the port, and the port's session run
  on from it gives the telemetry of the JAX session run on from it.
- A JAX fleet checkpoint whose rs41 group of 66 channels the JAX package
  pads to 128 rows loads into the port's fleet (66 rows) and resumes to the
  JAX fleet's telemetry.
- The port's own checkpoints round-trip, in f32 and bf16, with
  ``ml_dtypes`` and ``sondetpu`` refused in the process.
- Mismatched configs raise before the session is touched, as in
  ``tests/test_runtime_aux.py``, and a checkpoint naming a foreign class is
  refused.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from sondetpu.runtime import checkpoint as jckpt
from sondetpu.runtime.fleet import FleetChannel as JaxChannel
from sondetpu.runtime.fleet import FleetSession as JaxFleet
from sondetpu.runtime.pipeline import PipelineConfig as JaxConfig
from sondetpu.runtime.session import DecoderSession as JaxSession
from sondetpu_torch.runtime import checkpoint as tckpt
from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession
from sondetpu_torch.runtime.pipeline import PipelineConfig
from sondetpu_torch.runtime.session import DecoderSession
from sondetpu_torch.sondes.m10 import M10Modulator, M10Truth
from sondetpu_torch.sondes.modulate import freq_shift, gfsk_modulate
from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "data"))
import jax_checkpoint as fixture  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
R = fixture.RECIPE
B = R["block_len"]


@pytest.fixture(scope="module")
def planes():
    return fixture.planes()


def _block(planes, k, rows=None):
    pi, pq = planes
    rows = slice(None) if rows is None else slice(0, rows)
    return pi[rows, k * B:(k + 1) * B], pq[rows, k * B:(k + 1) * B]


def _config(cls, **kw):
    base = dict(sonde=R["sonde"], channels=R["channels"], block_len=B,
                compute_dtype=R["compute_dtype"], afc=R["afc"])
    base.update(kw)
    return cls(**base)


def _run_on(sess, planes, blocks, rows=None):
    for k in blocks:
        sess.process_block(_block(planes, k, rows))
    return fixture.telemetry_json(sess.telemetry)


def test_jax_bf16_checkpoint_resumes_to_the_jax_telemetry(planes):
    """The committed JAX checkpoint (bf16 state, AFC, calibration) restores
    into the port; run on, its telemetry is the JAX session's, as the
    fixture recorded it and as the JAX package gives it now."""
    with open(fixture.EXPECTED) as f:
        expected = json.load(f)
    assert expected["recipe"] == R
    port = DecoderSession(_config(PipelineConfig), CPU)
    tckpt.load_session(port, fixture.CKPT)
    assert port.blocks_seen == R["blocks_saved"]
    assert port.state.chipbuf.dtype == torch.bfloat16
    assert all(t.calibrated for t in port.telemetry.values())
    rest = range(R["blocks_saved"], R["blocks"])
    got = _run_on(port, planes, rest)
    jax = JaxSession(_config(JaxConfig))
    jckpt.load_session(jax, fixture.CKPT)
    assert _run_on(jax, planes, rest) == got == expected["telemetry"]
    assert port.frames_seen == jax.frames_seen == expected["frames_seen"]


def test_jax_f32_checkpoint_with_afc_resumes_to_the_jax_run(planes,
                                                            tmp_path):
    """A JAX session saved mid-stream (f32, AFC, two channels) and the JAX
    session run on without a break: the port restores the checkpoint and
    runs on to the same telemetry."""
    path = str(tmp_path / "jax_f32.ckpt")
    jax = JaxSession(_config(JaxConfig, channels=2, compute_dtype="f32"))
    saved = 30
    _run_on(jax, planes, range(saved), rows=2)
    jckpt.save_session(jax, path)
    want = _run_on(jax, planes, range(saved, R["blocks"]), rows=2)
    port = DecoderSession(_config(PipelineConfig, channels=2,
                                  compute_dtype="f32"), CPU)
    tckpt.load_session(port, path)
    assert port.telemetry[0].calib_percent > 0
    assert _run_on(port, planes, range(saved, R["blocks"]), rows=2) == want


_ROUND_TRIP = r"""
import importlib.abc, json, sys
class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "sondetpu"):
            raise ImportError("refused in this process: " + name)
        return None
sys.meta_path.insert(0, _Refuse())
sys.path.insert(0, "tests/data")
import torch
import jax_checkpoint as fixture
from sondetpu_torch.runtime import checkpoint
from sondetpu_torch.runtime.pipeline import PipelineConfig
from sondetpu_torch.runtime.session import DecoderSession
r = fixture.RECIPE
b = r["block_len"]
pi, pq = fixture.planes()
def session():
    return DecoderSession(PipelineConfig(
        sonde=r["sonde"], channels=r["channels"], block_len=b,
        compute_dtype=r["compute_dtype"], afc=r["afc"]), "cpu")
def run(sess, ks):
    for k in ks:
        sess.process_block((pi[:, k * b:(k + 1) * b], pq[:, k * b:(k + 1) * b]))
    return fixture.telemetry_json(sess.telemetry)
first = session()
checkpoint.load_session(first, fixture.CKPT)       # written by the JAX package
run(first, [r["blocks_saved"]])
checkpoint.save_session(first, sys.argv[1])        # bf16, by the port
second = session()
checkpoint.load_session(second, sys.argv[1])
assert second.state.chipbuf.dtype == torch.bfloat16
for a, b_ in zip(checkpoint._leaves(first.state), checkpoint._leaves(second.state)):
    assert a.dtype == b_.dtype and torch.equal(a, b_)
rest = range(r["blocks_saved"] + 1, r["blocks"])
assert run(first, rest) == run(second, rest)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("ml_dtypes", "jax", "sondetpu"))))
"""


def test_bf16_checkpoint_without_ml_dtypes(tmp_path):
    """In a process that refuses ml_dtypes, jax and sondetpu, the JAX bf16
    checkpoint loads, and a bf16 checkpoint of the port saves and loads
    with its state bit for bit and its telemetry run on equal."""
    res = subprocess.run(
        [sys.executable, "-c", _ROUND_TRIP, str(tmp_path / "port.ckpt")],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_port_checkpoint_round_trips(planes, tmp_path, dtype):
    path = str(tmp_path / "s.ckpt")
    cfg = _config(PipelineConfig, channels=2, compute_dtype=dtype)
    whole = DecoderSession(cfg, CPU)
    _run_on(whole, planes, range(3), rows=2)
    tckpt.save_session(whole, path)
    resumed = DecoderSession(cfg, CPU)
    tckpt.load_session(resumed, path)
    for a, b in zip(tckpt._leaves(whole.state), tckpt._leaves(resumed.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert resumed.blocks_seen == 3
    assert _run_on(resumed, planes, range(3, 5), rows=2) == \
        _run_on(whole, planes, range(3, 5), rows=2)


@pytest.mark.parametrize("change", [
    {"sonde": "dfm"}, {"channels": 4}, {"block_len": 24000}, {"afc": False},
    {"compute_dtype": "f32"}])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mismatched_config_raises_before_touching_the_session(
        tmp_path, change, writer):
    path = fixture.CKPT
    if writer == "port":
        path = str(tmp_path / "p.ckpt")
        tckpt.save_session(DecoderSession(_config(PipelineConfig), CPU),
                           path)
    sess = DecoderSession(_config(PipelineConfig, **change), CPU)
    before = [t.clone() for t in tckpt._leaves(sess.state)]
    with pytest.raises(ValueError):
        tckpt.load_session(sess, path)
    assert sess.blocks_seen == 0 and sess.telemetry == {}
    assert all(torch.equal(a, b)
               for a, b in zip(before, tckpt._leaves(sess.state)))


def test_foreign_class_is_refused(tmp_path):
    path = str(tmp_path / "evil.ckpt")
    with open(path, "wb") as f:
        pickle.dump({"version": 2, "x": subprocess.Popen}, f)
    with pytest.raises(pickle.UnpicklingError, match="subprocess.Popen"):
        tckpt.load_session(DecoderSession(_config(PipelineConfig), CPU), path)


# --- fleets -------------------------------------------------------------------

N_BINS = 16
FS_WIDE = N_BINS * 48000.0
N_RS41 = 66          # >= 64 and not a multiple: JAX pads the group to 128


def _fleet_plan():
    """66 rs41 channels over the bins (the carrier in bin 1 among them) and
    2 m10 channels (its carrier in bin 5)."""
    return [(k % N_BINS, "rs41") for k in range(N_RS41)] + \
        [(5, "m10"), (9, "m10")]


def _fleet_wideband(n_blocks):
    w = N_BINS * 48000
    n = n_blocks * w
    rs = RS41Modulator()
    bits = rs.frames_to_bits(np.stack(
        [rs.build_frame(RS41Truth(frame_no=40 + i)) for i in range(12)]))
    sig = [freq_shift(gfsk_modulate(bits, FS_WIDE / 4800.0, 2400.0 / FS_WIDE,
                                    bt=0.5), 48000.0 / FS_WIDE)]
    m10 = M10Modulator()
    chips = m10.frames_to_chips(np.stack(
        [m10.build_frame(M10Truth(frame_no=8 + i)) for i in range(12)]))
    sig.append(freq_shift(gfsk_modulate(chips, FS_WIDE / 9600.0,
                                        12000.0 / FS_WIDE, bt=0.7),
                          5 * 48000.0 / FS_WIDE))
    wide = np.zeros(n, np.complex64)
    for s in sig:
        wide[:min(n, s.size)] += s[:n]
    return [wide[i:i + w] for i in range(0, n, w)]


def test_jax_fleet_checkpoint_with_a_64_padded_group(tmp_path):
    blocks = _fleet_wideband(4)
    plan = _fleet_plan()
    jax = JaxFleet([JaxChannel(b, s) for b, s in plan], N_BINS,
                   use_pallas=False)
    assert jax.groups["rs41"][1].config.channels == 128
    for blk in blocks[:2]:
        jax.process_wideband(blk)
    path = str(tmp_path / "fleet.ckpt")
    jckpt.save_fleet(jax, path)
    at_save = fixture.telemetry_json(jax.telemetry)
    for blk in blocks[2:]:
        jax.process_wideband(blk)
    want = fixture.telemetry_json(jax.telemetry)
    assert {"1", "17", "65", str(N_RS41)} <= set(want), want

    port = FleetSession([FleetChannel(b, s) for b, s in plan], N_BINS, CPU,
                        use_pallas=False)
    assert port.groups["rs41"][1].config.channels == N_RS41
    tckpt.load_fleet(port, path)
    assert fixture.telemetry_json(port.telemetry) == at_save
    for blk in blocks[2:]:
        port.process_wideband(blk)
    assert fixture.telemetry_json(port.telemetry) == want

    # and the port's own fleet checkpoint of the same fleet round-trips
    mine = str(tmp_path / "port_fleet.ckpt")
    tckpt.save_fleet(port, mine)
    again = FleetSession([FleetChannel(b, s) for b, s in plan], N_BINS, CPU,
                         use_pallas=False)
    tckpt.load_fleet(again, mine)
    assert fixture.telemetry_json(again.telemetry) == want

    # a moved channel raises before the fleet is touched
    moved = FleetSession([FleetChannel((b + 1) % N_BINS, s)
                          for b, s in plan], N_BINS, CPU, use_pallas=False)
    before = moved.pfb_state.tail_i.clone()
    with pytest.raises(ValueError, match="layout"):
        tckpt.load_fleet(moved, path)
    assert torch.equal(moved.pfb_state.tail_i, before)
    assert moved.telemetry == {}
