"""The Meisei cell (``ims100-2048.ongrid-meisei``) on the CPU: its
reference (``benchmark/reference/pipeline_meisei.py``) against the port's
kernel route through the harness's own check, the control and three
planted faults, the frozen Meisei protocol code against the port's, the
reference's midpoint against the program's ``midpoint_dc``, and the
cell's per-layer metrics on hand-built records.

The tiny root is ``benchmark/tests/tiny.py``'s, with the cell's
configuration (8 channels, 1-s blocks: the dual-tone gate holds, since
2400 * 48000 / 48000 is whole), its mix (a 4-s period, 4 truths, 4
sampled rows) and its limits added beside it."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.control import control_side, program_side
from benchmark.frozen.roofline_dualtone import (dualtone_frontend_s,
                                                dualtone_ops, dualtone_s)
from benchmark.frozen.sondes import ims100 as frozen_ims100
from benchmark.gen import meisei_ring
from benchmark.harness import catalog
from benchmark.harness.main import verdict
from benchmark.reference import pipeline_meisei
from benchmark.tests.tiny import REPO, tiny_root
from sondetpu_torch.runtime import pipeline as tpipe
from sondetpu_torch.sondes import ims100 as port_ims100
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

CELL = "ims100-2048.ongrid-meisei"
CONFIG = "ims100-2048"
BLOCKS = 8


def _load(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tiny_root(tmp_path_factory.mktemp("tiny_meisei"))
    here = os.path.join(path, "benchmark")
    cfg = _load("benchmark", "configs", CONFIG + ".json")
    cfg["pipeline"].update(channels=8, block_len=48000)
    mix = _load("benchmark", "traffic", "ongrid-meisei.json")
    mix.update(period_s=4.0, truths=4)
    mix["check"].update(sample_rows=4, keep_every=2)
    for sub, name, x in (("configs", CONFIG, cfg),
                         ("traffic", "ongrid-meisei", mix),
                         ("limits", CELL, _load("benchmark", "limits",
                                                CELL + ".json"))):
        with open(os.path.join(here, sub, name + ".json"), "w") as f:
            json.dump(x, f)
    return path


def _setup(root, seed):
    c = catalog.Cell(CELL, root)
    dev = torch.device("cpu")
    ring = c.generator().make(torch, c.config, c.traffic, seed, dev)
    return c, ring, c.reference().build(c.config, c.traffic, ring, seed,
                                        dev), dev


def test_the_cell_takes_the_dualtone_kernel_route(root):
    c = catalog.Cell(CELL, root)
    system = c.system().build(torch, c.config, torch.device("cpu"))
    pipe = system.pipe
    assert pipe._route == "dualtone" and not pipe._plain
    assert not pipe._skip_chanfilt and pipe._midpoint
    assert c.config["reference"] == "pipeline_meisei"
    assert [m["name"] for m in c.per_layer if "workloads" in m] == [
        "dualtone_roofline_pct", "dualtone_bound_share_pct"]


def test_the_traffic_draws_both_subtypes(root):
    c = catalog.Cell(CELL, root)
    rng = np.random.default_rng(7)
    truths = [meisei_ring.draw_truth(rng) for _ in range(16)]
    assert {t["rs11g"] for t in truths} == {True, False}
    for t in truths:
        assert t["serial"].startswith("R") == t["rs11g"]
    ring = c.generator().make(torch, c.config, c.traffic, 2 ** 33 + 5,
                              torch.device("cpu"))
    assert len(ring.blocks) == 4 and ring.blocks[0][0].dtype == torch.int16
    assert ring.blocks[0][0].shape == (8, 48000)


def test_meisei_reference_equals_the_port_on_the_cpu(root):
    c, ring, ref, dev = _setup(root, 41)
    nums = program_side(torch, c, ring, ref, BLOCKS, dev, 41)
    assert nums["slots_compared"] > 0 and nums["telemetry_units"] > 0
    assert nums["ref_valid_frames"] > 0
    for k in ("soft_rms_gap", "soft_rms_gap_first", "chip_gap",
              "valid_mismatch", "rs_flag_mismatch", "telemetry_mismatch"):
        assert nums[k] == 0, (k, nums)
    assert verdict(nums, c.limits)[0]


def test_the_control_is_caught(root):
    c, ring, ref, dev = _setup(root, 42)
    nums = control_side(torch, c, ring, ref, BLOCKS)
    nums.update(telemetry_mismatch=0, telemetry_units=1)
    ok, rows = verdict(nums, c.limits)
    assert not ok, rows


@pytest.mark.parametrize("fault", sorted(pipeline_meisei.FAULTS))
def test_planted_faults_are_caught(root, fault, monkeypatch):
    for name, spec in pipeline_meisei.FAULTS.items():
        monkeypatch.setitem(control.FAULTS, name, spec)
    c, ring, ref, dev = _setup(root, 43)
    nums = control_side(torch, c, ring, ref, BLOCKS, fault=fault)
    nums.update(telemetry_mismatch=0, telemetry_units=1)
    ok, rows = verdict(nums, c.limits)
    assert not ok, rows


# --- the frozen Meisei protocol code against the port's --------------------

@pytest.mark.parametrize("rs11g", [False, True], ids=["ims100", "rs11g"])
def test_frozen_modulator_equals_the_port(rs11g):
    rng = np.random.default_rng(27 + rs11g)
    kw = [dict(serial=("R" if rs11g else "") + str(int(rng.integers(
        10 ** 6, 10 ** 7))), frame_no=i, lat=float(rng.uniform(-60, 60)),
        lon=float(rng.uniform(-170, 170)), alt=float(rng.uniform(500, 3e4)),
        rs11g=rs11g) for i in range(6)]
    fz = frozen_ims100.IMS100Modulator()
    pt = port_ims100.IMS100Modulator()
    for k, a in enumerate(kw):
        assert np.array_equal(
            fz.build_frame(frozen_ims100.IMS100Truth(**a), k % 2),
            pt.build_frame(port_ims100.IMS100Truth(**a), k % 2))
    iq_f = fz.modulate([frozen_ims100.IMS100Truth(**a) for a in kw])
    iq_p = pt.modulate([port_ims100.IMS100Truth(**a) for a in kw])
    assert iq_f.dtype == iq_p.dtype and np.array_equal(iq_f, iq_p)
    # the port's host decode reads the frozen frames back
    dec = port_ims100.IMS100Decoder()
    frames = np.stack([fz.build_frame(frozen_ims100.IMS100Truth(**a), k % 2)
                       for k, a in enumerate(kw)])
    got = dec.decode_byte_frames(frames, np.zeros(len(kw), np.int64))
    serials = [f.serial for _, f in got if f.serial]
    assert serials == [a["serial"] for a in kw[1::2]]


def test_frozen_bch_encoder_equals_the_port():
    from benchmark.frozen.fec.bch import BCH_63_51, bch_46_34_encode
    from sondetpu_torch.fec.bch import BCH_63_51 as port_bch
    rng = np.random.default_rng(5)
    msg = rng.integers(0, 2, size=(64, 34)).astype(np.uint8)
    assert np.array_equal(bch_46_34_encode(msg),
                          port_ims100.bch_46_34_encode(msg))
    assert np.array_equal(BCH_63_51.genpoly, port_bch.genpoly)


# --- the reference's midpoint against the program's ------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [48000, 191999, 10001, 7, 2, 1])
def test_reference_midpoint_equals_midpoint_dc(n, dtype):
    """``pipeline_meisei.midpoint`` (a sort, the fused sum rounded from its
    exact value) equals ``runtime.pipeline.midpoint_dc`` (``kthvalue``, the
    float64 emulation) bit for bit on ``test_midpoint_dc_equals_jnp_
    quantile``'s rows: seeded noise at many scales, ties, a constant row
    and a row holding a NaN."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(64, n))
         * rng.uniform(1e-3, 1e3, size=(64, 1))).astype(np.float32)
    x[:8] = np.round(x[:8])
    x[8] = 0.25
    x[9, n // 2] = np.nan
    xt = torch.from_numpy(x)
    if dtype == "bf16":
        xt = xt.to(torch.bfloat16)
    got = pipeline_meisei.midpoint(xt)
    want = tpipe.midpoint_dc(xt)
    assert got.dtype == want.dtype and got.shape == (64,)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and int(nan.sum()) == 1
    assert torch.equal(got[~nan], want[~nan])


def test_reference_fma_rounds_once():
    """``fma_f32`` rounds the exact a * b + c once: here the float32 sum of
    the float32 product reads otherwise."""
    a = np.array([1.0 + 2.0 ** -12], np.float32)
    b = np.float32(1.0 + 2.0 ** -12)
    c = np.array([-1.0], np.float32)
    exact = float(a[0]) * float(b) + float(c[0])      # 2^-11 + 2^-24
    assert pipeline_meisei.fma_f32(a, b, c)[0] == np.float32(exact)
    assert np.float32(a[0] * b) + c[0] != np.float32(exact)


# --- the cell's per-layer metrics on hand-built records ---------------------

PIPE = {"sonde": "ims100", "channels": 2048, "fs": 48000.0,
        "block_len": 192000, "ntaps": 41, "compute_dtype": "f32"}


def _record(device, config=None):
    return {"device": device, "spans": [], "start_us": 0.0,
            "end_us": 400000.0, "blocks": 2,
            "config": {"pipeline": PIPE} if config is None else config}


def test_dualtone_counts():
    assert dualtone_ops(41, 20, False) == 271
    assert dualtone_ops(41, 5, True) == 47
    assert dualtone_s(2048, 192000, 41, 20, False) == pytest.approx(
        2048 * 192000 * 271 / 33.5e12)
    assert dualtone_frontend_s(2048, 192000, 41, 20, False) == \
        pytest.approx(2048 * 192000 * 273 / 33.5e12)
    assert 3.17e-3 < dualtone_s(2048, 192000, 41, 20, False) < 3.19e-3
    assert 3.19e-3 < dualtone_frontend_s(2048, 192000, 41, 20, False) \
        < 3.21e-3


def test_dualtone_roofline_on_known_kernels():
    read = catalog.metric_reader("dualtone_roofline_pct")
    # two K7 launches of 4.75 ms over 2 blocks, beside a torch kernel
    dev = [("kernel", "void dualtone_kernel<20, 41, false, false, float>"
            "(float const*)", 0.0, 4750.0),
           ("kernel", "void dualtone_kernel<20, 41, false, false, float>"
            "(float const*)", 200000.0, 4750.0),
           ("kernel", "void at::native::mul", 5000.0, 50000.0)]
    want = 100.0 * dualtone_s(2048, 192000, 41, 20, False) / 4.75e-3
    assert read(_record(dev)) == pytest.approx(want)
    assert 66.0 < read(_record(dev)) < 67.5


def test_dualtone_bound_share_on_known_busy_intervals():
    read = catalog.metric_reader("dualtone_bound_share_pct")
    # busy 0-100 ms (two overlapping kernels) and 300-350 ms (a copy):
    # 150 ms over 2 blocks, 75 ms a block
    dev = [("kernel", "void dualtone_kernel<20, 41, false, false, float>",
            0.0, 60000.0),
           ("kernel", "void at::native::kthvalue", 40000.0, 60000.0),
           ("gpu_memcpy", "Memcpy DtoH", 300000.0, 50000.0)]
    want = 100.0 * dualtone_frontend_s(2048, 192000, 41, 20, False) / 0.075
    assert read(_record(dev)) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["dualtone_roofline_pct",
                                    "dualtone_bound_share_pct"])
@pytest.mark.parametrize("case", ["no_device_events", "fleet_config",
                                  "rs41_config", "unknown_family"])
def test_dualtone_metrics_read_nothing_without_their_inputs(metric, case):
    read = catalog.metric_reader(metric)
    dev = [("kernel", "void dualtone_kernel<20, 41, false, false, float>",
            0.0, 4750.0)]
    if case == "no_device_events":
        rec = _record([])
    elif case == "fleet_config":
        rec = _record(dev, {"fleet": {"n_bins": 2048}})
    else:
        sonde = "rs41" if case == "rs41_config" else "imet4"
        rec = _record(dev, {"pipeline": dict(PIPE, sonde=sonde)})
    assert read(rec) is None
