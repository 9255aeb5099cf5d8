"""The program's spans (``runtime.metrics.span``) and the benchmark's
readers of them (``benchmark/harness/spans.py``).

Off, ``span`` is one shared no-op and a step enters no RecordFunction; on,
under the CPU profiler, a step's stages show in order, nested under the
entry and, in a fleet, under their group, and every output is bit-equal
with the profiler on or off. The readers are held to a hand-built trace
whose attribution, counts, rows and gap labels are known.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import catalog, spans, trace
from sondetpu_torch.runtime import metrics
from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession
from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig
from sondetpu_torch.runtime.session import DecoderSession
from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

C, BLOCK = 8, 48000
STAGES = ("sondetpu.frontend", "sondetpu.timing", "sondetpu.sample",
          "sondetpu.ring", "sondetpu.corr", "sondetpu.peaks",
          "sondetpu.gather", "sondetpu.syndrome", "sondetpu.pack")


def _planes(n_blocks, seed=0):
    """int16 (i, q) [C, n_blocks * BLOCK] of one RS41 with seeded noise."""
    n = n_blocks * BLOCK
    iq = RS41Modulator().modulate([RS41Truth(frame_no=20 + j)
                                   for j in range(n // 25600 + 2)])[:n]
    rng = np.random.default_rng(seed)
    iq = iq[None] + 0.1 * (rng.normal(size=(C, n))
                           + 1j * rng.normal(size=(C, n)))
    return (np.clip(iq.real * 32767, -32768, 32767).astype(np.int16),
            np.clip(iq.imag * 32767, -32768, 32767).astype(np.int16))


def _config(**kw):
    return PipelineConfig(sonde="rs41", channels=C, block_len=BLOCK,
                          use_pallas=True, input_dtype="i16", **kw)


def _steps(pipe, planes, n_blocks):
    """Every block's output and the final state."""
    state, outs = pipe.init_state(), []
    for b in range(n_blocks):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        state, out = pipe.step(state, (planes[0][:, sl], planes[1][:, sl]))
        outs.append(out)
    return state, outs


def _tensors(x):
    """Every tensor of a (nested) tuple of outputs and states."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    if hasattr(x, "_fields") or hasattr(x, "__dataclass_fields__"):
        return _tensors(tuple(getattr(x, f) for f in (
            x._fields if hasattr(x, "_fields") else x.__dataclass_fields__)))
    return []


def _program_spans(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        tr = json.load(f)
    keys = spans.program_keys(tr["traceEvents"])
    return sorted(keys["program_spans"], key=lambda s: s[1])


def _assert_bit_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb) > 0
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_span_is_one_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = metrics.span("sondetpu.a"), metrics.span("sondetpu.b")
    assert a is b
    with a as entered:
        assert entered is None


def test_untraced_step_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    planes = _planes(1)
    _steps(Pipeline(_config(afc=True, fine_offsets=(0.0,) * C), "cpu"),
           planes, 1)


@pytest.mark.parametrize("kw,head", [
    ({}, ("sondetpu.ingest", "sondetpu.ingest")),
    ({"afc": True, "fine_offsets": tuple(float(f) for f in
                                         np.linspace(-700, 700, C))},
     ("sondetpu.ingest", "sondetpu.ddc", "sondetpu.ingest")),
], ids=["fused", "ddc-afc"])
def test_step_spans_in_order_and_outputs_bit_equal(kw, head, tmp_path):
    planes = _planes(2)
    plain = _steps(Pipeline(_config(**kw), "cpu"), planes, 2)
    pipe = Pipeline(_config(**kw), "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _steps(pipe, planes, 2)
    _assert_bit_equal(plain, traced)
    assert bool(traced[1][-1].frame_valid.any())
    sp = _program_spans(prof, tmp_path)
    names = [s[0] for s in sp]
    stages = head + STAGES[:1] + (("sondetpu.afc",) if kw else ()) \
        + STAGES[1:]
    assert names == (["sondetpu.step"] + list(stages)) * 2
    for name, ts, dur, tid, chain in sp:
        want = name if name == "sondetpu.step" else "sondetpu.step>" + name
        assert chain == want


def test_fleet_stage_spans_nest_under_their_group(tmp_path):
    chans = [FleetChannel(1, "rs41"), FleetChannel(3, "m10"),
             FleetChannel(6, "dfm")]
    rng = np.random.default_rng(5)
    wide = [torch.from_numpy(rng.normal(size=(2, 8 * BLOCK)).astype(
        np.float32)) for _ in range(2)]

    def run():
        fleet = FleetSession(chans, 8, "cpu")
        outs = [fleet.step(w[0], w[1]) for w in wide]
        return outs, [sess.state for _, _, sess in fleet._order]

    plain = run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run()
    _assert_bit_equal(plain, traced)
    chains = [s[4] for s in _program_spans(prof, tmp_path)]
    top = [c for c in chains if ">" not in c]
    assert top == ["sondetpu.fleet.step"] * 2
    groups = [c for c in chains if c.count(">") == 1]
    assert groups == ["sondetpu.fleet.step>" + g for g in (
        "sondetpu.fleet.pfb", "sondetpu.group.rs41", "sondetpu.group.m10",
        "sondetpu.group.dfm", "sondetpu.fleet.pack")] * 2
    for sonde in ("rs41", "m10", "dfm"):
        inner = [c.rpartition(">")[2] for c in chains if c.startswith(
            f"sondetpu.fleet.step>sondetpu.group.{sonde}>")]
        assert inner == (["sondetpu.ingest", "sondetpu.ingest"]
                         + list(STAGES)) * 2


def test_session_block_spans(tmp_path):
    planes = _planes(2)
    sess = DecoderSession(_config(), "cpu")
    blocks = [(planes[0][:, b * BLOCK:(b + 1) * BLOCK],
               planes[1][:, b * BLOCK:(b + 1) * BLOCK]) for b in range(2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        updates = [sess.process_block(b) for b in blocks]
    assert any(updates)
    chains = [s[4] for s in _program_spans(prof, tmp_path)
              if s[0].startswith("sondetpu.session.") or s[0] ==
              "sondetpu.step"]
    assert chains == ["sondetpu.session.step",
                      "sondetpu.session.step>sondetpu.step",
                      "sondetpu.session.step>sondetpu.session.readback",
                      "sondetpu.session.step>sondetpu.session.decode"] * 2


# --- the readers, on a hand-built trace ------------------------------------

def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _events():
    """Two blocks, 1200 us apart: the entry (sondetpu.step) at 10-990 us
    holds ingest, ddc, timing (a blocking copy: its synchronize waits 200
    us), corr (two launches) and frontend; the readback at 1000-1200 us
    copies outside every program span and waits 100 us."""
    ev = []
    for b in range(2):
        o, c = 1200.0 * b, 10 * b
        ev += [_x("user_annotation", "bench.dispatch", o, 1000),
               _x("user_annotation", "bench.readback", o + 1000, 200),
               _x("user_annotation", "sondetpu.step", o + 10, 980),
               _x("user_annotation", "sondetpu.ingest", o + 20, 80),
               _x("user_annotation", "sondetpu.ddc", o + 100, 200),
               _x("user_annotation", "sondetpu.timing", o + 300, 300),
               _x("user_annotation", "sondetpu.corr", o + 600, 300),
               _x("user_annotation", "sondetpu.frontend", o + 900, 80),
               _x("cuda_runtime", "cudaLaunchKernel", o + 30, 5,
                  correlation=c + 1),
               _x("cuda_runtime", "cudaLaunchKernel", o + 150, 5,
                  correlation=c + 2),
               _x("cuda_runtime", "cudaMemcpyAsync", o + 310, 5,
                  correlation=c + 3),
               _x("cuda_runtime", "cudaStreamSynchronize", o + 320, 200,
                  correlation=c + 8),
               _x("cuda_runtime", "cudaLaunchKernel", o + 650, 5,
                  correlation=c + 4),
               _x("cuda_runtime", "cudaLaunchKernel", o + 700, 5,
                  correlation=c + 5),
               _x("cuda_driver", "cuLaunchKernel", o + 910, 5,
                  correlation=c + 7),
               _x("cuda_runtime", "cudaMemcpyAsync", o + 1010, 5,
                  correlation=c + 6),
               _x("cuda_runtime", "cudaStreamSynchronize", o + 1020, 100,
                  correlation=c + 9),
               _x("kernel", "void at::native::dequant", o + 40, 50, tid=7,
                  correlation=c + 1),
               _x("kernel", "void at::native::ddc", o + 160, 100, tid=7,
                  correlation=c + 2),
               _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", o + 315,
                  2, tid=7, correlation=c + 3),
               _x("kernel", "sondetpu_corr_sign", o + 660, 30, tid=7,
                  correlation=c + 4),
               _x("kernel", "void at::native::maximum", o + 700, 20, tid=7,
                  correlation=c + 5),
               _x("kernel", "frontend_kernel<2>", o + 920, 30, tid=7,
                  correlation=c + 7),
               _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", o + 1030,
                  10, tid=7, correlation=c + 6)]
    return ev


class _Prof:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


class _Cell:
    config = {"pipeline": {"sonde": "rs41", "fs": 48000.0,
                           "block_len": 192000, "channels": 2048,
                           "compute_dtype": "f32", "ntaps": 41}}


def _record(program=True):
    ev = _events()
    record = trace.record_of(_Prof(ev), _Cell(), 2)
    record["dispatch_s"] = [0.016, 0.017]
    if program:
        record.update(spans.program_keys(ev))
    return record


@pytest.mark.parametrize("name,value", [
    ("syncs_per_step", 1.0), ("sync_wait_ms", 0.2),
    ("launches_per_step", 5.0), ("corr_device_ms", 0.05),
    ("ddc_device_ms", 0.1)])
def test_span_readers_on_a_hand_built_trace(name, value):
    read = catalog.metric_reader(name)
    assert read(_record()) == pytest.approx(value)
    # a record without the program's spans (a program that opens none)
    assert read(_record(program=False)) is None


@pytest.mark.parametrize("name", ["dispatch_ms", "glue_device_ms",
                                  "frontend_roofline_pct", "pfb_roofline_pct",
                                  "device_idle_pct"])
def test_accepted_readers_ignore_the_new_keys(name):
    read = catalog.metric_reader(name)
    assert read(_record()) == read(_record(program=False))
    if name != "pfb_roofline_pct":
        assert read(_record()) is not None


def test_breakdown_ignores_the_new_keys():
    assert trace.breakdown(_record()) == trace.breakdown(
        _record(program=False))


def test_attribution_by_correlation_id():
    chains = [(d[1], c) for d, c in spans.device_chains(_record())]
    assert chains[:7] == [
        ("void at::native::dequant", "sondetpu.step>sondetpu.ingest"),
        ("void at::native::ddc", "sondetpu.step>sondetpu.ddc"),
        ("Memcpy HtoD (Pageable -> Device)", "sondetpu.step>sondetpu.timing"),
        ("sondetpu_corr_sign", "sondetpu.step>sondetpu.corr"),
        ("void at::native::maximum", "sondetpu.step>sondetpu.corr"),
        ("frontend_kernel<2>", "sondetpu.step>sondetpu.frontend"),
        ("Memcpy DtoH (Device -> Pageable)", None)]


def test_stages_rows():
    rows = {r["stage"]: r for r in spans.stages(_record())}
    assert set(rows) == {"sondetpu.step"} | {
        "sondetpu.step>" + s for s in ("sondetpu.ingest", "sondetpu.ddc",
                                       "sondetpu.timing", "sondetpu.corr",
                                       "sondetpu.frontend")}
    want = {  # host ms, device ms, launches, syncs, sync ms, idle ms
        "sondetpu.step": (0.02, 0.0, 0, 0, 0.0, 0.0),
        "sondetpu.step>sondetpu.ingest": (0.08, 0.05, 1, 0, 0.0, 0.07),
        "sondetpu.step>sondetpu.ddc": (0.2, 0.1, 1, 0, 0.0, 0.055),
        "sondetpu.step>sondetpu.timing": (0.3, 0.002, 0, 1, 0.2, 0.343),
        "sondetpu.step>sondetpu.corr": (0.3, 0.05, 2, 0, 0.0, 0.21),
        "sondetpu.step>sondetpu.frontend": (0.08, 0.03, 1, 0, 0.0, 0.08)}
    for stage, (host, dev, launches, syncs, sync_ms, idle) in want.items():
        r = rows[stage]
        assert r["host_ms"] == pytest.approx(host)
        assert r["device_ms"] == pytest.approx(dev)
        assert (r["launches"], r["syncs"]) == (launches, syncs)
        assert r["sync_ms"] == pytest.approx(sync_ms)
        assert r["idle_ms"] == pytest.approx(idle)
    # the rows hold all the host time of the entry
    assert sum(r["host_ms"] for r in rows.values()) == pytest.approx(0.98)
    # the top rows by device ms and by host ms, and every row with a
    # synchronizing call
    top = spans.stages(_record(), top=1)
    assert [r["stage"] for r in top] == ["sondetpu.step>sondetpu.ddc",
                                         "sondetpu.step>sondetpu.timing"]
    top = spans.stages(_record(), top=2)
    assert [r["stage"] for r in top] == [
        "sondetpu.step>sondetpu.ddc", "sondetpu.step>sondetpu.ingest",
        "sondetpu.step>sondetpu.corr", "sondetpu.step>sondetpu.timing"]


def test_gap_labels_name_the_program_chain():
    gaps = spans.idle_gaps(_record(), top=20)
    labels = {}
    for label, s in gaps:
        labels[label] = labels.get(label, 0.0) + s
    assert gaps[0][0] == "bench.dispatch>sondetpu.step>sondetpu.timing"
    assert labels["bench.dispatch>sondetpu.step>sondetpu.timing"] == \
        pytest.approx(2 * 343e-6)
    assert labels["bench.readback"] == pytest.approx(2 * 200e-6 - 40e-6)
    assert labels["bench.dispatch"] == pytest.approx(40e-6)
    # the same gaps, and the same lengths, as the accepted breakdown's
    accepted = trace.breakdown(_record(), top=20)["idle_gaps"]
    assert sorted(s for _, s in accepted) == sorted(s for _, s in gaps)
    assert {lab for lab, _ in accepted} <= {"bench.dispatch",
                                            "bench.readback"}


def test_index_takes_the_innermost_span_and_tolerates_rounding():
    raw = [("sondetpu.step", 0.0, 10.0, 1),
           ("sondetpu.corr", 5.0, 5.001, 1),      # ends past its parent
           ("sondetpu.pack", 10.0, 2.0, 1)]       # starts where it ends
    sp = spans._nest(raw)
    assert [s[4] for s in sp] == ["sondetpu.step",
                                  "sondetpu.step>sondetpu.corr",
                                  "sondetpu.pack"]
    ix = spans.Index(sp)
    assert ix.at(1, 4.9) == "sondetpu.step"
    assert ix.at(1, 5.0) == "sondetpu.step>sondetpu.corr"
    assert ix.at(1, 9.999) == "sondetpu.step>sondetpu.corr"
    assert ix.at(1, 10.0005) == "sondetpu.pack"
    assert ix.at(1, 11.0) == "sondetpu.pack"
    assert ix.at(1, 12.5) is None
    assert ix.at(2, 5.0) is None
