"""Configurations, traffic mixes, limits and metric readers are found by
name from files, and BENCHMARK.json keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from benchmark.harness import catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(catalog.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    e2e = {m["name"] for m in b["end_to_end"]}
    assert {"rt_channels", "block_ms_p95", "peak_mem_gib", "setup_s"} <= e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in b[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"] + b["per_layer"])
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_cell_files_found_by_name(cell):
    c = catalog.Cell(cell)
    assert c.config["name"] == c.workload["config"]
    assert hasattr(c.generator(), "make")
    assert hasattr(c.system(), "build")
    assert hasattr(c.reference(), "build")
    assert set(c.limits) >= {"soft_rms_gap", "chip_gap", "valid_mismatch",
                             "telemetry_mismatch"}
    assert {m["name"] for m in c.end_to_end} == {
        "rt_channels", "block_ms_p95", "peak_mem_gib", "setup_s"}
    for m in c.per_layer:
        assert callable(catalog.metric_reader(m["name"]))


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        catalog.Cell("no-such.cell")
