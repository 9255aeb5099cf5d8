"""Everything the harness finds by name.

``BENCHMARK.json`` at the root of the checkout lists the cells, the
configurations and the metrics. A cell names a configuration and a
traffic mix; the harness then reads:

- ``benchmark/configs/<config>.json`` (the ``file`` of the configuration
  entry): the sizes, the ``entry`` (an adapter module in
  ``benchmark/systems/``) and the ``reference`` (a module in
  ``benchmark/reference/``);
- ``benchmark/traffic/<traffic>.json``: the parameters of the mix, whose
  ``generator`` names a module in ``benchmark/gen/``;
- ``benchmark/limits/<cell>.json``: the limits of the numbers that decide
  ``correct``;
- ``benchmark/metrics/<metric>.py``: one reader per per-layer metric.
"""

from __future__ import annotations

import importlib
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its files loaded."""

    def __init__(self, name: str, root: str = ROOT):
        bench = _load(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                           f"{sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = _load(os.path.join(root, self.config_entry["file"]))
        here = os.path.join(root, "benchmark")
        self.traffic = _load(os.path.join(
            here, "traffic", self.workload["traffic"] + ".json"))
        self.limits = _load(os.path.join(here, "limits", name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.chips = int(self.workload["chips"])

    def generator(self):
        return module("gen", self.traffic["generator"])

    def system(self):
        return module("systems", self.config["entry"])

    def reference(self):
        return module("reference", self.config["reference"])


def module(kind: str, name: str):
    return importlib.import_module(f"benchmark.{kind}.{name}")


def metric_reader(name: str):
    """The ``read(record)`` of ``benchmark/metrics/<name>.py`` (loaded by
    its path, so a metric's name may hold dots)."""
    import importlib.util

    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
