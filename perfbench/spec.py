"""BENCHMARK.json and the files it names, found by name: a cell's
configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``), the limits of its correctness check
(``cells/<cell>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``, a module with ``read(ctx)``)."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Callable, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Spec:
    def __init__(self, root: str = ROOT):
        path = os.path.join(root, "BENCHMARK.json")
        with open(path) as fh:
            self.bench = json.load(fh)
        self.root = root
        self.cells = {w["name"]: w for w in self.bench["workloads"]}
        self.configs = {c["name"]: c for c in self.bench["configs"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: "
                           f"{', '.join(self.cells)})")
        return self.cells[name]

    def config(self, cell: dict) -> dict:
        entry = self.configs[cell["config"]]
        return _load(os.path.join(self.root, entry["file"]))

    def traffic(self, cell: dict) -> dict:
        return _load(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))

    def limits(self, cell: dict) -> dict:
        return _load(os.path.join(HERE, "cells", cell["name"] + ".json"))

    def metrics(self, cell: dict, trace: bool) -> List[dict]:
        """The metrics a run of ``cell`` reports: its end-to-end ones, or
        with ``trace`` its per-layer ones."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[key]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, metric: str) -> Callable[[dict], object]:
        """``read(ctx)`` of metrics/<metric>.py: the metric's value, or
        None where the run gave it nothing to read."""
        path = os.path.join(HERE, "metrics", metric + ".py")
        modname = "perfbench_metric_" + re.sub(r"\W", "_", metric)
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)
