"""BENCHMARK.json keeps to the benchmark's contract, and every cell finds
its configuration, traffic, limits and metric readers by name."""

import json
import os
import re

import pytest

from perfbench import spec as spec_mod

ROOT = spec_mod.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert all(not p.startswith("/") and ".." not in p and
               os.path.isdir(os.path.join(ROOT, p)) for p in bench["paths"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10
    # a full check of 24 cells fits its time
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_entries_keep_their_keys_and_names(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    every = bench["configs"] + bench["workloads"] + bench["end_to_end"] \
        + bench["per_layer"]
    for e in every:
        assert NAME.match(e["name"]), e["name"]
        assert "unit" not in e or UNIT.match(e["unit"])
        assert e.get("better", "lower") in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
    metric_names = [m["name"] for m in bench["end_to_end"] +
                    bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_every_cell_resolves_its_files():
    s = spec_mod.Spec()
    used = set()
    for name, cell in s.cells.items():
        used.add(cell["config"])
        cfg, traffic, lim = s.config(cell), s.traffic(cell), s.limits(cell)
        assert cfg["name"] == cell["config"]
        assert traffic["name"] == cell["traffic"]
        assert {"rec_err", "aln_bad", "em_bad"} <= set(lim["limits"])
        e2e = [m["name"] for m in s.metrics(cell, trace=False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = s.metrics(cell, trace=True)
        assert per_layer
        for m in per_layer:
            assert callable(s.reader(m["name"]))
    assert used == set(s.configs)


def test_per_layer_workloads_name_cells(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
