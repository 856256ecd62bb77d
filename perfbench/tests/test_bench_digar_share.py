"""The reader of digar.native_read_share: from the pool's shipped
counters and from the process's own counts, None without counters and
on a program without the native digar pass, and read by a traced tiny
run of the pool cell on the CPU, where every read takes the native
pass."""

import pytest

from longcalld_torch.core import digar
from perfbench import run
from perfbench.spec import Spec
from perfbench.tests.test_bench_harness import TINY, TinySpec, tiny_constants

NAME = "digar.native_read_share"


def _ctx(in_process=False, counters=None):
    return {"t0_ns": 0, "t1_ns": 1, "mb_called": 1.0, "events": None,
            "in_process": in_process, "aligner": {},
            "counters": counters or {}, "stages": {},
            "band_fwd_launches": []}


@pytest.fixture
def counts(monkeypatch):
    """The process's counts from 0 for the test."""
    monkeypatch.setattr(digar, "_read_counts", {"digar_native_reads": 0,
                                                "digar_python_reads": 0})


@pytest.mark.parametrize("native,python,want", [(800, 0, 1.0),
                                                (600, 200, 0.75),
                                                (0, 5, 0.0)])
def test_pool_counters(native, python, want):
    shipped = {"aln_digar_native_reads": native, "aln_cells_host": 7,
               "aln_digar_native_reads_w0": native}
    if python:
        shipped["aln_digar_python_reads"] = python
    assert Spec().reader(NAME)(_ctx(counters=shipped)) == want


@pytest.mark.parametrize("native,python,want", [(800, 0, 1.0),
                                                (300, 100, 0.75)])
def test_in_process_counts(counts, native, python, want):
    digar._count_reads(native, python)
    assert Spec().reader(NAME)(_ctx(in_process=True)) == want


@pytest.mark.parametrize("in_process", [True, False])
def test_none_without_counters(counts, in_process):
    assert Spec().reader(NAME)(_ctx(in_process=in_process)) is None


def test_none_on_a_program_without_the_native_pass(counts, monkeypatch):
    digar._count_reads(800, 0)
    monkeypatch.delattr(digar, "read_counts")
    read = Spec().reader(NAME)
    assert read(_ctx(in_process=True)) is None
    assert read(_ctx(counters={"aln_cells_host": 7})) is None


def test_traced_tiny_pool_run_reads_one(monkeypatch):
    monkeypatch.setitem(TINY, "genome", dict(
        TINY["genome"],
        cli=["--host-procs", "2", "--device-min-cells", "20000"]))
    s = TinySpec()
    with tiny_constants():
        res, checks = run.run_cell(s, s.cell("hifi.genome"), 4_000_000_019,
                                   0.5, True, device="cpu")
    assert res["correct"], checks
    assert res["metrics"][NAME] == {"value": 1.0, "unit": "ratio"}
