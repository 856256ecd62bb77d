"""The harness on the CPU at a size a test run holds: the rate and memory
arithmetic, that a window calls only contigs no earlier call read, that
no banned module loads, and that a run catches each fault the cells can
have (the exchange between chips has no place on one chip), while the
same run unbroken reads correct.  A configuration that plants tandem
repeats is judged by its loci too, and not at all without a limit for
them.  The control's readings on a small contig.  The faults plant
themselves under the timed path
(perfbench/capture.py); the harness's look for a card is skipped by
running on ``device="cpu"``, where the kernels' plain versions serve."""

import contextlib
import io
import os
import subprocess
import sys

import pytest

from perfbench import gen, memsample, run
from perfbench.spec import ROOT, Spec
from perfbench.tests import truth_vcf as tv
from perfbench.tests.test_bench_gen import TR_TEST

# the in-process path: the region traffic (no cell of BENCHMARK.json
# runs it yet) on the HiFi configuration
REGION = {"name": "hifi.region", "config": "hifi_hg002_30x",
          "traffic": "region", "chips": 1}
# the region traffic sends every pair past one DP cell to the aligner's
# kernels (their plain versions on the CPU); the pool routes as
# calibrated, which on the CPU sends none (test_pool_window_reads_correct
# sends them all, as the region traffic does)
TINY = {
    "region": {"contig_len": 60_000, "contigs": 3,
               "opts": {"window_size": 30_000}},
    "genome": {"contig_len": 120_000, "contigs": 2,
               "cli": ["--host-procs", "2"],
               "opts": {"window_size": 30_000, "procs_use_device": True}},
}
# a 60 kb contig has most of its variants near a window or contig edge:
# the sound tiny runs read rec_err 0.03-0.11, a window left out ~0.5
TINY_REC_ERR = 0.25
TINY_CONSTANTS = {"GEN_PROCS": 3, "EM_EVERY": 1, "HOST_PAIR_CELLS": 200_000,
                  "DEVICE_PAIR_CELLS": 200_000, "MIN_DEVICE_PAIRS": 3}


class TinySpec(Spec):
    def __init__(self):
        super().__init__()
        self.cells = dict(self.cells, **{REGION["name"]: REGION})

    def traffic(self, cell):
        t = dict(super().traffic(cell))
        t.update(TINY[cell["traffic"]])
        return t

    def limits(self, cell):
        return {"limits": {"rec_err": TINY_REC_ERR, "aln_bad": 0,
                           "em_bad": 0}}


@contextlib.contextmanager
def tiny_constants():
    old = {k: getattr(run, k) for k in TINY_CONSTANTS}
    for k, v in TINY_CONSTANTS.items():
        setattr(run, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(run, k, v)


def _run(cell, fault="", seconds=0.5, seed=20261017):
    s = TinySpec()
    with tiny_constants():
        return run.run_cell(s, s.cell(cell), seed, seconds, False,
                            device="cpu", fault=fault)


def test_contig_seeds_never_repeat():
    a = run.contig_seeds(2**31 + 7, 9)
    b = run.contig_seeds(-3, 9)
    for seeds in (a, b):
        used = set(seeds) | {s + 1 for s in seeds}
        assert len(used) == 18 and min(seeds) >= 0


def test_read_rate():
    calls = [{"t0": 10.0, "t1": 12.0, "contig": {"read_bases": 3_000_000}},
             {"t0": 12.5, "t1": 16.0, "contig": {"read_bases": 5_000_000}}]
    assert run.read_rate(calls) == pytest.approx(8.0 / 6.0)
    assert run.read_rate([]) is None


def test_memory_peak_is_taken_over_the_first_calls():
    calls = [{"t1": 10.0}, {"t1": 20.0}, {"t1": 30.0}]
    samples = [(5.0, 100), (15.0, 300), (19.0, 200), (25.0, 900),
               (31.0, 950)]
    assert run.mem_peak(samples, calls, 2) == 300
    assert run.mem_peak(samples, calls, 3) == 900
    assert run.mem_peak(samples, calls[:1], 2) == 100
    assert run.mem_peak(samples, [], 2) == 0


def test_memory_sample_counts_anonymous_memory_once_per_process():
    code = ("import sys, time; b = bytearray(300 << 20); "
            "sys.stdout.write('up\\n'); sys.stdout.flush(); time.sleep(30)")
    kids = [subprocess.Popen([sys.executable, "-c", code],
                             stdout=subprocess.PIPE, text=True)
            for _ in range(2)]
    try:
        for k in kids:
            assert k.stdout.readline().strip() == "up"
        parts = [memsample.smaps_kb(k.pid) for k in kids]
        anon = sum(a for _, a in parts)
        assert anon >= 2 * 300 * 1024
        mine = memsample.smaps_kb(os.getpid())
        want = (anon + mine[1]) * 1024 + max(
            r - a for r, a in parts + [mine]) * 1024
        # sample() leaves out the process that samples: run it in a child
        out = subprocess.run(
            [sys.executable, "-c", "import sys; from perfbench import "
             f"memsample; print(memsample.sample({os.getpid()}))"],
            capture_output=True, text=True, cwd=ROOT, timeout=60)
        got = int(out.stdout.strip())
        assert abs(got - want) < 64 << 20
    finally:
        for k in kids:
            k.kill()
            k.wait()


def test_region_window_calls_fresh_contigs_and_reads_correct():
    res, checks = _run("hifi.region", seconds=60)
    assert res["correct"], checks
    called = res["contigs"]["window"]
    assert len(called) == 3 == len(set(called))
    assert not set(called) & set(res["contigs"]["warm_up"])
    assert set(res["metrics"]) == {"read_mbp_per_s", "peak_host_mem_gib",
                                   "setup_s"}
    assert res["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell,fault,check", [
    ("hifi.region", "em_unchanged", "em_bad"),
    ("hifi.region", "answer_altered", "aln_bad"),
    ("hifi.region", "half_windows", "rec_err"),
    ("hifi.genome", "em_unchanged", "em_bad"),
    ("hifi.genome", "answer_altered", "em_bad"),
    ("hifi.genome", "half_windows", "rec_err"),
])
def test_a_planted_fault_reads_not_correct(cell, fault, check):
    res, checks = _run(cell, fault)
    assert res["correct"] is False
    bad = {c["name"] for c in checks if c["value"] > c["limit"]}
    assert check in bad, checks


def test_pool_window_reads_correct(monkeypatch):
    monkeypatch.setitem(TINY, "genome", dict(
        TINY["genome"], cli=["--host-procs", "2", "--device-min-cells", "1"]))
    res, checks = _run("hifi.genome")
    assert res["correct"], checks
    assert len(res["contigs"]["window"]) == 1
    # the workers kept device-routed pairs and wrote them as they exited
    assert {c["name"]: c["value"] for c in checks}[
        "aln_device_pairs_missing"] == 0


def test_too_few_device_pairs_reads_not_correct(monkeypatch):
    """A window whose aligner sent too few pairs to the band kernels has
    not had those kernels judged."""
    monkeypatch.setitem(TINY_CONSTANTS, "MIN_DEVICE_PAIRS", 10 ** 6)
    res, checks = _run("hifi.region")
    assert res["correct"] is False
    bad = {c["name"] for c in checks if c["value"] > c["limit"]}
    assert bad == {"aln_device_pairs_missing"}, checks


# the repeat model of the tests, denser, so that tiny contigs hold tens of
# loci; its sound tiny runs read tr_err 0
TINY_TR = dict(TR_TEST, loci_per_mb=600)
TINY_TR_ERR = 0.1


class RepeatSpec(TinySpec):
    """The tiny cells on the HiFi configuration with tandem repeats."""

    def config(self, cell):
        cfg = dict(super().config(cell))
        cfg["genome"] = dict(cfg["genome"], tandem_repeats=TINY_TR)
        return cfg

    def limits(self, cell):
        lim = super().limits(cell)["limits"]
        return {"limits": dict(lim, tr_err=TINY_TR_ERR)}


def _repeat_call(seed=20261017, length=120_000):
    """A call whose records are the truth of a tiny repeat contig."""
    cfg = RepeatSpec().config({"config": "hifi_hg002_30x"})
    ref4, truth = gen.genome_truth(seed, length, cfg["reads"],
                                   cfg["genome"])
    vcf = "\n".join(tv.truth_lines(truth, ref4)) + "\n"
    return cfg, {"contig": {"seed": seed, "length": length}, "vcf": vcf,
                 "em_launches": 1}


def test_judge_refuses_a_repeat_cell_without_a_tr_err_limit(tmp_path):
    cfg, call = _repeat_call()
    with pytest.raises(KeyError, match="tr_err"):
        run.judge(cfg, {"rec_err": 0.004, "aln_bad": 0, "em_bad": 0},
                  [call], str(tmp_path), False, 1)
    checks = {c["name"]: c for c in run.judge(
        cfg, {"rec_err": 0.004, "aln_bad": 0, "em_bad": 0, "tr_err": 0.01},
        [call], str(tmp_path), False, 1)}
    assert checks["tr_err"] == {"name": "tr_err", "value": 0.0,
                                "limit": 0.01}
    assert checks["rec_err"]["value"] == 0.0


def _alter_records(text: str) -> str:
    """Every record that changes the length by 2 bp or more, one base
    short of it."""
    out = []
    for ln in text.splitlines(keepends=True):
        f = ln.split("\t")
        if not ln.startswith("#") and len(f) > 4 and \
                abs(len(f[3]) - len(f[4])) >= 2:
            k = 3 if len(f[3]) > len(f[4]) else 4
            f[k] = f[k][:-1]
        out.append("\t".join(f))
    return "".join(out)


@pytest.mark.parametrize("altered", [False, True])
def test_a_repeat_cell_reads_its_loci(monkeypatch, altered):
    """The program's own records of tiny repeat contigs (the pool, on the
    host) read tr_err 0; the same records altered where the program
    writes them read not correct, by tr_err among others."""
    from longcalld_torch.core import pipeline
    real = pipeline.run_call

    def run_call(opt, out, **kw):
        buf = io.StringIO()
        n = real(opt, buf, **kw)
        out.write(_alter_records(buf.getvalue()))
        return n

    if altered:
        monkeypatch.setattr(pipeline, "run_call", run_call)
    s = RepeatSpec()
    with tiny_constants():
        res, checks = run.run_cell(s, s.cell("hifi.genome"), 20261017, 60,
                                   False, device="cpu")
    got = {c["name"]: c for c in checks}
    bad = {c["name"] for c in checks if c["value"] > c["limit"]}
    if altered:
        assert res["correct"] is False and "tr_err" in bad, checks
    else:
        # on the host the pool routes no pair to the card's kernels
        assert bad == {"aln_device_pairs_missing"}, checks
        assert got["tr_err"]["value"] == 0.0


class _Aligner:
    use_device = True


@pytest.mark.parametrize("inner,want", [
    (("dev", 3), [0, 2, 5]),
    (("split", 3, [0], "host work", [1, 2], ("dev",)), [2, 5]),
    (("host", []), []),
    (("empty",), []),
])
def test_device_rows_follow_the_aligners_routing(inner, want):
    from perfbench import capture
    token = ("memo", 7, [], {}, [0, 2, 5], inner, {})
    assert capture._device_rows(_Aligner(), token) == want
    host_only = _Aligner()
    host_only.use_device = False
    assert capture._device_rows(host_only, token) == []


def test_no_banned_module_loads():
    code = (
        "import sys; sys.path.insert(0, {root!r}); "
        "from perfbench.tests.test_bench_harness import _run; "
        "from perfbench import run; _run('hifi.region'); "
        "print(','.join(run.banned_modules()) or 'none')"
    ).format(root=ROOT)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "none"


# two windows of a 600 kb contig: interior enough that leaving half the
# reads out shows in the records of three seeds together
CONTROL = {"contig_len": 600_000, "cli": ["-r", "chr1"], "opts": {}}


class ControlSpec(TinySpec):
    def traffic(self, cell):
        t = dict(Spec.traffic(self, cell))
        t.update(CONTROL)
        return t


def _control_rows(device):
    from perfbench import control
    s = ControlSpec()
    with tiny_constants():
        run.GEN_PROCS = 4
        return control.readings(s, s.cell("hifi.region"), [31, 32, 33], 3,
                                device=device)


def _assert_control_fails(rows):
    """The program is exact on every seed; the control (the same contigs
    at half their coverage) reads more record errors over the three, and
    the fault "state left unchanged" (the EM stopped before its first
    round) differs on every sampled EM."""
    assert len(rows) == 3
    for r in rows:
        assert r["aln_bad"] == 0 and r["em_bad"] == 0
        assert r["control_aln_bad"] >= r["aln_bad"]
        assert r["fault_unchanged_em_bad"] == r["control_ems"] > 0
    assert sum(r["control_rec_err"] for r in rows) > \
        2 * sum(r["rec_err"] for r in rows)


def test_control_reads_worse_than_the_program():
    _assert_control_fails(_control_rows("cpu"))


@pytest.mark.chip
def test_control_reads_worse_than_the_program_on_the_card(card):
    _assert_control_fails(_control_rows(card))
