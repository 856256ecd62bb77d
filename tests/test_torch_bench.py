"""bench_torch.py, the port's end-to-end bench, against bench.py (loaded
with importlib, as tests/test_bench_watchdog.py loads it), and the dry
run's device rule (longcalld_torch/entry.py:dryrun_mesh).

* _body and _canon give bench.py's output on a phased body with flipped
  PS blocks; baseline_bracket gives bench.py's low/mid/high (bench.py:
  734-795) for fixed walls, bins and cells, worked out by hand.
* The bench's configurations and turns run on a seeded 200 kb contig on
  CPU tensors: one round, host_procs=2 for both pool configurations
  (four 50 kb windows: the smallest case in which the pool engages,
  checked by the pool_calls spy).  Launch counts
  stay 0 on CPU tensors (ops/band.py counts launches on the card only),
  so the forced configuration is checked by its dispatches and device
  DP cells.  Without CUDA and without a device the bench raises; in a
  process that refuses jax and longcalld_tpu its module loads.
* tests/torch_helpers.py's evaluate_f1 and classify_fn_causes give the
  same dicts as tests/synthcontig.py's and tests/fnclassify.py's on the
  same contig with records dropped from the body (false negatives).

Tolerance: exact (dicts, VCF lines); the bracket to 1e-12 relative.
"""

import importlib.util
import io
import math
import os
import subprocess
import sys

import pytest
import torch

from longcalld_torch import entry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import bench_torch  # noqa: E402
from torch_helpers import build_contig, contig_truth, pool_calls  # noqa: E402

SEED, LENGTH = 12, 200_000           # tests/test_torch_cli.py:28's contig


@pytest.fixture(scope="module")
def bench_py():
    spec = importlib.util.spec_from_file_location(
        "bench_py_under_test", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def contig(tmp_path_factory):
    return build_contig(tmp_path_factory.mktemp("torch_bench"), SEED,
                        LENGTH)[:2]


def _phased_body():
    """Two PS blocks, the second starting 1|0, plus an unphased record and
    a ## line that _body drops."""
    fmt = "GT:DP:AD:VAF:GQ:PS"
    rows = [("100", "0|1:30:15,15:0.500:60:100"),
            ("200", "1|0:31:15,16:0.516:60:100"),
            ("300", "1|1:30:0,30:1.000:60:300"),
            ("400", "1|0:29:14,15:0.517:60:400"),
            ("500", "0|1:30:15,15:0.500:60:400"),
            ("600", "0/1:12:6,6:0.500:20")]
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"]
    for pos, sample in rows:
        f = fmt if sample.count(":") == 5 else fmt.rsplit(":", 1)[0]
        lines.append(f"chr1\t{pos}\t.\tA\tC\t60\tPASS\t.\t{f}\t{sample}")
    return "\n".join(lines) + "\n"


def test_body_and_canon_match_bench_py(bench_py):
    vcf = _phased_body()
    body = bench_torch._body(vcf)
    assert body == bench_py._body(vcf) and len(body) == 7
    canon = bench_torch._canon(body)
    assert canon == bench_py._canon(body)
    assert canon != body                 # the 1|0 block was flipped
    # the whole PS 400 block the other way round: the same canonical body
    flipped = [_swap_gt(ln) if ln.endswith(":400") else ln for ln in body]
    assert flipped != body
    assert bench_torch._canon(flipped) == canon == bench_py._canon(flipped)


def _swap_gt(line):
    f = line.split("\t")
    a, rest = f[9].split(":", 1)
    x, y = a.split("|")
    f[9] = f"{y}|{x}:{rest}"
    return "\t".join(f)


# (walls t1, t_procs; bins; cells over n_w passes) -> low, high by hand
# from bench.py:734-795: low = mbp / (1.6 t1), high = mbp * min(3,
# total / busiest bin) / (0.8 t1), mid = sqrt(low * high)
CELLS = {"model_wf_cells": 1000, "model_poa_cells": 500,
         "cells_host_band_exec": 300, "cells_host_full_exec": 200,
         "cells_host_greedy_exec": 100}


@pytest.mark.parametrize("t1, t_procs, bins, low, high, speedup, par", [
    (20.0, 8.0, {0: 6_000_000, 1: 4_000_000}, 10 / 32, 10 * (5 / 3) / 16,
     2.5, 5 / 3),
    (20.0, 2.0, {k: 1_000_000 for k in range(10)}, 10 / 32, 10 * 3 / 16,
     3.0, 10.0),
    (5.0, 8.0, {}, 10 / 8, 10 / 4, 1.0, 1.0),
])
def test_baseline_bracket_by_hand(t1, t_procs, bins, low, high, speedup,
                                  par):
    b = bench_torch.baseline_bracket(10.0, 10_000_000, bins, t1, t_procs,
                                     CELLS, 2)
    approx = lambda v: pytest.approx(v, rel=1e-12)  # noqa: E731
    assert b["low_mbp_s"] == approx(low)
    assert b["high_mbp_s"] == approx(high)
    assert b["mid_mbp_s"] == approx(math.sqrt(low * high))
    assert b["my_thread_speedup"] == approx(speedup)
    assert b["ref_chunk_parallelism"] == approx(par)
    assert b["ref_scale_credit_high"] == approx(min(3.0, par))
    assert (b["ref_wavefront_model_cells"], b["ref_poa_band_model_cells"],
            b["cells_executed"]) == (500, 250, 300)
    assert b["exec_over_wf_model"] == approx(0.6)


@pytest.fixture(scope="module")
def cpu_run(contig):
    """One round of the bench's turns on CPU tensors, with the legs that
    exist only on a card skipped and the F1 and WGS legs switched off."""
    from longcalld_torch.core import pipeline
    env = {k: os.environ.get(k) for k in ("LONGCALLD_BENCH_F1",
                                          "LONGCALLD_BENCH_WGS")}
    os.environ.update(LONGCALLD_BENCH_F1="0", LONGCALLD_BENCH_WGS="0")
    # the kernels' plain versions launch many small ops: beside the other
    # test processes, intra-op threads would only contend
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pool_calls(pipeline) as calls:
            out = bench_torch.run(*contig, torch.device("cpu"), rounds=1,
                                  pool_procs=2)
    finally:
        torch.set_num_threads(threads)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out, calls


def test_cpu_run_json_line(cpu_run):
    out, _ = cpu_run
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert out["metric"] == "synth2mb_hifi_e2e_throughput"
    assert out["unit"] == "Mbp/s" and out["value"] > 0
    assert out["vs_baseline"] > 0
    d = out["detail"]
    assert set(d["configs"]) == set(bench_torch.CONFIGS)
    assert d["best_config"] in bench_torch.HEADLINE
    assert d["device"]["device"] == "cpu" and d["device"]["cpu_count"]
    assert d["kernels"] is d["profiled_forced_pass"] is None
    assert d["f1_synth_20mb"] is d["wgs_100mb_streaming"] is None
    assert d["workload"]["aligned_bp"] > 0
    assert d["orders"] == [list(bench_torch.CONFIGS)]
    b = d["baseline_bracket_mbp_s"]
    assert b["low_mbp_s"] < b["mid_mbp_s"] < b["high_mbp_s"]


def test_cpu_run_pool_engaged(cpu_run):
    """Both pool configurations take the pool (4 windows over 2 workers)
    in their warm-up and timed passes."""
    assert cpu_run[1] == [(4, 2)] * 4


def test_cpu_run_walls_and_spread(cpu_run):
    for name, c in cpu_run[0]["detail"]["configs"].items():
        assert c["passes"] == len(c["all_s"]) == 1, name
        assert c["mean_s"] == c["best_s"] == c["median_s"] == c["all_s"][0]
        assert c["spread"] == 0.0 and c["warmup_s"] > 0
        assert c["mbp_per_s"] > 0


def test_cpu_run_forced_reaches_the_device_path(cpu_run):
    """device_forced at threshold 1: its pairs go through the kernel
    wrappers (their plain versions on CPU tensors); host_1t sends none."""
    cfg = cpu_run[0]["detail"]["configs"]
    cells = cfg["device_forced"]["aligned_dp_cells"]
    assert cells["n_dispatch"] > 0 and cells["cells_device"] > 0
    assert cfg["device_forced"]["device_share_of_dp_cells"] > 0
    assert cfg["device_forced"]["device_round_budget"]["rounds_per_pass"] > 0
    assert cfg["host_1t"]["aligned_dp_cells"]["cells_device"] == 0
    assert cfg["procs"]["aligned_dp_cells"].get("cells_device", 0) == 0


def test_cpu_run_bodies_equal(cpu_run):
    """The bench asserted its equalities (it raises otherwise); the record
    counts it reports are those of the contig."""
    v = cpu_run[0]["detail"]["vcf"]
    assert v["records_500kb"] > 10 and v["records_50kb"] > 10
    assert v["canon_records_differing"] >= 0


def test_bench_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench_torch.main([])


_REFUSING_IMPORT = r"""
import importlib.abc, sys

REFUSED = ("jax", "jaxlib", "longcalld_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(name + " is refused in this process")
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, "tests")
import bench_torch
import torch_helpers
assert callable(bench_torch.main) and callable(torch_helpers.evaluate_f1)
assert not any(m.split(".")[0] in REFUSED for m in sys.modules)
"""


def test_bench_loads_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _REFUSING_IMPORT],
                          capture_output=True, text=True, env=env,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_dryrun_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        entry.dryrun_multichip(2)


@pytest.mark.parametrize("count, n, want", [
    (1, 4, [0, 0, 0, 0]), (2, 4, [0, 1, 0, 1]), (4, 2, [0, 1]),
    (8, 3, [0, 1, 2])])
def test_dryrun_mesh_on_visible_cards(monkeypatch, count, n, want):
    """Without devices or device the mesh is the visible cards, repeated
    round-robin where fewer than n are visible (counts patched)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert entry.dryrun_mesh(n) == [torch.device("cuda", k) for k in want]
    assert entry.dryrun_mesh(n, device="cpu") == [torch.device("cpu")] * n
    given = ["cpu"] * n
    assert entry.dryrun_mesh(n, devices=given) == [torch.device("cpu")] * n


def test_f1_copies_equal_originals(contig):
    """evaluate_f1 and classify_fn_causes of tests/torch_helpers.py against
    tests/synthcontig.py's and tests/fnclassify.py's, with every 8th record
    dropped from the body so that false negatives exist."""
    import fnclassify
    import synthcontig
    import torch_helpers as th

    from longcalld_torch.config import CallOpts as TOpts
    from longcalld_torch.core import pipeline as tpl
    from longcalld_torch.io.fasta import FastaFile as TFasta
    from longcalld_tpu.config import CallOpts as JOpts
    from longcalld_tpu.core import pipeline as jpl
    from longcalld_tpu.io.fasta import FastaFile as JFasta

    fa, bam = contig
    ref4, truth = contig_truth(SEED, LENGTH)
    beg, end = 2_000, LENGTH - 2_000
    kw = dict(ref_fa_fn=fa, in_bam_fns=[bam], use_device=False, host_procs=0,
              n_threads=2)
    buf = io.StringIO()
    tpl.run_call(TOpts.hifi(**kw), buf, "t")
    body = [ln for k, ln in enumerate(th.vcf_body(buf.getvalue()))
            if k % 8 != 3]
    got = th.evaluate_f1(body, truth, beg, end, ref4, return_fns=True)
    want = synthcontig.evaluate_f1(body, truth, beg, end, ref4,
                                   return_fns=True)
    assert got == want
    fns = got[1]
    assert sum(len(v) for v in fns.values()) >= 5
    causes = th.classify_fn_causes(TOpts.hifi(**kw), TFasta(fa),
                                   [tpl._open_aln(bam, fa)], fns, "chr1",
                                   LENGTH)
    assert causes == fnclassify.classify_fn_causes(
        JOpts.hifi(**kw), JFasta(fa), [jpl._open_aln(bam, fa)], fns, "chr1",
        LENGTH)
    assert causes["total_fns"] == sum(len(v) for v in fns.values())
