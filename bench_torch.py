#!/usr/bin/env python3
"""End-to-end benchmark of longcalld_torch on one CUDA card: the port of
bench.py.

    python3 bench_torch.py                      # on cuda:0
    python3 bench_torch.py --device cuda:1 --seed 2026
    LONGCALLD_BENCH_F1=0 LONGCALLD_BENCH_WGS=0 python3 bench_torch.py

Progress goes to stderr; stdout gets ONE JSON line in bench.py's form,
{"metric", "value", "unit", "vs_baseline", "detail"}.  The bench imports
torch, numpy and longcalld_torch (and tests/torch_helpers.py, chip_smoke.py
for the workload generator, the kernel bounds and the timers), never jax or
the JAX package, and writes nothing into the repo but the kernels' build
directory (build/longcalld_torch/, git-ignored).

Metric: aligned read megabases per second of the whole `call` (BAM ->
digars -> candidates -> phasing -> noisy-region re-assembly with the
device alignment kernels -> VCF), the warm MEAN of the best configuration
(every one but the host_1t anchor).  The workload is chip_smoke.py's
seeded 2 Mb diploid contig (chip_smoke.py:build_workload: seed 2026, 30x,
15 kb reads), built into a temporary directory: bench.py's HG002 chr11
files are not in the repo.  Aligned Mbp = the sum of l_seq over the
contig's reads (bench.py:583-586).

Configurations (bench.py:609-689, the same CallOpts fields; call_configs):
  device_auto    500 kb windows in-process, calibrated routing; its first
                 pass is wall_cold_s (bench.py:617-620), the kernel build
                 timed apart beside it;
  device_forced  the same with device_min_cells=FORCED_MIN_CELLS (1): every
                 pair goes to the card but those whose band bucket is
                 above 512, which stay on the host at any threshold
                 (longcalld_torch/ops/wfa.py:_submit_work); bench.py's
                 500000 sent no pair of this contig to the card;
  procs          50 kb windows over 4 host-only worker processes;
  procs_device   the same with procs_use_device: each worker runs the
                 kernels on the card with its own calibrated routing;
  host_1t        one thread, host only: the anchor of the C-baseline
                 bracket (baseline_bracket).

Timed passes run in turns (run_turns): one warm-up pass of each
configuration, then ROUNDS rounds, each running every configuration once
in an order that rotates from round to round (host_1t, the slowest, only
in the first HOST_1T_PASSES rounds).  Every aligner's memo is cleared
before each pass and every wall ends with torch.cuda.synchronize().
Asserted: VCF bodies byte-equal across all passes of one configuration,
across device_auto, device_forced and host_1t, and across procs and
procs_device.  bench.py's _canon check of the 50 kb bodies against the
500 kb body (:674-676) is reported, not asserted: on this contig a record
next to a 50 kb window edge counts one read more or less in DP and AD
under either package, so the count of differing records is a finding.

Legs: the kernel leg (kernel_leg: band_fwd and band_bwd at bench.py's
microbench shape, and the full aligner path), one profiled forced pass
(the card's busy share of the wall), the F1 leg (f1_leg; LONGCALLD_BENCH_F1=0
skips it) and the WGS leg (wgs_leg; LONGCALLD_BENCH_WGS=0 skips it).

No fallback: without CUDA and without ``--device cpu`` the bench raises;
a failed kernel build or launch, a failed leg or an inequality ends it
with a non-zero exit.  A CPU device (the tests' small run) skips the
kernel leg and the profiled pass, whose numbers exist only on a card.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

import chip_smoke

ROOT = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 5                  # timed rounds after the warm-up pass
HOST_1T_PASSES = 3          # host_1t sits out the later rounds
# device_forced's routing threshold: the card carries the DP cells, as
# bench.py's device_forced intends (at bench.py's 500000 no pair of the
# 2 Mb contig qualifies, and no kernel launches)
FORCED_MIN_CELLS = 1
BIN_BP = 500_000            # the reference's kt_for chunk (bench.py:737)
CONFIGS = ("device_auto", "device_forced", "procs", "procs_device",
           "host_1t")
HEADLINE = ("device_auto", "device_forced", "procs", "procs_device")


def _body(vcf: str):
    """bench.py:_body: the VCF minus its ## meta lines."""
    return [ln for ln in vcf.splitlines() if not ln.startswith("##")]


def _canon(body):
    """bench.py:_canon: flips every PS block so that its first phased
    record reads 0|1 (the per-block phase orientation is arbitrary where
    the window size differs)."""
    flip = {}
    out = []
    for ln in body:
        if ln.startswith("#"):
            out.append(ln)
            continue
        f = ln.split("\t")
        keys = f[8].split(":")
        vals = f[9].split(":")
        d = dict(zip(keys, vals))
        gt = d.get("GT", "")
        if "PS" in d and "|" in gt:
            ps = d["PS"]
            if ps not in flip:
                a0, b0 = gt.split("|")
                flip[ps] = int(a0) > int(b0)
            if flip[ps]:
                a, b = gt.split("|")
                d["GT"] = f"{b}|{a}"
                f[9] = ":".join(d[k] for k in keys)
        out.append("\t".join(f))
    return out


def _log(msg: str) -> None:
    print(f"bench_torch: {msg}", file=sys.stderr, flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def device_info(dev) -> dict:
    """The device the numbers were taken on: for a card its nvidia-smi
    name and power limit, SM clocks, torch and CUDA versions and the
    host's core count."""
    import torch
    info = {"device": str(dev), "torch": torch.__version__,
            "cuda": torch.version.cuda, "cpu_count": os.cpu_count()}
    if dev.type == "cuda":
        info.update({
            "name_power_limit": chip_smoke.nvidia_smi("name,power.limit"),
            "kind": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(),
            "sm_clock": chip_smoke.nvidia_smi("clocks.sm"),
            "sm_clock_max": chip_smoke.nvidia_smi("clocks.max.sm")})
    return info


def aligned_bp(bam_fn: str):
    """(total aligned bp, {500 kb bin: bp}) over every read of the BAM,
    as bench.py:583-586 and :736-739 count them."""
    from longcalld_torch.io.bam import BamReader
    bam = BamReader(bam_fn)
    total, bins = 0, {}
    for tid, length in enumerate(bam.lengths):
        for r in bam.fetch(tid, 0, length):
            total += r.l_seq
            bins[(tid, r.pos // BIN_BP)] = bins.get(
                (tid, r.pos // BIN_BP), 0) + r.l_seq
    return total, bins


def call_configs(fa: str, bam: str, pool_procs: int = -1) -> dict:
    """name -> CallOpts of each configuration (bench.py:616, :629-630,
    :662-663, :685-686; procs_device adds procs_use_device).  The pool
    configurations take ``pool_procs`` as host_procs (-1: follow -t 4)."""
    from longcalld_torch.config import CallOpts
    io_kw = dict(ref_fa_fn=fa, in_bam_fns=[bam])
    pool = dict(window_size=50_000, n_threads=4, host_procs=pool_procs)
    return {
        "device_auto": CallOpts.hifi(**io_kw),
        "device_forced": CallOpts.hifi(**io_kw,
                                       device_min_cells=FORCED_MIN_CELLS),
        "procs": CallOpts.hifi(**io_kw, **pool),
        "procs_device": CallOpts.hifi(**io_kw, **pool, procs_use_device=True),
        "host_1t": CallOpts.hifi(**io_kw, n_threads=1, host_procs=0,
                                 use_device=False),
    }


def clear_memos() -> None:
    """Every aligner's memo (bench.py:588-593): a pass reusing the last
    pass's alignment results would not happen on fresh windows."""
    from longcalld_torch.ops import wfa
    for al in wfa._ALIGNER_CACHE.values():
        al.memo_clear()


def _pool_counters() -> dict:
    """The pool's aln_* counters without the per-worker _w<k> keys
    (bench.py:679-682)."""
    from longcalld_torch.utils import counters
    return {k[4:]: v for k, v in counters.snapshot().items()
            if k.startswith("aln_") and not re.search(r"_w-?\d+$", k)}


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def _add(tot: dict, d: dict) -> None:
    for k, v in d.items():
        if isinstance(v, dict):
            _add(tot.setdefault(k, {}), v)
        else:
            tot[k] = tot.get(k, 0) + v


def timed_pass(opt, dev, audit: dict, pool: bool) -> tuple:
    """One pass of ``opt``: memos cleared, the wall from the call to the
    card's synchronize.  Adds the pass's aligner deltas (the pool's
    aln_* counters for a ``pool`` configuration, the workers' kernel
    launches among them), the parent's kernel launches (the EM kernel's
    beside the band kernels') and band launches by shape to ``audit``.
    Returns (wall, VCF body)."""
    from longcalld_torch.core.pipeline import run_call
    from longcalld_torch.ops import band, phase_kernel, wfa

    totals = _pool_counters if pool else wfa.aligner_totals
    clear_memos()
    band.reset_launch_counts()
    phase_kernel.reset_em_launch_counts()
    before = totals()
    buf = io.StringIO()
    _sync(dev)
    t0 = time.perf_counter()
    run_call(opt, buf, "bench_torch", device=dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    after = totals()
    _add(audit.setdefault("aligned_dp_cells", {}), _delta(after, before))
    _add(audit.setdefault("launches", {}), {
        **band.launch_counts(), **phase_kernel.em_launch_counts()})
    _add(audit.setdefault("launch_shapes", {}), band.launch_shapes())
    return wall, _body(buf.getvalue())


def wall_stats(walls) -> dict:
    """mean, median, best, every pass and the spread (max - min) / mean of
    a configuration's timed walls, in seconds."""
    mean = sum(walls) / len(walls)
    return {"mean_s": mean, "median_s": float(np.median(walls)),
            "best_s": min(walls), "all_s": list(walls), "passes": len(walls),
            "spread": (max(walls) - min(walls)) / mean}


def run_turns(cfgs: dict, dev, rounds: int = ROUNDS) -> dict:
    """The warm-up pass of every configuration, then ``rounds`` rounds in
    rotating order; returns per configuration its walls, bodies and audit
    (and device_auto's cold wall, procs_device's card memory)."""
    import torch
    from longcalld_torch.ops import wfa

    res = {name: {"walls": [], "bodies": [], "audit": {}} for name in cfgs}
    card_mem = dev.type == "cuda"
    if card_mem:
        free, total = torch.cuda.mem_get_info(dev)
        res["procs_device"]["card_mem_mib"] = {"before": (total - free)
                                               / 2**20, "peak": 0.0}

    def one_pass(name, audit):
        pool = name in ("procs", "procs_device")
        if not (card_mem and name == "procs_device"):
            return timed_pass(cfgs[name], dev, audit, pool)
        with chip_smoke.MemPeak(dev) as mem:
            out = timed_pass(cfgs[name], dev, audit, pool)
        mib = res[name]["card_mem_mib"]
        mib["peak"] = max(mib["peak"], mem.peak / 2**20)
        return out

    for name in cfgs:
        wall, body = one_pass(name, {})
        res[name]["bodies"].append(body)
        res[name]["warmup_s"] = wall
        _log(f"warm-up {name}: {wall:.3f} s, {len(body)} lines")
    res["device_auto"]["routing_min_cells"] = wfa.get_aligner(
        cfgs["device_auto"], dev).device_min_cells
    orders = []
    for r in range(rounds):
        order = [n for n in CONFIGS[r % len(CONFIGS):] + CONFIGS[
            :r % len(CONFIGS)] if n != "host_1t" or r < HOST_1T_PASSES]
        orders.append(order)
        for name in order:
            wall, body = one_pass(name, res[name]["audit"])
            res[name]["walls"].append(wall)
            res[name]["bodies"].append(body)
            _log(f"round {r} {name}: {wall:.3f} s")
    res["orders"] = orders
    return res


def profiled_pass(opt, dev, every_name: bool = False) -> dict:
    """One pass of ``opt`` under torch.profiler (not timed with the
    turns): the card's busy time is the union of the intervals of its
    device events, its share of the pass's wall the busy share.
    ``every_name`` adds each event name's ms and count, not only the top
    eight names' ms."""
    import torch
    from torch.autograd import DeviceType

    from longcalld_torch.core.pipeline import run_call

    clear_memos()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    _sync(dev)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_call(opt, io.StringIO(), "bench_torch", device=dev)
        _sync(dev)
        wall = time.perf_counter() - t0
    spans, by_name, count = [], {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t_s, t_e = e.time_range.start, e.time_range.end
        spans.append((t_s, t_e))
        # the kernel's name without its argument list
        name = re.sub(r"\s*\(.*", "", e.name.replace(
            "(anonymous namespace)::", ""))
        by_name[name] = by_name.get(name, 0.0) + (t_e - t_s) / 1e3
        count[name] = count.get(name, 0) + 1
    busy_us, end = 0.0, -1.0
    for t_s, t_e in sorted(spans):
        if t_e > end:
            busy_us += t_e - max(t_s, end)
            end = t_e
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    row = {"wall_s": wall, "device_events": len(spans),
           "busy_ms": busy_us / 1e3, "busy_share": busy_us / 1e6 / wall,
           "busy_ms_by_name": dict(ranked[:8])}
    if every_name:
        row["by_name"] = {k: {"ms": v, "events": count[k]}
                          for k, v in ranked}
    return row


def full_path_pairs(rng):
    """bench.py:230-236's 64 pairs: 2000 bp with 20 substitutions."""
    pairs = []
    for _ in range(64):
        p = rng.integers(0, 4, 2000).astype(np.uint8)
        t = p.copy()
        mut = rng.choice(2000, 20, replace=False)
        t[mut] = (t[mut] + 1) % 4
        pairs.append((p, t))
    return pairs


def kernel_leg(dev):
    """bench.py:_kernel_microbench on the card, at its shape (B 2048, Lp
    2000, batch 64, dlo = -B/2, random P and T from seed 0): CUDA-event ms
    of band_fwd (10 launches after a warm one) and band_bwd (queued behind
    a sleep kernel, chip_smoke.py:cuda_ms), DP cells/s = batch * (Lp + 1)
    * B / time (bench.py:188), each beside its bound
    (chip_smoke.py:fwd_bound, bwd_bound); then the full path, BatchAligner
    (device_min_cells=1).align_many on bench.py's 64 pairs, best of 3
    passes with the memo cleared, in product cells/s.  Returns (report,
    pairs, the full path's results)."""
    import torch

    from longcalld_torch.ops import band, wfa
    from longcalld_torch.ops.convert import from_numpy

    B, Lp, n = chip_smoke.BENCH_SHAPE
    rng = np.random.default_rng(0)
    P = rng.integers(0, 4, (n, Lp)).astype(np.int8)
    T = rng.integers(0, 4, (n, Lp + B + 512)).astype(np.int8)[:, :Lp + B]
    P, Tband, plen, tlen, dlo = from_numpy((
        P, np.ascontiguousarray(T), np.full(n, Lp, np.int32),
        np.full(n, Lp, np.int32), np.full(n, -B // 2, np.int32)), dev)
    dp = (B, Lp, chip_smoke.X, chip_smoke.O1, chip_smoke.E1, chip_smoke.O2,
          chip_smoke.E2)
    tbs, fin, _ = band.banded_dp(P, Tband, plen, tlen, dlo, *dp)
    fwd = chip_smoke.cuda_ms(
        lambda: band.banded_dp(P, Tband, plen, tlen, dlo, *dp), 10)
    bwd = chip_smoke.cuda_ms(lambda: band.backward_resolve(
        tbs, plen, tlen, dlo, fin, B, Lp), 10, queued=True)
    int_rate = chip_smoke.card_int32_rate()
    cells = n * (Lp + 1) * B
    report = {"B": B, "Lp": Lp, "batch": n, "dp_cells_per_dispatch": cells}
    for name, ms, (bound, by) in (
            ("band_fwd", fwd, chip_smoke.fwd_bound(B, Lp, n, int_rate)),
            ("band_bwd", bwd, chip_smoke.bwd_bound(np.full(n, Lp), Lp, n,
                                                   int_rate))):
        report[name] = {"ms": ms, "cells_per_s": cells / (ms * 1e-3),
                        "bound_ms": bound, "bound_by": by,
                        "share_of_bound": bound / ms}

    pairs = full_path_pairs(rng)
    al = wfa.BatchAligner(use_device=True, device=dev, device_min_cells=1)
    al.align_many(pairs)                          # warm
    band.reset_launch_counts()
    n_dispatch = al.n_dispatch
    best = float("inf")
    for _ in range(3):
        al.memo_clear()
        _sync(dev)
        t0 = time.perf_counter()
        res = al.align_many(pairs)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    report["full_path"] = {
        "wall_s_per_batch": best, "pairs": len(pairs),
        "product_cells_per_s": sum(len(p) * len(t) for p, t in pairs) / best,
        "n_dispatch": al.n_dispatch - n_dispatch,
        "launches": band.launch_counts(),
        "launch_shapes": band.launch_shapes(),
        "note": "staging, both kernels (band_bwd with its events "
                "epilogue), the copies both ways and the host's decode; "
                "product cells (pattern x text) as the routing split "
                "counts them"}
    _log(f"kernel leg: band_fwd {fwd:.3f} ms, band_bwd {bwd:.4f} ms, full "
         f"path {best * 1e3:.2f} ms for {len(pairs)} pairs")
    return report, pairs, res


def baseline_bracket(mbp: float, total_bp: int, bin_bp: dict, t1: float,
                     t_procs: float, host1_cells: dict, n_w: int) -> dict:
    """bench.py:714-795's C-baseline bracket over the measured walls: the
    reference's 1-thread wall bracketed at [0.8x, 1.6x] of host_1t's mean
    ``t1``, its thread credit between 1x and min(3x, total bp over the
    busiest 500 kb bin's bp), the headline's baseline the bracket's
    geometric midpoint.  ``host1_cells`` are host_1t's aligner deltas over
    its ``n_w`` timed passes.  The bins are this synthetic contig's reads,
    not HG002's."""
    my_thread_speedup = min(3.0, max(1.0, t1 / t_procs))
    ref_chunk_par = (total_bp / max(bin_bp.values())) if bin_bp else 1.0
    ref_scale_high = min(3.0, ref_chunk_par)
    base_low = mbp / (t1 * 1.6)                        # ref slow end
    base_high = mbp / (t1 * 0.8 / ref_scale_high)      # ref fast end
    base_mid = (base_low * base_high) ** 0.5
    n_w = max(n_w, 1)
    wf_model = host1_cells.get("model_wf_cells", 0) / n_w
    poa_model = host1_cells.get("model_poa_cells", 0) / n_w
    cells_exec = (host1_cells.get("cells_host_band_exec", 0)
                  + host1_cells.get("cells_host_full_exec", 0)
                  + host1_cells.get("cells_host_greedy_exec", 0)) / n_w
    return {
        "low_mbp_s": base_low, "mid_mbp_s": base_mid, "high_mbp_s": base_high,
        "anchor_1t_wall_s": t1,
        "my_thread_speedup": my_thread_speedup,
        "ref_chunk_parallelism": ref_chunk_par,
        "ref_scale_credit_high": ref_scale_high,
        "scale_note": "the reference's only parallel loop is kt_for over "
                      "500 kb chunks (call_var_main.c:773, bam_utils.h:10), "
                      "so its thread speedup on this workload is bounded by "
                      "total bp / busiest-chunk bp, here over the synthetic "
                      "2 Mb contig's four 500 kb bins; my_thread_speedup is "
                      "this pipeline's measured host_1t / procs ratio",
        "ref_wavefront_model_cells": int(wf_model),
        "ref_poa_band_model_cells": int(poa_model),
        "cells_executed": int(cells_exec),
        "exec_over_wf_model": cells_exec / max(wf_model, 1),
        "model_note": "per-pass reference alignment-volume models from our "
                      "own pair results: WFA2 ~5*s^2 cells/pair, abPOA "
                      "~n*m/10 band cells/pair; cells_executed is the host "
                      "C layer's audited DP work (banded rows x width + "
                      "full planes + greedy prepass)",
    }


def _vm_rss_mb(pid: int):
    """A process's resident set (VmRSS) in MiB, None once it is gone."""
    try:
        with open(f"/proc/{pid}/status") as fh:
            for ln in fh:
                if ln.startswith("VmRSS:"):
                    return int(ln.split()[1]) / 1024.0
    except OSError:
        return None
    return None


class RssPeak:
    """Peak resident set (MiB) of this process ("main") and of each pool
    worker ("w<k>"), from VmRSS sampled every 0.2 s while the block runs.
    bench.py reads VmHWM at the end (:294-302); not every /proc reports
    VmHWM, while every one reports VmRSS."""

    def __init__(self):
        import threading
        self.peak: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)

    def _sample(self):
        from longcalld_torch.core import procpool
        with procpool._LOCK:
            pids = [(f"w{k}", w.proc.pid) for pool in procpool._POOLS.values()
                    for k, w in enumerate(pool)]
        for name, pid in [("main", os.getpid())] + pids:
            v = _vm_rss_mb(pid)
            if v is not None:
                self.peak[name] = max(self.peak.get(name, 0.0), v)

    def _poll(self):
        while not self._stop.is_set():
            self._sample()
            self._stop.wait(0.2)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()

    def report(self) -> dict:
        return {"main": self.peak.get("main"),
                "workers": [v for k, v in sorted(self.peak.items())
                            if k != "main"]}


def f1_leg(length: int = 20_000_000) -> dict:
    """bench.py:_f1_leg over a seeded random sequence of ``length`` bases
    (bench.py tiles real chr11 to 20 Mb; nothing here to tile): truth at
    build_truth's default densities, 20x 12 kb reads (seed 1), called
    host-only over 4 threads (the window-range pool), scored by
    tests/torch_helpers.py:evaluate_f1 and every FN bucketed by
    classify_fn_causes.  Peak RSS of this process and of every pool
    worker over the call (RssPeak)."""
    from torch_helpers import (build_truth, classify_fn_causes, evaluate_f1,
                               write_synth_bam, write_synth_fasta)

    from longcalld_torch.config import CallOpts
    from longcalld_torch.core import procpool
    from longcalld_torch.core.pipeline import _open_aln, run_call
    from longcalld_torch.io.fasta import FastaFile

    procpool.shutdown()             # the peak RSS of this leg's workers
    rng = np.random.default_rng(7)
    ref4 = rng.integers(0, 4, length).astype(np.uint8)
    beg, end = 10_000, length - 10_000
    truth = build_truth(rng, ref4, beg, end)
    with tempfile.TemporaryDirectory() as d:
        fa, bam = d + "/synth.fa", d + "/synth.bam"
        write_synth_fasta(fa, "chr21", ref4)
        t0 = time.perf_counter()
        n_reads = write_synth_bam(bam, "chr21", length, ref4, truth, beg,
                                  end, coverage=20, read_len=12_000,
                                  err=0.003, seed=1)
        gen_s = time.perf_counter() - t0
        opt = CallOpts.hifi(ref_fa_fn=fa, in_bam_fns=[bam], use_device=False,
                            n_threads=4)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with RssPeak() as rss:
            run_call(opt, buf, "bench-f1")
        wall = time.perf_counter() - t0
        body = [ln for ln in buf.getvalue().splitlines()
                if not ln.startswith("#")]
        f1, fns = evaluate_f1(body, truth, beg, end, ref4, return_fns=True)
        t0 = time.perf_counter()
        fn_causes = classify_fn_causes(opt, FastaFile(fa),
                                       [_open_aln(bam, fa)], fns, "chr21",
                                       length)
        fn_causes["classify_wall_s"] = time.perf_counter() - t0
    procpool.shutdown()
    mbp = n_reads * 12_000 / 1e6
    return {
        "contig_mb": length / 1e6, "n_truth": len(truth), "n_reads": n_reads,
        "aligned_mbp": mbp, "gen_s": gen_s, "call_wall_s": wall,
        "mbp_per_s": mbp / wall, "f1": f1, "fn_causes": fn_causes,
        "peak_rss_mb": {**rss.report(),
                        "main_note": "this process during the call, this "
                                     "leg's contig included"},
        "note": "a seeded random sequence has no repeats or low-complexity "
                "stretches, so it is easier than bench.py's tiled chr11",
    }


WGS_RUNNER = """\
import json, sys, time
sys.path.insert(0, {root!r})
from longcalld_torch.config import CallOpts
from longcalld_torch.core import procpool
from longcalld_torch.core.pipeline import run_call
from longcalld_torch.utils import counters
from bench_torch import RssPeak
fa_fn, bam_fn, ck, out_fn = sys.argv[1:5]
opt = CallOpts.hifi(ref_fa_fn=fa_fn, in_bam_fns=[bam_fn], use_device=False,
                    n_threads=4, checkpoint_dir=ck)
t0 = time.perf_counter()
with RssPeak() as rss, open(out_fn, "w") as out:
    n_vars = run_call(opt, out, "bench-wgs")
wall = time.perf_counter() - t0
snap = counters.snapshot()
procpool.shutdown()
print(json.dumps({{"wall": wall, "n_vars": n_vars,
                  "worker_rss": rss.report()["workers"],
                  "wins_planned": snap.get("wins_planned", 0),
                  "wins_skipped": snap.get("wins_skipped_by_index", 0)}}))
"""


def wgs_leg(length: int = 100_000_000) -> dict:
    """bench.py:_wgs_leg with the port: a seeded random contig of
    ``length`` bases plus a read-free copy, 15x 12 kb reads, the full
    host-only pool call with checkpointing in a child process (its VmRSS
    sampled, since a forked child's VmHWM carries this generator's RSS,
    bench.py:486-489), then a second checkpointed child SIGKILLed at 60%
    of the first one's wall (never past 90% of it) and the call resumed
    in this process: the VCF bodies must be byte-equal."""
    import shutil
    import signal

    from torch_helpers import build_truth, write_synth_bam, write_synth_fasta

    from longcalld_torch.config import CallOpts
    from longcalld_torch.core import procpool
    from longcalld_torch.core.pipeline import run_call

    rng = np.random.default_rng(21)
    ref4 = rng.integers(0, 4, length).astype(np.uint8)
    beg, end = 10_000, length - 10_000
    truth = build_truth(rng, ref4, beg, end)
    d = tempfile.mkdtemp(prefix="wgs_bench_")
    try:
        t0 = time.perf_counter()
        write_synth_fasta(d + "/wgs.fa", ["chr21", "chr22"], [ref4, ref4])
        n_reads = write_synth_bam(d + "/wgs.bam", "chr21", length, ref4,
                                  truth, beg, end, coverage=15,
                                  read_len=12_000, err=0.003, seed=3,
                                  extra_refs=[("chr22", length)])
        gen_s = time.perf_counter() - t0
        mbp = n_reads * 12_000 / 1e6
        runner = d + "/wgs_call.py"
        with open(runner, "w") as fh:
            fh.write(WGS_RUNNER.format(root=ROOT))
        argv = [sys.executable, runner, d + "/wgs.fa", d + "/wgs.bam"]
        proc = subprocess.Popen(argv + [d + "/ck", d + "/full.vcf"],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
        main_rss = 0.0
        while proc.poll() is None:
            try:
                with open(f"/proc/{proc.pid}/status") as fh:
                    for ln in fh:
                        if ln.startswith("VmRSS:"):
                            main_rss = max(main_rss,
                                           int(ln.split()[1]) / 1024.0)
                            break
            except OSError:
                break
            time.sleep(0.2)
        child_out = proc.stdout.read()
        proc.wait()
        lines = child_out.strip().splitlines()
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"WGS call subprocess failed (rc="
                               f"{proc.returncode}) without a report")
        rep = json.loads(lines[-1])
        wall = rep["wall"]
        with open(d + "/full.vcf") as fh:
            vcf_full = fh.read()

        ck2 = d + "/ck2"
        proc = subprocess.Popen(argv + [ck2, d + "/killed.vcf"],
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        kill_after = min(max(5.0, 0.6 * wall), 0.9 * wall)
        time.sleep(kill_after)
        killed_while_running = proc.poll() is None
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        n_ck2 = (sum(1 for f in os.listdir(ck2) if f.startswith("win_"))
                 if os.path.isdir(ck2) else 0)
        opt = CallOpts.hifi(ref_fa_fn=d + "/wgs.fa",
                            in_bam_fns=[d + "/wgs.bam"], use_device=False,
                            n_threads=4, checkpoint_dir=ck2)
        buf = io.StringIO()
        t0 = time.perf_counter()
        run_call(opt, buf, "bench-wgs")
        resume_wall = time.perf_counter() - t0
        procpool.shutdown()
        if _body(buf.getvalue()) != _body(vcf_full):
            raise AssertionError("the resumed WGS call's VCF body differs "
                                 "from the uninterrupted call's")
        return {
            "contig_mb": length / 1e6, "read_free_contig_mb": length / 1e6,
            "n_reads": n_reads, "aligned_mbp": mbp, "gen_s": gen_s,
            "call_wall_s": wall, "sustained_mbp_per_s": mbp / wall,
            "n_vars": rep["n_vars"],
            "checkpointing": "on (pool path, per-window npz)",
            "window_skip": {"planned": int(rep["wins_planned"]),
                            "skipped_by_index": int(rep["wins_skipped"])},
            "peak_rss_mb": {"main": main_rss, "workers": rep["worker_rss"]},
            "resume_from_kill": {
                "killed_after_s": kill_after,
                "killed_while_running": bool(killed_while_running),
                "windows_checkpointed_at_kill": n_ck2,
                "resume_wall_s": resume_wall, "byte_identical": True},
        }
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _check_bodies(res: dict) -> dict:
    """The bench's equalities (raising on any difference); returns the
    records and the _canon comparison of the 50 kb bodies with the 500 kb
    body."""
    for name in CONFIGS:
        if name in res and any(b != res[name]["bodies"][0]
                               for b in res[name]["bodies"]):
            raise AssertionError(f"{name}: VCF bodies differ between passes")
    ref = res["device_auto"]["bodies"][0]
    for name in ("device_forced", "host_1t"):
        if res[name]["bodies"][0] != ref:
            raise AssertionError(f"{name}'s VCF body differs from "
                                 "device_auto's")
    pool = res["procs"]["bodies"][0]
    if res["procs_device"]["bodies"][0] != pool:
        raise AssertionError("procs_device's VCF body differs from procs'")
    c_pool, c_ref = _canon(pool), _canon(ref)
    return {"records_500kb": len(ref) - 1, "records_50kb": len(pool) - 1,
            "canon_records_differing": sum(a != b for a, b in
                                           zip(c_pool, c_ref))
            + abs(len(c_pool) - len(c_ref))}


def run(fa: str, bam: str, dev, rounds: int = ROUNDS,
        pool_procs: int = -1) -> dict:
    """The bench over one contig on ``dev`` (a torch.device): the turns,
    the checks, the audit, the legs; returns the JSON line's object."""
    from longcalld_torch.core import procpool
    from longcalld_torch.utils import kbuild

    total_bp, bins = aligned_bp(bam)
    mbp = total_bp / 1e6
    cfgs = call_configs(fa, bam, pool_procs)
    build_s = None
    if dev.type == "cuda":
        t0 = time.perf_counter()
        kbuild.load()
        build_s = time.perf_counter() - t0
    try:
        res = run_turns(cfgs, dev, rounds)
    finally:
        procpool.shutdown()
    bodies = _check_bodies(res)
    detail_cfg, means = {}, {}
    for name in CONFIGS:
        r = res[name]
        st = wall_stats(r["walls"])
        means[name] = st["mean_s"]
        audit = r["audit"]
        entry = {**st, "mbp_per_s": mbp / st["mean_s"],
                 "warmup_s": r["warmup_s"],
                 "aligned_dp_cells": audit["aligned_dp_cells"],
                 "launches": audit["launches"],
                 # the parent's or, on the pool, the workers' (aln_*)
                 "phase_em_launches_per_pass": (
                     audit["launches"].get("phase_em", 0)
                     + audit["aligned_dp_cells"].get("phase_em_launches", 0))
                 / st["passes"],
                 "launch_shapes": audit["launch_shapes"]}
        for k in ("routing_min_cells", "card_mem_mib"):
            if k in r:
                entry[k] = r[k]
        detail_cfg[name] = entry
    forced = detail_cfg["device_forced"]
    cells = forced["aligned_dp_cells"]
    forced["device_share_of_dp_cells"] = (
        cells["cells_device"] / max(1, cells["cells_device"]
                                    + cells["cells_host"]))
    forced["device_majority"] = cells["cells_device"] > cells["cells_host"]
    forced["device_round_budget"] = {
        "rounds_per_pass": cells["n_dev_rounds"]
        / len(res["device_forced"]["walls"])}
    if dev.type == "cuda" and not all(forced["launches"].get(k, 0) > 0
                                      for k in ("band_fwd", "band_bwd",
                                                "phase_em")):
        raise AssertionError(f"device_forced launched {forced['launches']}")
    if cells["n_dispatch"] <= 0 or cells["cells_device"] <= 0:
        raise AssertionError(f"device_forced sent nothing to the device: "
                             f"{cells}")

    profile = kern = None
    if dev.type == "cuda":
        profile = profiled_pass(cfgs["device_forced"], dev)
        _log(f"profiled forced pass: {json.dumps(profile)}")
        kern = kernel_leg(dev)[0]
    f1 = (None if os.environ.get("LONGCALLD_BENCH_F1") == "0" else f1_leg())
    wgs = (None if os.environ.get("LONGCALLD_BENCH_WGS") == "0"
           else wgs_leg())

    info = device_info(dev)         # the SM clock right after the legs
    _log(f"device {info}")
    best_cfg = min(HEADLINE, key=lambda c: means[c])
    mbp_s = mbp / means[best_cfg]
    host1 = res["host_1t"]
    bracket = baseline_bracket(mbp, total_bp, bins, means["host_1t"],
                               means["procs"],
                               host1["audit"]["aligned_dp_cells"],
                               len(host1["walls"]))
    _log("means " + ", ".join(f"{k} {v:.3f} s" for k, v in means.items())
         + f"; aligned {mbp:.3f} Mbp")
    return {
        "metric": "synth2mb_hifi_e2e_throughput",
        "value": mbp_s,
        "unit": "Mbp/s",
        "vs_baseline": mbp_s / bracket["mid_mbp_s"],
        "detail": {
            "headline": "warm MEAN of the best configuration but host_1t; "
                        "every configuration's passes in turns",
            "best_config": best_cfg,
            "device": info,
            "workload": {"contig": os.path.basename(fa), "aligned_bp":
                         total_bp, "aligned_mbp": mbp},
            "kernel_build_s": build_s,
            "wall_cold_s": res["device_auto"]["warmup_s"],
            "rounds": rounds, "orders": res["orders"],
            "configs": detail_cfg,
            "vcf": bodies,
            "profiled_forced_pass": profile,
            "kernels": kern,
            "f1_synth_20mb": f1,
            "wgs_100mb_streaming": wgs,
            "baseline_bracket_mbp_s": bracket,
            "baseline_note": "bench.py's bracket over this run's walls: "
                             "the reference's 1-thread wall at [0.8x, 1.6x] "
                             "of host_1t's, its thread credit between 1x "
                             "and min(3x, its chunk-level parallelism on "
                             "this contig); vs_baseline = headline / "
                             "geometric midpoint; longcallD itself is not "
                             "built here",
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; cpu only on request)")
    ap.add_argument("--seed", type=int, default=2026,
                    help="seed of the 2 Mb contig (default 2026)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from longcalld_torch.utils.device import resolve_device
    dev = resolve_device(args.device)          # raises without CUDA
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        fa, bam, n_reads, n_truth = chip_smoke.build_workload(d, args.seed)
        _log(f"workload: 2 Mb contig, {n_truth} planted variants, "
             f"{n_reads} reads, built in {time.perf_counter() - t0:.1f} s")
        out = run(fa, bam, dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
