"""Smoke run of the longcalld_torch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no phase catches its own):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build the hand-written kernels (longcalld_torch/csrc/*.cu) with nvcc;
  3. each kernel against its plain PyTorch version on the card, at the
     main path's band width B=256, Lp in {256, 1024, 4096}, batch in
     {64, 512}, with plen == 0 dummies and a band-escape pair in every
     batch: outputs must be bit-equal (tolerance 0, all are integers);
  4. the main path: a seeded 2 Mb diploid contig (four 500 kb windows,
     30x 15 kb HiFi-like reads) called three times through the port's
     run_call -- calibrated routing threshold, forced device
     (device_min_cells=1), host only -- with byte-equal VCF bodies, both
     kernels and the phasing EM launched in the forced run, and jax never
     imported.
The last lines are the card line, a JSON line of the kernels, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# scoring of the HiFi preset (longcalld_tpu/config.py)
X, O1, E1, O2, E2 = 6, 6, 2, 24, 1
B = 256
KERNEL_SHAPES = [(Lp, n) for Lp in (256, 1024, 4096) for n in (64, 512)]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def make_batch(rng, n, Lp):
    """Device inputs built as BatchAligner._submit_batch builds them, from
    pairs of random length <= Lp with substitutions and short indels; the
    batch holds a plen == 0 pair, length-1 batch-padding dummies and one
    pair whose optimal path escapes the band."""
    pairs = []
    for _ in range(n):
        L = int(rng.integers(Lp // 4, Lp + 1))
        p = rng.integers(0, 4, L).astype(np.uint8)
        t = p.copy()
        mut = rng.choice(L, max(1, L // 100), replace=False)
        t[mut] = (t[mut] + 1) % 4
        for _ in range(int(rng.integers(0, 4))):
            i = int(rng.integers(0, len(t)))
            k = int(rng.integers(1, 20))
            t = (np.concatenate([t[:i], rng.integers(0, 4, k).astype(
                np.uint8), t[i:]]) if rng.random() < 0.5
                 else np.concatenate([t[:i], t[i + k:]]))
        if abs(len(t) - len(p)) + 128 > B:
            t = p.copy()
        pairs.append((p, t))
    pairs[0] = (np.zeros(0, np.uint8), np.zeros(7, np.uint8))
    for k in (1, 2):
        pairs[k] = (np.zeros(1, np.uint8), np.zeros(1, np.uint8))
    L = Lp - 4                  # escape: +w insertion, later -w deletion
    p = rng.integers(0, 4, L).astype(np.uint8)
    w = B // 2 + 16
    pairs[3] = (p, np.concatenate([p[:L // 4], rng.integers(0, 4, w).astype(
        np.uint8), p[L // 4:L - w]]))
    plens = np.array([len(p) for p, _ in pairs], dtype=np.int32)
    tlens = np.array([len(t) for _, t in pairs], dtype=np.int32)
    m_n = tlens - plens
    dlo = (np.minimum(0, m_n) - (B - np.abs(m_n)) // 2).astype(np.int32)
    P = np.full((n, Lp), 4, dtype=np.int8)
    Tband = np.full((n, Lp + B), 127, dtype=np.int8)
    for k, (p, t) in enumerate(pairs):
        P[k, :len(p)] = p
        off = -int(dlo[k])
        end = min(off + len(t), Lp + B)
        if end > off >= 0:
            Tband[k, off:end] = t[:end - off]
    return P, Tband, plens, tlens, dlo


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernels(shapes, plain_reps=1):
    """Kernel vs plain on the card; returns per-shape rows."""
    import torch

    from longcalld_torch.ops import band
    from longcalld_torch.ops.convert import from_numpy

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(1234)
    rows = []
    for Lp, n in shapes:
        args = from_numpy(make_batch(rng, n, Lp), dev)
        dp = (B, Lp, X, O1, E1, O2, E2)
        tbs_k, fin_k, edge_k = band.banded_dp(*args, *dp)
        tbs_p, fin_p, edge_p = band.banded_dp_plain(*args, *dp)
        torch.cuda.synchronize()
        err_f = max(int((a.int() - b.int()).abs().max()) for a, b in
                    ((tbs_k, tbs_p), (fin_k, fin_p), (edge_k, edge_p)))
        if err_f:
            raise AssertionError(f"band_fwd differs from its plain version "
                                 f"at Lp={Lp} batch={n}: max |diff| {err_f}")
        fin = fin_k.min(dim=1).values.cpu().numpy()
        if not int(edge_k[3]) < int(fin[3]):
            raise AssertionError("escape pair did not escape the band")
        bargs = (tbs_k, args[2], args[3], args[4], fin_k, B, Lp)
        pk_k, b0_k = band.backward_resolve(*bargs)
        pk_p, b0_p, _ = band.backward_resolve_plain(*bargs)
        torch.cuda.synchronize()
        err_b = max(int((pk_k - pk_p).abs().max()),
                    int((b0_k - b0_p).abs().max()))
        if err_b:
            raise AssertionError(f"band_bwd differs from its plain version "
                                 f"at Lp={Lp} batch={n}: max |diff| {err_b}")
        reps = max(2, min(20, 40960 // Lp))
        row = {
            "Lp": Lp, "batch": n,
            "fwd_ms": cuda_ms(lambda: band.banded_dp(*args, *dp), reps),
            "fwd_plain_ms": cuda_ms(lambda: band.banded_dp_plain(*args, *dp),
                                    plain_reps),
            "bwd_ms": cuda_ms(lambda: band.backward_resolve(*bargs), reps),
            "bwd_plain_ms": cuda_ms(
                lambda: band.backward_resolve_plain(*bargs), plain_reps),
            "fwd_err": err_f, "bwd_err": err_b,
        }
        rows.append(row)
        print(f"kernel Lp={Lp} batch={n}: band_fwd {row['fwd_ms']:.3f} ms "
              f"(plain {row['fwd_plain_ms']:.1f} ms), band_bwd "
              f"{row['bwd_ms']:.3f} ms (plain {row['bwd_plain_ms']:.1f} ms),"
              " bit-equal", flush=True)
    return rows


def check_offband_walk(Lp=256, n=64):
    """band_bwd against its plain version on random traceback bytes: real
    DP output falls off the band only in unreachable regions, random bytes
    do so in most pairs, through both edges."""
    import torch

    from longcalld_torch.ops import band
    from longcalld_torch.ops.convert import from_numpy

    rng = np.random.default_rng(7)
    src = rng.integers(0, 5, (Lp + 1, n, B))
    bits = rng.random((Lp + 1, n, B, 4)) < np.array([0.9, 0.9, 0.6, 0.6])
    tbs = (src | (bits[..., 0] << 3) | (bits[..., 1] << 4)
           | (bits[..., 2] << 5) | (bits[..., 3] << 6)).astype(np.uint8)
    plen = rng.integers(0, Lp + 1, n).astype(np.int32)
    tlen = np.maximum(plen + rng.integers(-60, 60, n), 0).astype(np.int32)
    dlo = (np.minimum(0, tlen - plen)
           - (B - np.abs(tlen - plen)) // 2).astype(np.int32)
    dlo[:2] += np.array([-B, B], dtype=np.int32)
    finals = rng.integers(0, 50, (n, 5)).astype(np.int32)
    args = from_numpy((tbs, plen, tlen, dlo, finals), torch.device("cuda:0"))
    pk_k, b0_k = band.backward_resolve(*args, B, Lp)
    pk_p, b0_p, went_off = band.backward_resolve_plain(*args, B, Lp)
    torch.cuda.synchronize()
    if not (torch.equal(pk_k, pk_p) and torch.equal(b0_k, b0_p)):
        raise AssertionError("band_bwd differs from its plain version on "
                             "random traceback bytes")
    n_off = int(went_off.sum())
    if n_off == 0:
        raise AssertionError("random walk never went off band")
    print(f"band_bwd on random traceback bytes (Lp={Lp}, batch={n}): "
          f"bit-equal, {n_off} pairs went off band", flush=True)


def build_workload(d: str, seed: int = 2026):
    """Seeded 2 Mb contig with planted SNVs, indels and ~25 SVs/Mb, and a
    30x BAM of 15 kb HiFi-like reads (0.3% substitutions)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synthcontig import build_truth, write_synth_bam, write_synth_fasta

    L = 2_000_000
    rng = np.random.default_rng(seed)
    ref4 = rng.integers(0, 4, L).astype(np.uint8)
    truth = build_truth(rng, ref4, 10_000, L - 10_000, sv_per_mb=25)
    fa, bam = os.path.join(d, "synth.fa"), os.path.join(d, "synth.bam")
    write_synth_fasta(fa, "chr1", ref4)
    n_reads = write_synth_bam(bam, "chr1", L, ref4, truth, 10_000, L - 10_000,
                              coverage=30, read_len=15_000, err=0.003,
                              seed=seed + 1)
    return fa, bam, n_reads, len(truth)


def run_main_path(fa, bam):
    """The port's run_call three ways; returns (VCF bodies, reports)."""
    import torch

    from longcalld_tpu.config import CallOpts
    from longcalld_tpu.utils import counters
    from longcalld_torch.core.pipeline import run_call
    from longcalld_torch.ops import band, phase_kernel, wfa

    configs = [("calibrated", dict(use_device=True)),
               ("forced", dict(use_device=True, device_min_cells=1)),
               ("host", dict(use_device=False))]
    bodies, reports = {}, {}
    for name, kw in configs:
        opt = CallOpts.hifi(ref_fa_fn=fa, in_bam_fns=[bam], n_threads=8,
                            **kw)
        wfa._ALIGNER_CACHE.clear()
        counters.reset()
        # launch counts from here on are the main path's own
        band.reset_launch_counts()
        phase_kernel.reset_cuda_calls()
        out = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_rec = run_call(opt, out, "chip_smoke", device="cuda:0")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bodies[name] = [ln for ln in out.getvalue().splitlines()
                        if not ln.startswith("#")]
        al = wfa.get_aligner(opt, torch.device("cuda:0"))
        reports[name] = {
            "wall_s": wall, "records": n_rec,
            "launches": band.launch_counts(),
            "phase_cuda_calls": phase_kernel.cuda_calls(),
            "device_min_cells": al.device_min_cells if kw["use_device"]
            else None,
            "aligner_totals": wfa.aligner_totals(),
            "counters": counters.summary_lines(),
        }
        print(f"main path [{name}]: {json.dumps(reports[name])}", flush=True)
    return bodies, reports


def check_vcf(body, fa):
    """Structural check of the records: sorted positions, REF bases that
    match the FASTA, a diploid GT."""
    from longcalld_tpu.io.fasta import FastaFile
    fasta = FastaFile(fa)
    nt = "ACGTN"
    last = 0
    for line in body:
        f = line.split("\t")
        pos = int(f[1])
        if pos < last:
            raise AssertionError(f"unsorted record {line[:80]}")
        last = pos
        ref = "".join(nt[b] for b in fasta.fetch_nt4(f[0], pos - 1,
                                                     pos - 2 + len(f[3])))
        if ref != f[3].upper():
            raise AssertionError(f"REF mismatch at {f[0]}:{pos}")
        gt = f[9].split(":")[0]
        if not re.fullmatch(r"[0-9.][|/][0-9.]", gt):
            raise AssertionError(f"unexpected GT {gt} at {f[0]}:{pos}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from longcalld_torch.utils import kbuild

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, device {kind}", flush=True)

    t0 = time.perf_counter()
    kbuild.load()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"({kbuild.library_path()})", flush=True)
    for line in kbuild.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  nvcc: {line.strip()}")

    krows = check_kernels(KERNEL_SHAPES)
    check_offband_walk()

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        fa, bam, n_reads, n_truth = build_workload(d)
        print(f"workload: 2 Mb contig, {n_truth} planted variants, "
              f"{n_reads} reads, built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        bodies, reports = run_main_path(fa, bam)
        for name in ("forced", "host"):
            if bodies[name] != bodies["calibrated"]:
                raise AssertionError(f"VCF body of the {name} run differs "
                                     "from the calibrated run")
        if not bodies["host"]:
            raise AssertionError("no variant records")
        check_vcf(bodies["host"], fa)
    forced = reports["forced"]
    for k, v in forced["launches"].items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched in the forced "
                                 "run")
    if forced["phase_cuda_calls"] <= 0:
        raise AssertionError("phasing EM never ran on CUDA in the forced run")
    if reports["host"]["launches"] != {"band_fwd": 0, "band_bwd": 0}:
        raise AssertionError("host-only run launched a kernel")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(f"VCF bodies byte-equal across calibrated/forced/host: "
          f"{len(bodies['host'])} records; jax in sys.modules: False",
          flush=True)

    big = max(krows, key=lambda r: (r["Lp"], r["batch"]))
    kernels = []
    for name, src, ref, key in (
            ("band_fwd", "longcalld_torch/csrc/band_fwd.cu",
             "longcalld_tpu/ops/pallas_band.py:76", "fwd"),
            ("band_bwd", "longcalld_torch/csrc/band_bwd.cu",
             "longcalld_tpu/ops/pallas_band.py:355", "bwd")):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": ref,
            "launches": forced["launches"][name],
            "max_abs_err": max(r[f"{key}_err"] for r in krows),
            "ms": big[f"{key}_ms"], "plain_ms": big[f"{key}_plain_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
