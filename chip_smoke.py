"""Smoke run of the longcalld_torch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no phase catches its own):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build the hand-written kernels (longcalld_torch/csrc/*.cu) with nvcc;
  3. (a) each kernel against its plain PyTorch version on the card, at
     the main path's band width B=256, Lp in {256, 1024, 4096}, batch in
     {64, 512}, plus batch 2048 at Lp 256 and 1024, and Lp 1024 at
     batches 301 and 515,
     which the pairs per CTA of band_fwd's warp design do not divide, with
     plen == 0 dummies and a band-escape pair in every batch: outputs must
     be bit-equal (tolerance 0, all are integers), band_bwd through both
     its entries, the walk alone (packed) and the events entry that
     align_device launches (evs, meta), which must also equal
     compact_events of the checked walk; each shape's CUDA-event ms
     beside its bound (fwd_bound, bwd_bound, events_bound below; band_bwd's
     entries and the walk + compact_events they replaced queued behind a
     sleep kernel, so the card's own time, with their host-included time
     beside it), the plain versions' ms from their one checking call; (b)
     every
     configuration of band_fwd's warp design (warps per pair x pairs per
     CTA, at B 128, 256, 384 and 512) against the plain version at Lp 1024,
     batch 67, bit-equal; (c) band_bwd against its plain version on random
     traceback bytes at B 256 (walks off each band edge), and on the long
     runs of tests/torch_helpers.py:random_walk_inputs (an insertion chain
     of 151 columns, a D run of up to 46 rows: both leave band_bwd's
     shared-memory window) at Lp 33 and 1000, bit-equal, with window
     reloads counted, both entries each time; (d) the events entry on the
     two walks the compaction cannot encode (more than K events; an
     insertion chain of B columns) at B 256, n_ev -1 where it must be;
  4. the main path: a seeded 2 Mb diploid contig (four 500 kb windows,
     30x 15 kb HiFi-like reads) called three times through the port's
     run_call -- calibrated routing threshold, forced device
     (device_min_cells=1), host only -- with byte-equal VCF bodies, both
     kernels and the phasing EM launched in the forced run, and jax never
     imported; then one pass of ops/wfa.py:align_device at (B 256, Lp
     1024, batch 512) under torch.profiler, whose only card kernels may be
     band_fwd's and band_bwd's (beside fills and copies);
  5. the whole-genome path: the same reads over a seeded 8 Mb contig
     (16 windows, so 8 explicit worker processes engage the window-range
     pool) called through run_call with host_procs=8 -- (a) device
     workers (procs_use_device, device_min_cells=1), all on cuda:0, and
     (b) host-only workers -- and, for the walls' sake, (c) in-process
     host-only (host_procs=0); byte-equal VCF bodies, no kernel launched
     in the parent, both kernels and the phasing EM launched inside the
     workers of (a), device DP cells in at least two workers, none in (b)
     or (c), and jax never imported; (c) runs one thread (its records are
     equal at every thread count, and one thread took half the wall of
     eight on the 2 Mb contig).  A host with fewer than 8 cores
     gets hp = cpu_count workers and a contig of 2 * hp windows;
  6. the mesh: 4 shards on the first min(4, device_count()) distinct
     cards (on one card, cuda:0 four times) -- (a) the reads-sharded
     phasing EM against the one-device EM at the real bucket sizes
     (R, V) = (2048, 2048) and (8192, 8192), bit-equal, with CUDA-event
     ms of both; (b) sharded_window_phase over 8 windows against the
     per-window EM, bit-equal; (c) run_call with mesh_devices=4 and
     device_min_cells=1 on phase 4's 2 Mb contig, with a VCF body
     byte-equal to phase 4's host-only body, both kernels launched, the
     sharded EM run on CUDA, and jax never imported;
  7. the band widths: (a) each kernel against its plain version at every
     B in BANDS (multiples of 128 from 128 to 4096, the Pallas kernels'
     rule; 640 the narrowest of band_fwd's wide design, 1152 a width it
     reads at run time), Lp in {256, 2048}, batch 64, at the band buckets
     1024, 2048 and 4096 also batch 8 and 512 (the wide buckets of
     BatchAligner._submit_batch) at Lp 2048, plus B = Lp = 4096,
     bit-equal, with plen == 0 pairs, dummies and, where the pattern is
     long enough for its path to leave the band, a band-escape pair;
     each shape's ms beside its bound, as in phase 3 (a); (b)
     bench_torch.py's
     kernel leg: CUDA-event ms and DP cells/s of both kernels at bench.py's
     microbench shape (batch 64, B 2048, Lp 2000), and the full path,
     BatchAligner.align_many on bench.py's 64 pairs of 2000 bp, whose
     results must equal the same aligner's on CPU tensors; (c) the walk
     on random traceback bytes at B 1024 and 4096, bit-equal, with walks
     off the left edge and off the right edge counted apart (each must
     happen), and on the long runs at
     B 1024 and 4096, Lp 33 and 1000, as in phase 3 (c), and the overflow
     walks at B 4096 (the chain of 4096 columns too long for an event), as
     in phase 3 (d); (d) BatchAligner.
     _align_batch on cuda:0 over seeded SV-like pairs (band buckets 1024,
     4096 and 5128), equal to the same aligner on CPU tensors (the plain
     versions), with both kernels launched at 1024 and 4096 and nothing
     launched for the 5128 group; (e) every configuration of band_fwd's
     wide design (columns per lane x CTAs per pair, ops/band.py:
     wide_configs, at each compiled width and at 640 and 1152) against
     the plain version at Lp 1000, batch 13, bit-equal;
  8. a short soak: tests/soak_torch.py over SOAK_SEEDS seeds (two of each
     of its five scene families) on cuda:0 with forced routing, on its
     seeded random 2 Mb chr11 -- zero FAIL, the families' audit clean
     (soak_torch.audit_failures: a CUDA phasing EM in every device family,
     both kernels in every one that aligns a DP cell; the somatic scene
     aligns none), both kernels launched in the phase, and the families'
     launch counts summing to the phase's;
  9. the phasing EM kernel (csrc/phase_em.cu, ops/phase_kernel.py:
     phase_em) against its plain version, phase_fixpoint_plain, on the
     card: all six outputs and n_iter bit-equal at (R, V) in
     EM_KERNEL_SHAPES (the buckets 128-8192, the main path's (2048, 512)
     and past the last bucket on either axis), on an ONT window (the 67%
     rule), a window with no valid var, a noisy window that runs all 10
     rounds and the same window capped by max_iter=2, at grids of EM_CTA_COUNTS CTAs and one an SM (the
     EM's cooperative grid; em_ctas picks it by R x V), and under 8 threads
     running EMs at once (equal to the serial results); each shape's
     CUDA-event ms (queued: the card alone; and host included, the unpack's
     wait too) beside the plain version's and the bound (em_bound); one EM
     as run_phase_kernel runs it (the inputs' copies, the launch, one copy
     back) under torch.profiler, in a process of its own, whose only card
     kernel may be phase_em.
The EM kernel's launches are audited beside the band kernels' wherever
the one-device EM runs: phase 4's calibrated and forced runs and phase 5
(a)'s workers launch it once for every CUDA EM run (no plain EM on CUDA),
phase 6 holds the sharded torch EM (the mesh's) equal to it, phase 8's
soak families each launch it.
Every phase fails if jax or any module of the JAX package (longcalld_tpu)
is in sys.modules, and its last line says so.
The last lines are the card line, a JSON line of the kernels (with
``shapes`` and ``bands`` lists per band kernel, a ``shapes`` list of
phase 9's windows for phase_em; band_bwd's times and bound are its events
entry's), and
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
# scoring of the HiFi preset (longcalld_torch/config.py)
X, O1, E1, O2, E2 = 6, 6, 2, 24, 1
# (B, Lp, batch) of the kernel checks: phase 3 at the main path's B = 256,
# phase 7 at every other width the Pallas kernels take
KERNEL_SHAPES = ([(256, Lp, n) for Lp in (256, 1024, 4096) for n in (64, 512)]
                 + [(256, 256, 2048)]
                 + [(256, 1024, n) for n in (2048, 301, 515)])
CONFIG_SHAPE = (1024, 67)    # (Lp, batch) of phase 3 (b)
BANDS = (128, 384, 640, 1024, 1152, 2048, 4096)
BAND_LP = 2048               # the long Lp of phase 7 (a)'s shapes
BAND_SHAPES = ([(b, Lp, 64) for b in BANDS for Lp in (256, BAND_LP)]
               + [(b, BAND_LP, n) for b in (1024, 2048, 4096)
                  for n in (8, 512)]
               + [(4096, 4096, 64)])
WIDE_CONFIG_SHAPE = (1000, 13)   # (Lp, batch) of phase 7 (e)
BENCH_SHAPE = (2048, 2000, 64)   # bench.py:178's microbench (B, Lp, batch)
WALK_BANDS = (1024, 4096)
LONG_RUN_LPS = (33, 1000)    # Lp of the long-run walks, phases 3 (c), 7 (c)
WINDOW = 500_000             # CallOpts' default window
POOL_PROCS = 8               # phase 5 workers (capped by the host's cores)
SOAK_SEEDS = 10              # phase 8: two seeds of each soak family
MESH_SHARDS = 4              # phase 6 mesh size
EM_SHAPES = [(2048, 2048), (8192, 8192)]   # phase 6 (a): (R, V) buckets
# phase 9: (R, V) of the EM kernel's checks: the buckets of
# ops/phase_kernel.py:_bucket, the main path's (2048, 512) (phase 4's
# forced run launches 7 of its 8 EMs there), and past the last bucket on
# each axis
EM_KERNEL_SHAPES = [(128, 128), (512, 512), (2048, 512), (2048, 2048),
                    (8192, 8192), (64, 8200), (8320, 128)]
EM_CTAS_SHAPE = (1000, 700)  # (R, V) of phase 9's CTA counts
EM_CTA_COUNTS = (1, 2, 3, 8, 17, 64)   # and the SM count
EM_THREADS = 8               # phase 9's concurrent EMs


FOREIGN = ("jax", "jaxlib", "longcalld_tpu")


def guard(phase: str) -> str:
    """Raise if jax or the JAX package was imported; else the line that
    says so."""
    bad = {}
    for m in sys.modules:
        top = m.split(".")[0]
        if top in FOREIGN:
            bad[top] = bad.get(top, 0) + 1
    if bad:
        raise AssertionError(f"phase {phase}: imported " + ", ".join(
            f"{k} ({n} modules)" for k, n in sorted(bad.items())))
    return (f"phase {phase}: jax in sys.modules: False; longcalld_tpu in "
            "sys.modules: False")


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


def make_batch(rng, n, Lp, B):
    """Device inputs built as BatchAligner._submit_batch builds them, from
    pairs of random length <= Lp with substitutions and short indels; the
    batch holds a plen == 0 pair and length-1 batch-padding dummies.
    Where Lp leaves room for it, pair 3 is a pair whose optimal path
    escapes the band (a w = B/2 + 16 insertion, later a w deletion: the
    pattern must outgrow w by a quarter).  Returns (inputs, escape)."""
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
    w = B // 2 + 16
    escape = L - w > L // 4
    if escape:
        p = rng.integers(0, 4, L).astype(np.uint8)
        pairs[3] = (p, np.concatenate([p[:L // 4], rng.integers(
            0, 4, w).astype(np.uint8), p[L // 4:L - w]]))
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
    return (P, Tband, plens, tlens, dlo), escape


# What the bounds assume (PERF.md): HBM at the H100 SXM's 3.35 TB/s
# (NVIDIA data sheet); int32 issue of 64 lanes per SM per clock (sm_90) at
# the card's maximum SM clock; a DP cell of band_fwd costs FWD_OPS_PER_CELL
# int32 operations (the column body of csrc/band_fwd.cu:band_fwd_warp, an
# add-and-min counted once) and a row of band_bwd's walk BWD_OPS_PER_ROW.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
FWD_OPS_PER_CELL = 36
BWD_OPS_PER_ROW = 12
# a cell of the EM's allele matrix adds to 9 int32 counts a round: n_agree
# and n_conflict; the read's s1, s2, n_used, agree and conflict; its hap's
# two profile counts
EM_OPS_PER_CELL_ROUND = 9


def card_int32_rate() -> float:
    """int32 operations per second of the card at its maximum SM clock."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    return sms * INT32_LANES_PER_SM * clock_hz


def bound_ms(ops: float, nbytes: float, int_rate: float):
    """The least time (ms) for ``ops`` int32 operations moving ``nbytes``,
    and which of the two binds."""
    t_ops, t_bytes = ops / int_rate, nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def fwd_bound(B, Lp, n, int_rate):
    """band_fwd: every one of the (Lp, batch, B) cells is computed (the
    traceback bytes of every row are outputs); inputs P, Tband and the
    three lengths read once, tbs, finals and edge_min written once."""
    nbytes = n * Lp + n * (Lp + B) + 12 * n + (Lp + 1) * n * B + 24 * n
    return bound_ms(n * Lp * B * FWD_OPS_PER_CELL, nbytes, int_rate)


def bwd_bound(plen, Lp, n, int_rate):
    """band_bwd: the walk visits rows plen..1 of each pair and reads one
    traceback byte a row; it reads finals and lengths and writes packed
    (Lp, batch) int32 and b0 once."""
    walked = int(np.asarray(plen).sum())
    nbytes = walked + 32 * n + 4 * n * Lp + 4 * n
    return bound_ms(walked * BWD_OPS_PER_ROW, nbytes, int_rate)


def events_bound(plen, Lp, n, int_rate):
    """band_bwd's events entry (the main path's): the walk reads a byte a
    walked row, finals, lengths and edge_min once, and writes evs (batch,
    K) and meta (batch, 4) int32 once; packed is not written."""
    from longcalld_torch.ops.band import event_k
    walked = int(np.asarray(plen).sum())
    nbytes = walked + 36 * n + 4 * n * event_k(Lp) + 16 * n
    return bound_ms(walked * BWD_OPS_PER_ROW, nbytes, int_rate)


def em_bound(R, V, n_iter, int_rate):
    """phase_em: the inputs read once (alleles R x V bytes; starts, ends,
    haps0 9 bytes a read; cons0, the five masks and w_score 11 bytes a
    var), the packed outputs (7V + 3R + 1 int32) written once, and
    EM_OPS_PER_CELL_ROUND adds a cell a round.  Also the time of three
    reads of the allele matrix a round (two sums over reads, one over
    vars) at the same rate."""
    nbytes = R * V + 9 * R + 11 * V + 4 * (7 * V + 3 * R + 1)
    ms, by = bound_ms(EM_OPS_PER_CELL_ROUND * R * V * n_iter, nbytes,
                      int_rate)
    return ms, by, 3 * R * V * n_iter / HBM_BYTES_PER_S * 1e3


def old_tail(pk_b0, finals, edge_min, Lp):
    """What ops/wfa.py:align_device ran after the walk before the events
    epilogue: compact_events over the packed walk, the score min and the
    meta stack (about 16 launches)."""
    import torch

    from longcalld_torch.ops import wfa
    packed, b0 = pk_b0
    evs, n_ev = wfa.compact_events(packed & ((1 << 14) - 1), packed >> 14,
                                   Lp)
    meta = torch.stack([finals.amin(dim=1), b0, edge_min, n_ev], dim=1)
    return evs, meta.to(torch.int32)


def check_events(args, edge_min, B, Lp, what, pk_b0=None, reloads=None):
    """band_bwd's events entry on the card against its plain version and,
    given the kernel's checked walk ``pk_b0``, against the compaction of
    that walk (old_tail): bit-equal or raise.  Returns ((evs, meta), the
    plain call's ms, max |diff|)."""
    import torch

    from longcalld_torch.ops import band
    got = band.backward_events(*args, edge_min, B, Lp, reloads=reloads)
    torch.cuda.synchronize()
    plain, plain_ms = event_ms(lambda: band.backward_events_plain(
        *args, edge_min, B, Lp))
    refs = [("plain version", plain)]
    if pk_b0 is not None:
        refs.append(("compaction of the walk",
                     old_tail(pk_b0, args[4], edge_min, Lp)))
    err = 0
    for name, want in refs:
        diff = max(int((a.long() - b.long()).abs().max())
                   for a, b in zip(got, want))
        if diff or not all(a.shape == b.shape for a, b in zip(got, want)):
            raise AssertionError(f"band_bwd's events entry differs from the "
                                 f"{name} on {what} at B={B} Lp={Lp} "
                                 f"batch={args[0].shape[1]}: max |diff| "
                                 f"{diff}")
        err = max(err, diff)
    return got, plain_ms, err


def cuda_ms(fn, reps, queued=False):
    """CUDA-event ms per call of ``fn`` over ``reps`` calls after one warm
    call.  Unqueued, a call the host issues more slowly than the card runs
    it is timed at the host's rate.  ``queued`` first puts a sleep kernel
    on the stream, long enough that every call is enqueued before the card
    reaches the first (doubled until the start event is still pending when
    the last call is in): the events then time the card alone."""
    import torch
    fn()
    torch.cuda.synchronize()
    sleep_s = max(0.01, reps * 2e-4)
    while sleep_s < 10:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(int(sleep_s * 2e9))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if not queued or held:
            return start.elapsed_time(end) / reps
        sleep_s *= 2
    raise RuntimeError("the host could not enqueue the calls within 10 s")


def event_ms(fn):
    """(fn(), CUDA-event ms of that one call)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_kernels(shapes):
    """Kernel vs plain on the card; returns per-shape rows.  Each plain
    version's ms is that of the one call the check makes (seconds a call,
    host-bound).  band_bwd is checked and timed through both entries: the
    walk alone (packed) and the events entry that align_device launches,
    beside the walk + compact_events it replaced (old_tail)."""
    import torch

    from longcalld_torch.ops import band
    from longcalld_torch.ops.convert import from_numpy

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(1234)
    int_rate = card_int32_rate()
    rows = []
    for B, Lp, n in shapes:
        arrays, escape = make_batch(rng, n, Lp, B)
        args = from_numpy(arrays, dev)
        dp = (B, Lp, X, O1, E1, O2, E2)
        tbs_k, fin_k, edge_k = band.banded_dp(*args, *dp)
        torch.cuda.synchronize()
        (tbs_p, fin_p, edge_p), fwd_plain_ms = event_ms(
            lambda: band.banded_dp_plain(*args, *dp))
        err_f = max(int((a.int() - b.int()).abs().max()) for a, b in
                    ((tbs_k, tbs_p), (fin_k, fin_p), (edge_k, edge_p)))
        if err_f:
            raise AssertionError(f"band_fwd differs from its plain version "
                                 f"at B={B} Lp={Lp} batch={n}: max |diff| "
                                 f"{err_f}")
        fin = fin_k.min(dim=1).values.cpu().numpy()
        if escape and not int(edge_k[3]) < int(fin[3]):
            raise AssertionError(f"escape pair did not escape the band at "
                                 f"B={B} Lp={Lp}")
        wargs = (tbs_k, args[2], args[3], args[4], fin_k)
        bargs = (*wargs, B, Lp)
        pk_k, b0_k = band.backward_resolve(*bargs)
        torch.cuda.synchronize()
        (pk_p, b0_p, _), bwd_plain_ms = event_ms(
            lambda: band.backward_resolve_plain(*bargs))
        err_b = max(int((pk_k - pk_p).abs().max()),
                    int((b0_k - b0_p).abs().max()))
        if err_b:
            raise AssertionError(f"band_bwd differs from its plain version "
                                 f"at B={B} Lp={Lp} batch={n}: max |diff| "
                                 f"{err_b}")
        _, ev_plain_ms, err_e = check_events(wargs, edge_k, B, Lp,
                                             "DP output", pk_b0=(pk_k, b0_k))
        reps = max(2, min(20, 40960 // Lp))
        fb, fb_by = fwd_bound(B, Lp, n, int_rate)
        bb, bb_by = bwd_bound(arrays[2], Lp, n, int_rate)
        eb, eb_by = events_bound(arrays[2], Lp, n, int_rate)

        def events():
            return band.backward_events(*wargs, edge_k, B, Lp)

        def walk_and_tail():
            return old_tail(band.backward_resolve(*bargs), fin_k, edge_k, Lp)

        row = {
            "B": B, "Lp": Lp, "batch": n, "escape": escape,
            "config": list(band.band_fwd_config(B, n, band.sm_count(dev))),
            "fwd_ms": cuda_ms(lambda: band.banded_dp(*args, *dp), reps),
            "fwd_plain_ms": fwd_plain_ms,
            # band_bwd runs faster than the host issues it: its ms are the
            # card's (queued), the host-included ones beside them
            "bwd_ms": cuda_ms(lambda: band.backward_resolve(*bargs), reps,
                              queued=True),
            "bwd_wrapper_ms": cuda_ms(lambda: band.backward_resolve(*bargs),
                                      reps),
            "bwd_plain_ms": bwd_plain_ms,
            "ev_ms": cuda_ms(events, reps, queued=True),
            "ev_wrapper_ms": cuda_ms(events, reps),
            "ev_plain_ms": ev_plain_ms,
            # ~31 launches a call: 10 calls keep the queue behind the
            # sleep kernel short enough for the host to fill it
            "old_tail_ms": cuda_ms(walk_and_tail, min(reps, 10),
                                   queued=True),
            "old_tail_host_ms": cuda_ms(walk_and_tail, min(reps, 10)),
            "fwd_err": err_f, "bwd_err": err_b, "ev_err": err_e,
            "fwd_bound_ms": fb, "fwd_bound_by": fb_by,
            "bwd_bound_ms": bb, "bwd_bound_by": bb_by,
            "ev_bound_ms": eb, "ev_bound_by": eb_by,
        }
        rows.append(row)
        print(f"kernel B={B} Lp={Lp} batch={n}: band_fwd "
              f"{row['fwd_ms']:.3f} ms (configuration "
              f"{tuple(row['config'])}; bound {fb:.3f} ms, {fb_by}; plain "
              f"{fwd_plain_ms:.1f} ms), band_bwd's walk {row['bwd_ms']:.3f} "
              f"ms (bound {bb:.4f} ms, {bb_by}; plain {bwd_plain_ms:.1f} ms;"
              f" wrapper, host included {row['bwd_wrapper_ms']:.3f} ms), "
              f"events entry {row['ev_ms']:.3f} ms (bound {eb:.4f} ms, "
              f"{eb_by}; plain {ev_plain_ms:.1f} ms; host included "
              f"{row['ev_wrapper_ms']:.3f} ms) against walk + compact_events "
              f"{row['old_tail_ms']:.3f} ms (host included "
              f"{row['old_tail_host_ms']:.3f} ms), bit-equal", flush=True)
    return rows


def check_configs():
    """Phase 3 (b): every configuration of band_fwd's warp design (each
    instantiated warps-per-pair count, with one pair per CTA and with as
    many as a CTA takes) against the plain version, bit-equal."""
    import torch

    from longcalld_torch.ops import band
    from longcalld_torch.ops.convert import from_numpy

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(4321)
    Lp, n = CONFIG_SHAPE
    checked = []
    for B, wpps in sorted(band.WARP_CONFIGS.items()):
        arrays, _ = make_batch(rng, n, Lp, B)
        args = from_numpy(arrays, dev)
        dp = (B, Lp, X, O1, E1, O2, E2)
        ref = band.banded_dp_plain(*args, *dp)
        for wpp in wpps:
            for ppc in sorted({1, band.MAX_GROUP_WARPS // wpp}):
                got = band.banded_dp(*args, *dp, config=(wpp, ppc))
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(
                        f"band_fwd with {wpp} warps per pair and {ppc} pairs "
                        f"per CTA differs from its plain version at B={B}")
                checked.append((B, wpp, ppc))
    print(f"band_fwd configurations (B, warps per pair, pairs per CTA) "
          f"bit-equal to the plain version at Lp={Lp}, batch={n}: {checked}",
          flush=True)
    return checked


def check_wide_configs():
    """Phase 7 (e): every configuration of band_fwd's wide design (columns
    per lane x CTAs per pair) at each compiled width and at two run-time
    widths against the plain version, bit-equal."""
    import torch

    from longcalld_torch.ops import band
    from longcalld_torch.ops.convert import from_numpy

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(4322)
    Lp, n = WIDE_CONFIG_SHAPE
    checked = []
    for B in (640, 1152, *sorted(band.WIDE_CONFIGS)):
        arrays, _ = make_batch(rng, n, Lp, B)
        args = from_numpy(arrays, dev)
        dp = (B, Lp, X, O1, E1, O2, E2)
        ref = band.banded_dp_plain(*args, *dp)
        for cfg in band.wide_configs(B):
            got = band.banded_dp(*args, *dp, config=cfg)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise AssertionError(
                    f"band_fwd with {cfg[0]} columns per lane and {cfg[1]} "
                    f"CTAs per pair differs from its plain version at B={B}")
            checked.append((B, *cfg))
    print(f"band_fwd wide configurations (B, columns per lane, CTAs per "
          f"pair) bit-equal to the plain version at Lp={Lp}, batch={n}: "
          f"{checked}", flush=True)
    return checked


def check_offband_walk(B, Lp=256, n=64):
    """band_bwd against its plain version on random traceback bytes: real
    DP output falls off the band only in unreachable regions, random bytes
    (tests/torch_helpers.py:random_walk_inputs) do so through each edge,
    and both exits must happen.  Returns the walks off each edge."""
    import torch

    from longcalld_torch.ops import band
    from longcalld_torch.ops.convert import from_numpy
    from torch_helpers import random_walk_inputs

    rng = np.random.default_rng(7)
    args = from_numpy(random_walk_inputs(rng, B, Lp, n, spread=60),
                      torch.device("cuda:0"))
    pk_k, b0_k = band.backward_resolve(*args, B, Lp)
    pk_p, b0_p, off_edge = band.backward_resolve_plain(*args, B, Lp)
    torch.cuda.synchronize()
    if not (torch.equal(pk_k, pk_p) and torch.equal(b0_k, b0_p)):
        raise AssertionError(f"band_bwd differs from its plain version on "
                             f"random traceback bytes at B={B}")
    check_events(args, random_edge_min(B, n), B, Lp,
                 "random traceback bytes", pk_b0=(pk_k, b0_k))
    n_off = {"left": int((off_edge == band.OFF_LEFT).sum()),
             "right": int((off_edge == band.OFF_RIGHT).sum())}
    if not all(n_off.values()):
        raise AssertionError(f"random walks at B={B} did not leave the band "
                             f"through both edges: {n_off}")
    print(f"band_bwd on random traceback bytes (B={B}, Lp={Lp}, batch={n}):"
          f" bit-equal (walk and events entry), walks off the band {n_off}",
          flush=True)
    return n_off


def check_long_runs(B, n=16):
    """band_bwd against its plain version on the long runs of
    tests/torch_helpers.py:random_walk_inputs at each Lp of LONG_RUN_LPS:
    pair 2's insertion chain runs past the kernel's window to the left and
    makes it reload (the count must be positive), pair 3's D run crosses a
    window's rows.  Returns {Lp: reloads}."""
    import torch

    from longcalld_torch.ops import band
    from longcalld_torch.ops.convert import from_numpy
    from torch_helpers import random_walk_inputs

    rng = np.random.default_rng(17)
    dev = torch.device("cuda:0")
    out = {}
    for Lp in LONG_RUN_LPS:
        args = from_numpy(random_walk_inputs(rng, B, Lp, n, spread=60,
                                             long_runs=True), dev)
        reloads = torch.zeros(1, dtype=torch.int32, device=dev)
        pk_k, b0_k = band.backward_resolve(*args, B, Lp, reloads=reloads)
        pk_p, b0_p, _ = band.backward_resolve_plain(*args, B, Lp)
        torch.cuda.synchronize()
        if not (torch.equal(pk_k, pk_p) and torch.equal(b0_k, b0_p)):
            raise AssertionError(f"band_bwd differs from its plain version on "
                                 f"the long runs at B={B} Lp={Lp}")
        ev_reloads = torch.zeros(1, dtype=torch.int32, device=dev)
        check_events(args, random_edge_min(Lp, n), B, Lp, "the long runs",
                     pk_b0=(pk_k, b0_k), reloads=ev_reloads)
        out[Lp] = int(reloads.item())
        if out[Lp] <= 0 or int(ev_reloads.item()) != out[Lp]:
            raise AssertionError(f"the long runs at B={B} Lp={Lp}: window "
                                 f"reloads {out[Lp]} (walk), "
                                 f"{int(ev_reloads.item())} (events entry)")
    print(f"band_bwd on the long runs (B={B}, batch={n}): bit-equal (walk and"
          f" events entry), window reloads by Lp {out}", flush=True)
    return out


def check_overflow(B, Lp=1000, n=16):
    """band_bwd's events entry on the walks the compaction cannot encode
    (tests/torch_helpers.py:random_walk_inputs with ``overflow``): pair
    n-2 with more than K events, pair n-1 with an insertion chain of B
    columns (more than 4095 at B 4096), among random long-run walks;
    bit-equal to the plain version and to the compaction of the checked
    walk, with n_ev -1 where it must be.  Returns the meta rows' n_ev."""
    import torch

    from longcalld_torch.ops import band
    from longcalld_torch.ops.convert import from_numpy
    from torch_helpers import random_walk_inputs

    rng = np.random.default_rng(27)
    args = from_numpy(random_walk_inputs(rng, B, Lp, n, spread=60,
                                         long_runs=True, overflow=True),
                      torch.device("cuda:0"))
    pk_b0 = band.backward_resolve(*args, B, Lp)
    pk_p, b0_p, _ = band.backward_resolve_plain(*args, B, Lp)
    torch.cuda.synchronize()
    if not (torch.equal(pk_b0[0], pk_p) and torch.equal(pk_b0[1], b0_p)):
        raise AssertionError(f"band_bwd differs from its plain version on "
                             f"the overflow walks at B={B}")
    (evs, meta), _, _ = check_events(args, random_edge_min(B, n), B, Lp,
                                     "the overflow walks", pk_b0=pk_b0)
    n_ev = meta[:, 3].tolist()
    chain = -1 if B > 4095 else 1
    if n_ev[n - 2] != -1 or n_ev[n - 1] != chain or int(evs[n - 1, 0]) != (
            1 << 12 | min(B, 4095)):
        raise AssertionError(f"the overflow walks at B={B}: n_ev {n_ev}, "
                             f"chain event {int(evs[n - 1, 0]):#x}")
    print(f"band_bwd's events entry on the overflow walks (B={B}, Lp={Lp}, "
          f"batch={n}): bit-equal, n_ev {n_ev}", flush=True)
    return n_ev


def random_edge_min(seed, n):
    """Seeded random edge_min values on the card, for walks of random
    bytes (a generator of their own: the walks' inputs stay as they
    were)."""
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 1 << 20, n).astype(
        np.int32)).to("cuda:0")


def bench_kernels():
    """Phase 7 (b): bench_torch.py's kernel leg on cuda:0 (both kernels at
    bench.py's microbench shape in CUDA-event ms and DP cells/s, and the
    full path, BatchAligner.align_many on bench.py's 64 pairs), then the
    full path's results against the same aligner on CPU tensors (the
    plain versions): equal scores, CIGARs and alignments."""
    import torch

    import bench_torch
    from longcalld_torch.ops import wfa

    leg, pairs, res = bench_torch.kernel_leg(torch.device("cuda:0"))
    plain = wfa.BatchAligner(use_device=True, device=torch.device("cpu"),
                             device_min_cells=1)
    for k, (r, q) in enumerate(zip(res, plain.align_many(pairs),
                                   strict=True)):
        if not (r.score == q.score and np.array_equal(r.cigar, q.cigar)
                and np.array_equal(r.pattern_alg, q.pattern_alg)
                and np.array_equal(r.text_alg, q.text_alg)):
            raise AssertionError(f"align_many on the card differs from its "
                                 f"plain path at pair {k}")
    full = leg["full_path"]
    print(f"bench shape (B={leg['B']}, Lp={leg['Lp']}, batch={leg['batch']})"
          f": band_fwd {leg['band_fwd']['ms']:.3f} ms "
          f"({leg['band_fwd']['cells_per_s']:.4g} DP cells/s), band_bwd "
          f"{leg['band_bwd']['ms']:.4f} ms "
          f"({leg['band_bwd']['cells_per_s']:.4g} cells/s); full path "
          f"{full['wall_s_per_batch'] * 1e3:.2f} ms for {full['pairs']} pairs"
          f" ({full['product_cells_per_s']:.4g} product cells/s, launches "
          f"{full['launch_shapes']}), equal to its plain path", flush=True)
    return leg


def run_align_batch():
    """Phase 7 (d): BatchAligner._align_batch on cuda:0, one group per SV
    width (tests/torch_helpers.py:sv_pairs), against the same aligner on
    CPU tensors, which runs the plain versions of both kernels; the launch
    counts are each card group's own."""
    import torch

    from longcalld_torch.ops import band, wfa
    from torch_helpers import SV_WIDTHS, sv_pairs

    al = wfa.BatchAligner(use_device=True, device="cuda:0",
                          device_min_cells=1)
    plain = wfa.BatchAligner(use_device=True, device=torch.device("cpu"),
                             device_min_cells=1)
    rows = []
    for w, pairs in sv_pairs(2026).items():
        band.reset_launch_counts()
        t0 = time.perf_counter()
        res = al._align_batch(pairs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = band.launch_counts()
        t0 = time.perf_counter()
        ref = plain._align_batch(pairs)
        plain_wall = time.perf_counter() - t0
        for r, q in zip(res, ref, strict=True):
            if not (r.score == q.score
                    and np.array_equal(r.cigar, q.cigar)
                    and np.array_equal(r.pattern_alg, q.pattern_alg)
                    and np.array_equal(r.text_alg, q.text_alg)):
                raise AssertionError(f"_align_batch on the card differs from "
                                     f"its plain path at w={w}")
        if (al.n_dispatch, al.n_fallback) != (plain.n_dispatch,
                                              plain.n_fallback):
            raise AssertionError(f"_align_batch at w={w}: card dispatches/"
                                 f"fallbacks {al.n_dispatch}/{al.n_fallback}"
                                 f", plain {plain.n_dispatch}/"
                                 f"{plain.n_fallback}")
        B = SV_WIDTHS[w]
        on_card = B <= 4096
        if on_card != all(v > 0 for v in launches.values()) or (
                not on_card and any(launches.values())):
            raise AssertionError(f"_align_batch at B={B} launched "
                                 f"{launches}")
        row = {"w": w, "B": B, "launches": launches, "wall_s": wall,
               "plain_wall_s": plain_wall, "fallbacks": al.n_fallback,
               "scores": [int(r.score) for r in res]}
        rows.append(row)
        print(f"_align_batch on cuda:0: {json.dumps(row)}, equal to its "
              "plain path", flush=True)
    return rows


def profile_align_device(B=256, Lp=1024, n=512):
    """Phase 4: one pass of ops/wfa.py:align_device under torch.profiler
    at a main-path shape.  The only kernels on the card may be band_fwd's
    and band_bwd's, one launch each, beside fills and copies: any other
    (a cumsum, a scatter, a reduction) fails.  Returns the card's kernel
    names with their ms."""
    import torch
    from torch.autograd import DeviceType

    from longcalld_torch.ops import band, wfa
    from longcalld_torch.ops.convert import from_numpy

    arrays, _ = make_batch(np.random.default_rng(99), n, Lp, B)
    args = from_numpy(arrays, torch.device("cuda:0"))
    dp = (B, Lp, X, O1, E1, O2, E2)
    wfa.align_device(*args, *dp)                       # warm
    torch.cuda.synchronize()
    band.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wfa.align_device(*args, *dp)
        torch.cuda.synchronize()
    launches = band.launch_counts()
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = re.sub(r"\s*\(.*", "", e.name.replace(
            "(anonymous namespace)::", "")).removeprefix("void ")
        by_name[name] = by_name.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    kinds = {k: m.group(0) for k in by_name
             if (m := re.search(r"band_fwd|band_bwd", k))}
    other = [k for k in by_name if k not in kinds and not re.search(
        r"memcpy|memset|fill", k, re.IGNORECASE)]
    if (other or launches != {"band_fwd": 1, "band_bwd": 1}
            or sorted(set(kinds.values())) != ["band_bwd", "band_fwd"]):
        raise AssertionError(f"align_device at (B {B}, Lp {Lp}, batch {n}) "
                             f"ran kernels {by_name}, launches {launches}")
    print(f"align_device profiled at (B {B}, Lp {Lp}, batch {n}): card "
          f"kernels {json.dumps(by_name)}, launches {launches}", flush=True)
    return by_name


def build_workload(d: str, seed: int = 2026, L: int = 2_000_000):
    """Seeded contig of L bases with planted SNVs, indels and ~25 SVs/Mb,
    and a 30x BAM of 15 kb HiFi-like reads (0.3% substitutions)."""
    from torch_helpers import build_contig
    return build_contig(d, seed, L, coverage=30, read_len=15_000,
                        margin=10_000)


def run_main_path(fa, bam):
    """The port's run_call three ways; returns (VCF bodies, reports)."""
    import torch

    from longcalld_torch.config import CallOpts
    from longcalld_torch.core.pipeline import run_call
    from longcalld_torch.ops import band, phase_kernel, wfa
    from longcalld_torch.utils import counters
    from torch_helpers import vcf_body

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
        phase_kernel.reset_em_launch_counts()
        out = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_rec = run_call(opt, out, "chip_smoke", device="cuda:0")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bodies[name] = vcf_body(out.getvalue())
        al = wfa.get_aligner(opt, torch.device("cuda:0"))
        reports[name] = {
            "wall_s": wall, "records": n_rec,
            "launches": {**band.launch_counts(),
                         **phase_kernel.em_launch_counts()},
            "launch_shapes": band.launch_shapes(),
            "em_launch_shapes": phase_kernel.em_launch_shapes(),
            "phase_cuda_calls": phase_kernel.cuda_calls(),
            "device_min_cells": al.device_min_cells if kw["use_device"]
            else None,
            "aligner_totals": wfa.aligner_totals(),
            "counters": counters.summary_lines(),
        }
        print(f"main path [{name}]: {json.dumps(reports[name])}", flush=True)
    return bodies, reports


class MemPeak:
    """Peak memory in use on ``device`` (total - free, all processes)
    sampled from torch.cuda.mem_get_info every 50 ms while the block
    runs."""

    def __init__(self, device=0):
        import threading
        self.device = device
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)

    def _poll(self):
        import torch
        while not self._stop.is_set():
            free, total = torch.cuda.mem_get_info(self.device)
            self.peak = max(self.peak, total - free)
            self._stop.wait(0.05)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def run_pool(fa, bam, hp):
    """Phase 5: the port's run_call over the same contig three ways -- on
    the window-range pool with device workers, on the pool with host-only
    workers, and in-process host-only; returns (VCF bodies, reports)."""
    import torch

    from longcalld_torch.config import CallOpts
    from longcalld_torch.core import pipeline, procpool
    from longcalld_torch.ops import band, phase_kernel, wfa
    from longcalld_torch.utils import counters
    from torch_helpers import pool_calls, vcf_body

    configs = [("device_workers", hp, dict(procs_use_device=True,
                                           device_min_cells=1)),
               ("host_workers", hp, dict()),
               ("in_process", 0, dict(use_device=False, n_threads=1))]
    bodies, reports = {}, {}
    try:
        for name, procs, kw in configs:
            opt = CallOpts.hifi(**{"ref_fa_fn": fa, "in_bam_fns": [bam],
                                   "n_threads": 8, "host_procs": procs,
                                   **kw})
            counters.reset()
            wfa._ALIGNER_CACHE.clear()
            # the parent's own launch counts: they must stay 0
            band.reset_launch_counts()
            phase_kernel.reset_cuda_calls()
            phase_kernel.reset_em_launch_counts()
            out = io.StringIO()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            free, total = torch.cuda.mem_get_info(0)
            with MemPeak() as mem, pool_calls(pipeline) as taken:
                t0 = time.perf_counter()
                n_rec = pipeline.run_call(opt, out, "chip_smoke",
                                          device="cuda:0")
                wall = time.perf_counter() - t0
            # each run starts its workers cold, and no device worker is
            # alive during the later runs
            procpool.shutdown()
            want = [(2 * hp, hp)] if procs else []
            if taken != want:
                raise AssertionError(f"run {name} took the pool as {taken}, "
                                     f"not as {want}")
            bodies[name] = vcf_body(out.getvalue())
            snap = counters.snapshot()
            # pool runs sum the workers' aligner deltas into aln_*
            cells = ({k: snap.get(f"aln_{k}", 0)
                      for k in ("cells_device", "cells_host")} if procs else
                     {k: wfa.aligner_totals()[k]
                      for k in ("cells_device", "cells_host")})
            reports[name] = {
                "wall_s": wall, "records": n_rec, "host_procs": procs,
                "n_threads": opt.n_threads,
                "parent_launches": {**band.launch_counts(),
                                    **phase_kernel.em_launch_counts()},
                "parent_phase_cuda_calls": phase_kernel.cuda_calls(),
                "worker_launches": {
                    k: snap.get(f"aln_{k}_launches", 0)
                    for k in ("band_fwd", "band_bwd", "phase_em")},
                "worker_phase_cuda_calls": snap.get("aln_phase_cuda_calls",
                                                    0),
                **cells,
                "cells_device_by_worker": {
                    k[len("aln_cells_device_"):]: v
                    for k, v in sorted(snap.items())
                    if k.startswith("aln_cells_device_w")},
                "card_mem_before_mib": (total - free) / 2**20,
                "peak_card_mem_mib": mem.peak / 2**20,
            }
            print(f"pool [{name}]: {json.dumps(reports[name])}", flush=True)
    finally:
        procpool.shutdown()
    return bodies, reports


def phase_mesh():
    """The first min(MESH_SHARDS, device_count()) distinct cards, repeated
    to MESH_SHARDS entries."""
    import torch
    cards = [f"cuda:{k}" for k in range(min(MESH_SHARDS,
                                            torch.cuda.device_count()))]
    return [cards[k % len(cards)] for k in range(MESH_SHARDS)]


def check_mesh_em(mesh):
    """Phase 6 (a) and (b): the sharded forms against the one-device EM
    on the card; returns their rows."""
    from longcalld_torch.entry import differing_fields
    from longcalld_torch.ops import phase_kernel
    from longcalld_torch.ops.convert import from_numpy
    from longcalld_torch.parallel.mesh import (make_example_window_batch,
                                               sharded_window_phase,
                                               window_phase_batch)
    from torch_helpers import phase_window

    lead = mesh[0]
    sharded = phase_kernel.sharded_phase_fixpoint(mesh)
    rows = []
    for R, V in EM_SHAPES:
        args = from_numpy(phase_window(R + V, R=R, V=V, noise=0.05), lead)
        one = phase_kernel.phase_fixpoint(*args)
        sh = sharded(*args)
        bad = differing_fields(sh, one)
        if bad:
            raise AssertionError(f"sharded EM differs from the one-device "
                                 f"EM at (R, V) = ({R}, {V}): {bad}")
        reps = 10 if R <= 2048 else 3
        row = {"R": R, "V": V, "n_iter": one.n_iter,
               "one_device_ms": cuda_ms(
                   lambda: phase_kernel.phase_fixpoint(*args), reps),
               "sharded_ms": cuda_ms(lambda: sharded(*args), reps)}
        rows.append(row)
        print(f"mesh EM (R, V) = ({R}, {V}), {one.n_iter} rounds: one "
              f"device {row['one_device_ms']:.3f} ms, {len(mesh)} shards "
              f"{row['sharded_ms']:.3f} ms, bit-equal", flush=True)
    batch = from_numpy(make_example_window_batch(8, 2048, 2048, seed=6),
                       lead)
    out, total = sharded_window_phase(mesh, batch)
    ref = window_phase_batch(batch)
    bad = differing_fields(out, ref)
    if bad or total != int((ref.haps > 0).sum()):
        raise AssertionError(f"sharded_window_phase differs from the "
                             f"per-window EM: {bad}, total {total}")
    row = {"windows": 8, "R": 2048, "V": 2048, "phased_reads": total,
           "one_device_ms": cuda_ms(lambda: window_phase_batch(batch), 3),
           "sharded_ms": cuda_ms(
               lambda: sharded_window_phase(mesh, batch), 3)}
    rows.append(row)
    print(f"mesh window batch (8 windows of 2048 x 2048): per-window EM "
          f"{row['one_device_ms']:.3f} ms, in blocks over the mesh "
          f"{row['sharded_ms']:.3f} ms, bit-equal, {total} phased reads",
          flush=True)
    return rows


def run_mesh_call(fa, bam, mesh):
    """Phase 6 (c): the port's run_call with mesh_devices on phase 4's
    contig; returns (VCF body, report)."""
    import torch

    from longcalld_torch.config import CallOpts
    from longcalld_torch.core.pipeline import run_call
    from longcalld_torch.ops import band, phase_kernel, wfa
    from torch_helpers import vcf_body

    opt = CallOpts.hifi(ref_fa_fn=fa, in_bam_fns=[bam], n_threads=8,
                        use_device=True, device_min_cells=1,
                        mesh_devices=len(mesh))
    wfa._ALIGNER_CACHE.clear()
    # launch counts from here on are the mesh run's own
    band.reset_launch_counts()
    phase_kernel.reset_cuda_calls()
    phase_kernel.reset_em_launch_counts()
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_rec = run_call(opt, out, "chip_smoke", device=mesh[0], mesh=mesh)
    torch.cuda.synchronize()
    report = {"wall_s": time.perf_counter() - t0, "records": n_rec,
              "mesh": mesh, "launches": {
                  **band.launch_counts(), **phase_kernel.em_launch_counts()},
              "phase_cuda_calls": phase_kernel.cuda_calls(),
              "phase_sharded_calls": phase_kernel.sharded_calls()}
    print(f"mesh call: {json.dumps(report)}", flush=True)
    return vcf_body(out.getvalue()), report


def run_soak():
    """Phase 8: tests/soak_torch.py's soak over SOAK_SEEDS seeds on cuda:0;
    returns (summary, the phase's launches)."""
    import torch

    import soak_torch
    from longcalld_torch.ops import band, phase_kernel

    # launch counts from here on are the soak's own
    band.reset_launch_counts()
    phase_kernel.reset_cuda_calls()
    phase_kernel.reset_em_launch_counts()
    with tempfile.TemporaryDirectory() as d:
        summary = soak_torch.soak(
            SOAK_SEEDS, soak_torch.seeded_base(d), torch.device("cuda:0"),
            log=lambda s: print(f"soak {s}", flush=True))
    launches = {**band.launch_counts(), **phase_kernel.em_launch_counts()}
    if summary["counts"]["FAIL"]:
        raise AssertionError(f"soak FAIL: {summary['non_pass']}")
    if summary["audit_failures"]:
        raise AssertionError(f"soak audit: {summary['audit_failures']}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched in the soak")
        if n != sum(r["phase_em_launches"] if name == "phase_em"
                    else r["launches"][name]
                    for r in summary["families"].values()):
            raise AssertionError(f"the soak families' {name} launches do "
                                 f"not sum to the phase's {n}")
    for fam, r in summary["families"].items():
        print(f"soak [{fam}]: {json.dumps(r)}", flush=True)
    return summary, launches


def em_err(a, b):
    """Max |difference| over two PhaseKernelOut's tensors and n_iter."""
    err = abs(int(a.n_iter) - int(b.n_iter))
    for name in a._fields[:-1]:
        x, y = getattr(a, name), getattr(b, name)
        if x.shape != y.shape:
            raise AssertionError(f"EM field {name}: shape {tuple(x.shape)} "
                                 f"against {tuple(y.shape)}")
        err = max(err, int((x.cpu().long() - y.cpu().long()).abs().max()))
    return err


def em_case(case, arrays, int_rate, max_iter=10):
    """Phase 9: the EM kernel against phase_fixpoint_plain on one window
    on cuda:0, bit-equal or raise; returns the row with both times and the
    bound."""
    import torch

    from longcalld_torch.ops import phase_kernel as pk
    from longcalld_torch.ops.convert import from_numpy

    args = from_numpy(arrays, torch.device("cuda:0"))
    R, V = args[0].shape
    got = pk.phase_fixpoint(*args, max_iter=max_iter)
    torch.cuda.synchronize()
    plain = pk.phase_fixpoint_plain(*args, max_iter=max_iter)
    err = em_err(got, plain)
    if err:
        raise AssertionError(f"phase_em differs from its plain version on "
                             f"{case} at (R, V) = ({R}, {V}): max |diff| "
                             f"{err}")
    reps = max(3, min(50, (1 << 24) // (R * V)))
    bound, by, bytes_3x = em_bound(R, V, got.n_iter, int_rate)
    row = {"case": case, "R": R, "V": V, "max_iter": max_iter,
           "n_iter": got.n_iter,
           "ctas": pk.em_ctas(R, V, pk.sm_count(args[0].device)),
           "ms": cuda_ms(lambda: pk.phase_em(*args, max_iter=max_iter),
                         reps, queued=True),
           "host_ms": cuda_ms(
               lambda: pk.phase_fixpoint(*args, max_iter=max_iter), reps),
           # the torch form after its checking call (warm)
           "plain_ms": cuda_ms(
               lambda: pk.phase_fixpoint_plain(*args, max_iter=max_iter), 3),
           "bound_ms": bound, "bound_by": by,
           "bytes_3x_ms": bytes_3x, "max_abs_err": err}
    print(f"phase_em [{case}] (R, V) = ({R}, {V}), {got.n_iter} rounds, "
          f"{row['ctas']} CTAs: {row['ms']:.4f} ms (host included "
          f"{row['host_ms']:.4f} ms; bound {bound:.4f} ms, {by}; three "
          f"reads of A a round {bytes_3x:.4f} ms; plain "
          f"{row['plain_ms']:.3f} ms),"
          f" bit-equal", flush=True)
    return row


def check_em(int_rate):
    """Phase 9 (see the module docstring); returns (rows, the CTA counts
    checked, the threads' EM runs)."""
    import threading

    import torch

    from longcalld_torch.ops import phase_kernel as pk
    from longcalld_torch.ops.convert import from_numpy
    from torch_helpers import phase_window

    rows = [em_case("shape", phase_window(R + V, R=R, V=V, noise=0.05),
                    int_rate) for R, V in EM_KERNEL_SHAPES]
    rows.append(em_case("ont", phase_window(
        11, R=2048, V=2048, noise=0.05, hp_on=True), int_rate))
    rows.append(em_case("no_valid", phase_window(
        12, R=512, V=512, no_valid=True), int_rate))
    noisy = phase_window(1, R=2048, V=2048, noise=0.3)
    rows.append(em_case("noisy", noisy, int_rate))
    rows.append(em_case("capped", noisy, int_rate, max_iter=2))
    if rows[-1]["n_iter"] != 2 or rows[-2]["n_iter"] <= 2:
        raise AssertionError(f"the noisy window ran {rows[-2]['n_iter']} "
                             f"rounds, {rows[-1]['n_iter']} capped at 2")

    args = from_numpy(phase_window(7, R=EM_CTAS_SHAPE[0],
                                   V=EM_CTAS_SHAPE[1], noise=0.1),
                      torch.device("cuda:0"))
    R, V = args[0].shape
    ref = pk.phase_fixpoint_plain(*args)
    counts = [*EM_CTA_COUNTS, pk.sm_count(args[0].device)]
    for ctas in counts:
        got = pk.unpack_phase_out(pk.phase_em(*args, ctas=ctas), R, V)
        if em_err(got, ref):
            raise AssertionError(f"phase_em with {ctas} CTAs differs from "
                                 f"its plain version at ({R}, {V})")
    print(f"phase_em at (R, V) = ({R}, {V}): grids of {counts} CTAs "
          f"bit-equal to the plain version", flush=True)

    wins = [from_numpy(phase_window(40 + k, R=n, V=n, noise=0.05),
                       torch.device("cuda:0"))
            for k, n in enumerate([512, 2048] * (EM_THREADS // 2))]
    serial = [pk.phase_fixpoint(*w) for w in wins]
    errors, runs = [], []

    def work(k):
        try:
            for _ in range(3):
                if em_err(pk.phase_fixpoint(*wins[k]), serial[k]):
                    errors.append(f"window {k} differs")
                runs.append(k)
        except Exception as e:          # reported below, in the main thread
            errors.append(f"window {k}: {e!r}")
    threads = [threading.Thread(target=work, args=(k,))
               for k in range(EM_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    if errors or len(runs) != 3 * EM_THREADS:
        raise AssertionError(f"phase_em under {EM_THREADS} threads: "
                             f"{errors}, {len(runs)} runs")
    print(f"phase_em under {EM_THREADS} threads: {len(runs)} EMs equal to "
          f"the serial results", flush=True)
    return rows, counts, len(runs)


def profile_em(R=2048, V=2048):
    """Phase 9: one EM as run_phase_kernel runs it (the inputs copied to
    the card, one launch, the packed outputs copied back) under
    torch.profiler: one launch, and phase_em the only card kernel beside
    copies and fills.  Returns the card's kernel names with their ms."""
    import torch
    from torch.autograd import DeviceType

    from longcalld_torch.ops import phase_kernel as pk
    from longcalld_torch.ops.convert import from_numpy
    from torch_helpers import phase_window

    arrays = phase_window(3, R=R, V=V, noise=0.05)
    dev = torch.device("cuda:0")
    pk.phase_em(*from_numpy(arrays, dev)).cpu()              # warm
    pk.reset_em_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pk.phase_em(*from_numpy(arrays, dev)).cpu()
        torch.cuda.synchronize()
    launches = pk.em_launch_counts()
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = re.sub(r"\s*\(.*", "", e.name.replace(
            "(anonymous namespace)::", "")).removeprefix("void ")
        by_name[name] = by_name.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    other = [k for k in by_name if "phase_em" not in k and not re.search(
        r"memcpy|memset|fill", k, re.IGNORECASE)]
    if (other or launches != {"phase_em": 1}
            or not any("phase_em" in k for k in by_name)):
        raise AssertionError(f"one EM at (R, V) = ({R}, {V}) ran kernels "
                             f"{by_name}, launches {launches}")
    print(f"one EM profiled at (R, V) = ({R}, {V}): card kernels "
          f"{json.dumps(by_name)}, launches {launches}", flush=True)
    return by_name


def profile_em_child():
    """profile_em in a process of its own: on the H100 a second
    torch.profiler session in one process (phase 4 opens the first)
    recorded no device events.  Returns the child's result."""
    code = (f"import json, sys; sys.path[:0] = [{ROOT!r}, "
            f"{os.path.join(ROOT, 'tests')!r}]; import chip_smoke; "
            "by_name = chip_smoke.profile_em(); print(chip_smoke.guard('9, "
            "the profiled EM')); print(json.dumps(by_name))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    lines = out.stdout.splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if out.returncode:
        raise AssertionError(f"the profiled EM failed: {out.stderr[-2000:]}")
    return json.loads(lines[-1])


def check_vcf(body, fa):
    """Structural check of the records: sorted positions, REF bases that
    match the FASTA, a diploid GT."""
    from longcalld_torch.io.fasta import FastaFile
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


def shape_key(row):
    """The "B,Lp,batch" key of band.launch_shapes() for a kernel row."""
    return f"{row['B']},{row['Lp']},{row['batch']}"


def kernel_entries(krows, brows, bench, arows, path_launches, path_shapes,
                   prof):
    """The ``kernels`` JSON list: per kernel the launch counts of each path
    (``path_launches``: JSON key -> {kernel: count}), the main path's
    launches by "B,Lp,batch" (``path_shapes``), the time and bound at
    phase 3's largest shape (no PyTorch call computes either kernel's
    function, so ``library_ms`` is null), every phase 3 shape's time,
    bound and share of it, the same at each shape the main path launched
    with its launches (``main_path``), every phase 7 shape's time
    (band_fwd's with its configuration) beside its bound, the bench-shape
    time, the _align_batch launches per band bucket and the kernel's ms in
    phase 4's profiled align_device (``prof``).  band_bwd's numbers are
    those of its events entry, which align_device launches (``key``
    "ev"); the walk alone (the packed entry) and the walk + compact_events
    it replaced stand beside them."""
    big = max(krows, key=lambda r: (r["Lp"], r["batch"]))
    kernels = []
    for name, src, ref, key in (
            ("band_fwd", "longcalld_torch/csrc/band_fwd.cu",
             "longcalld_tpu/ops/pallas_band.py:76", "fwd"),
            ("band_bwd", "longcalld_torch/csrc/band_bwd.cu",
             "longcalld_tpu/ops/pallas_band.py:355", "ev")):
        bwd = key == "ev"

        def walk(r):
            """band_bwd's walk alone and the round it replaced."""
            return {"walk_ms": r["bwd_ms"], "walk_plain_ms": r["bwd_plain_ms"],
                    "walk_bound_ms": r["bwd_bound_ms"],
                    "walk_and_compact_events_ms": r["old_tail_ms"]} if bwd \
                else {}

        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": ref,
            **({"entry": "lcd_band_bwd_events", "also_replaces":
                "longcalld_tpu/ops/wfa.py:188 (_compact_events, XLA) and "
                "the meta row of :359-387"} if bwd else {}),
            **{k: v[name] for k, v in path_launches.items()},
            "launch_shapes": path_shapes[name],
            "max_abs_err": max(r[f"{k}_err"] for r in krows + brows
                               for k in ((key, "bwd") if bwd else (key,))),
            "ms": big[f"{key}_ms"], "plain_ms": big[f"{key}_plain_ms"],
            "bound_ms": big[f"{key}_bound_ms"],
            "bound_by": big[f"{key}_bound_by"], "library_ms": None,
            "shape": {"B": big["B"], "Lp": big["Lp"], "batch": big["batch"]},
            **walk(big),
            "profiled_align_device_ms": sum(
                v for k, v in prof.items() if name in k),
            "shapes": [{
                "B": r["B"], "Lp": r["Lp"], "batch": r["batch"],
                **({"config": r["config"]} if key == "fwd" else {}),
                "ms": r[f"{key}_ms"], "bound_ms": r[f"{key}_bound_ms"],
                "bound_by": r[f"{key}_bound_by"],
                "share": r[f"{key}_bound_ms"] / r[f"{key}_ms"], **walk(r)}
                for r in krows],
            "main_path": [{
                "B": r["B"], "Lp": r["Lp"], "batch": r["batch"],
                "launches": path_shapes[name][shape_key(r)],
                "ms": r[f"{key}_ms"], "bound_ms": r[f"{key}_bound_ms"],
                **({"wrapper_ms": r["ev_wrapper_ms"],
                    "walk_wrapper_ms": r["bwd_wrapper_ms"],
                    "walk_and_compact_events_host_ms": r["old_tail_host_ms"],
                    **walk(r)} if bwd else {})}
                for r in krows if shape_key(r) in path_shapes[name]],
            "bands": [{
                "B": r["B"], "Lp": r["Lp"], "batch": r["batch"],
                **({"config": r["config"]} if key == "fwd" else {}),
                "ms": r[f"{key}_ms"], "plain_ms": r[f"{key}_plain_ms"],
                "bound_ms": r[f"{key}_bound_ms"],
                "bound_by": r[f"{key}_bound_by"],
                "share": r[f"{key}_bound_ms"] / r[f"{key}_ms"],
                "max_abs_err": r[f"{key}_err"], **walk(r)}
                for r in brows],
            # bench.py times the Pallas walk alone; so does its port
            "bench_shape": {"B": bench["B"], "Lp": bench["Lp"],
                            "batch": bench["batch"],
                            **({"entry": "lcd_band_bwd"} if bwd else {}),
                            "ms": bench[name]["ms"],
                            "cells_per_s": bench[name]["cells_per_s"],
                            "bound_ms": bench[name]["bound_ms"]},
            "align_batch_launches": {str(r["B"]): r["launches"][name]
                                     for r in arows}})
    return kernels


def em_entry(erows, path_launches, prof, cta_counts, thread_runs,
             path_shapes):
    """phase_em's entry of the ``kernels`` JSON list: its launches on each
    path and the main path's by "R,V" (``path_shapes``), the time and
    bound at phase 9's largest bucket (8192, 8192) (no PyTorch call
    computes the EM, so ``library_ms`` is null), every phase 9 window's
    row, and the kernel's ms in the profiled EM."""
    big = max((r for r in erows if r["case"] == "shape"),
              key=lambda r: r["R"] * r["V"])
    return {
        "name": "phase_em", "route": "cuda",
        "source": "longcalld_torch/csrc/phase_em.cu",
        "replaces": "longcalld_tpu/ops/phase_kernel.py:83",
        "replaces_kind": "XLA program (_phase_fixpoint, jax.jit at :259)",
        **{k: v["phase_em"] for k, v in path_launches.items()},
        "launch_shapes": path_shapes,
        "max_abs_err": max(r["max_abs_err"] for r in erows),
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": None,
        "shape": {"R": big["R"], "V": big["V"], "n_iter": big["n_iter"],
                  "ctas": big["ctas"]},
        "host_ms": big["host_ms"], "bytes_3x_ms": big["bytes_3x_ms"],
        "profiled_em_ms": sum(v for k, v in prof.items() if "phase_em" in k),
        "cta_counts": cta_counts, "thread_runs": thread_runs,
        "shapes": erows}


def main() -> int:
    import torch
    t_smoke = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from longcalld_torch.utils import kbuild

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, device {kind}", flush=True)
    print(guard("1"), flush=True)

    t0 = time.perf_counter()
    kbuild.load()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"({kbuild.library_path()})", flush=True)
    for line in kbuild.build_log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print(f"  nvcc: {line.strip()}")
    print(guard("2"), flush=True)

    krows = check_kernels(KERNEL_SHAPES)
    check_configs()
    check_offband_walk(256)
    check_long_runs(256)
    check_overflow(256)
    print(guard("3"), flush=True)

    # phase 4's contig stays for phase 6 (c); the directory's finalizer
    # removes it on any exit
    tmp4 = tempfile.TemporaryDirectory()
    d = tmp4.name
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
    main_contig = (fa, bam)
    forced = reports["forced"]
    for k, v in forced["launches"].items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched in the forced "
                                 "run")
    if forced["phase_cuda_calls"] <= 0:
        raise AssertionError("phasing EM never ran on CUDA in the forced run")
    for name in ("calibrated", "forced"):
        rep = reports[name]
        if rep["phase_cuda_calls"] != rep["launches"]["phase_em"]:
            raise AssertionError(f"the {name} run ran {rep['phase_cuda_calls']}"
                                 f" CUDA EMs and {rep['launches']['phase_em']}"
                                 " EM kernel launches")
    if any(reports["host"]["launches"].values()):
        raise AssertionError("host-only run launched a kernel")
    print(f"VCF bodies byte-equal across calibrated/forced/host: "
          f"{len(bodies['host'])} records", flush=True)
    prof = profile_align_device()
    print(guard("4"), flush=True)

    mode = nvidia_smi("compute_mode")
    print(f"compute mode: {mode}; os.cpu_count(): {os.cpu_count()}",
          flush=True)
    if "exclusive" in mode.lower():
        raise AssertionError(f"compute mode {mode}: several device worker "
                             "processes cannot share the card")
    hp = min(POOL_PROCS, os.cpu_count() or 1)
    if hp < 2:
        raise AssertionError("the pool needs at least 2 cores")
    if hp < POOL_PROCS:
        print(f"only {os.cpu_count()} cores: {hp} workers over a "
              f"{2 * hp}-window contig", flush=True)
    with tempfile.TemporaryDirectory() as d:
        L = 2 * hp * WINDOW
        t0 = time.perf_counter()
        fa, bam, n_reads, n_truth = build_workload(d, L=L)
        print(f"workload: {L / 1e6:g} Mb contig, {n_truth} planted "
              f"variants, {n_reads} reads, built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        pbodies, preports = run_pool(fa, bam, hp)
        for name in ("device_workers", "in_process"):
            if pbodies[name] != pbodies["host_workers"]:
                raise AssertionError(f"VCF body of the {name} run differs "
                                     "from the host workers' run")
        if not pbodies["host_workers"]:
            raise AssertionError("no variant records on the pool")
        check_vcf(pbodies["host_workers"], fa)
    pdev, phost = preports["device_workers"], preports["host_workers"]
    pseq = preports["in_process"]
    for name, rep in preports.items():
        if (any(rep["parent_launches"].values())
                or rep["parent_phase_cuda_calls"]):
            raise AssertionError(f"the parent launched a kernel in the "
                                 f"{name} run")
    for k, v in pdev["worker_launches"].items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched in a device "
                                 "worker")
    if pdev["worker_phase_cuda_calls"] <= 0:
        raise AssertionError("phasing EM never ran on CUDA in a worker")
    if pdev["worker_phase_cuda_calls"] != pdev["worker_launches"]["phase_em"]:
        raise AssertionError(f"the device workers ran "
                             f"{pdev['worker_phase_cuda_calls']} CUDA EMs and "
                             f"{pdev['worker_launches']['phase_em']} EM kernel"
                             " launches")
    busy = [w for w, v in pdev["cells_device_by_worker"].items() if v > 0]
    if len(busy) < 2:
        raise AssertionError(f"device DP cells in fewer than 2 workers: "
                             f"{pdev['cells_device_by_worker']}")
    if phost["cells_device"] != 0 or any(phost["worker_launches"].values()):
        raise AssertionError("host-only workers ran device work")
    if pseq["cells_device"] != 0:
        raise AssertionError("the host-only in-process run ran device work")
    print(f"pool: VCF bodies byte-equal across device workers, host "
          f"workers and in-process: {len(pbodies['host_workers'])} records; "
          f"walls {pdev['wall_s']:.3f} s (device workers) / "
          f"{phost['wall_s']:.3f} s (host workers) / {pseq['wall_s']:.3f} s "
          f"(in-process, host only, 1 thread); device cells in {len(busy)} "
          f"workers; card memory in use {pdev['card_mem_before_mib']:.0f} "
          f"MiB before, {pdev['peak_card_mem_mib']:.0f} MiB at peak",
          flush=True)
    print(guard("5"), flush=True)

    mesh = phase_mesh()
    print(f"mesh: {mesh} ({torch.cuda.device_count()} cards visible)",
          flush=True)
    check_mesh_em(mesh)
    mbody, mrep = run_mesh_call(*main_contig, mesh)
    tmp4.cleanup()
    if mbody != bodies["host"]:
        raise AssertionError("VCF body of the mesh run differs from the "
                             "host-only run")
    for k in ("band_fwd", "band_bwd"):
        if mrep["launches"][k] <= 0:
            raise AssertionError(f"kernel {k} never launched in the mesh run")
    if mrep["phase_sharded_calls"] <= 0 or mrep["phase_cuda_calls"] <= 0:
        raise AssertionError("the sharded EM never ran on CUDA in the mesh "
                             "run")
    print(f"mesh call: VCF body byte-equal to host only: {len(mbody)} "
          f"records; wall {mrep['wall_s']:.3f} s", flush=True)
    print(guard("6"), flush=True)

    # phase 7: the other band widths
    t7 = time.perf_counter()
    brows = check_kernels(BAND_SHAPES)
    bench = bench_kernels()
    walks = {b: check_offband_walk(b) for b in WALK_BANDS}
    long_runs = {b: check_long_runs(b) for b in WALK_BANDS}
    overflow = check_overflow(4096)
    arows = run_align_batch()
    wide_cfgs = check_wide_configs()
    print(f"band widths: both kernels bit-equal at B={list(BANDS)}, "
          f"{len(wide_cfgs)} wide configurations of band_fwd bit-equal, "
          f"{sum(r['escape'] for r in brows)} batches with an escape pair; "
          f"walks off band {walks}; long-run reloads {long_runs}; overflow "
          f"n_ev at B 4096 {overflow}; phase 7 "
          f"took "
          f"{time.perf_counter() - t7:.1f} s", flush=True)
    print(guard("7"), flush=True)

    t8 = time.perf_counter()
    soak, soak_launches = run_soak()
    print(f"soak: {soak['counts']} over {SOAK_SEEDS} seeds, launches "
          f"{soak_launches}; phase 8 took {time.perf_counter() - t8:.1f} s",
          flush=True)
    print(guard("8"), flush=True)

    t9 = time.perf_counter()
    erows, em_counts, em_thread_runs = check_em(card_int32_rate())
    em_prof = profile_em_child()
    print(f"phase_em: bit-equal at {len(erows)} windows, "
          f"{len(em_counts)} grid sizes and {em_thread_runs} EMs under "
          f"{EM_THREADS} threads; phase 9 took "
          f"{time.perf_counter() - t9:.1f} s", flush=True)
    print(guard("9"), flush=True)

    path_launches = {"launches": forced["launches"],
                     "procs_launches": pdev["worker_launches"],
                     "mesh_launches": mrep["launches"],
                     "soak_launches": soak_launches}
    kernels = kernel_entries(krows, brows, bench, arows, path_launches,
                             forced["launch_shapes"], prof)
    kernels.append(em_entry(erows, path_launches, em_prof, em_counts,
                            em_thread_runs, forced["em_launch_shapes"]))
    print(f"chip_smoke: phases 1-9 took {time.perf_counter() - t_smoke:.1f} s",
          flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
