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
     be bit-equal (tolerance 0, all are integers); each shape's CUDA-event
     ms beside its bound (fwd_bound, bwd_bound below; band_bwd and
     compact_events queued behind a sleep kernel, so the card's own time,
     with their host-included time beside it); (b) every
     configuration of band_fwd's warp design (warps per pair x pairs per
     CTA, at B 128, 256, 384 and 512) against the plain version at Lp 1024,
     batch 67, bit-equal; (c) band_bwd against its plain version on random
     traceback bytes at B 256 (walks off each band edge), and on the long
     runs of tests/torch_helpers.py:random_walk_inputs (an insertion chain
     of 151 columns, a D run of up to 46 rows: both leave band_bwd's
     shared-memory window) at Lp 33 and 1000, bit-equal, with window
     reloads counted;
  4. the main path: a seeded 2 Mb diploid contig (four 500 kb windows,
     30x 15 kb HiFi-like reads) called three times through the port's
     run_call -- calibrated routing threshold, forced device
     (device_min_cells=1), host only -- with byte-equal VCF bodies, both
     kernels and the phasing EM launched in the forced run, and jax never
     imported;
  5. the whole-genome path: the same reads over a seeded 8 Mb contig
     (16 windows, so 8 explicit worker processes engage the window-range
     pool) called through run_call with host_procs=8 -- (a) device
     workers (procs_use_device, device_min_cells=1), all on cuda:0, and
     (b) host-only workers -- and, for the walls' sake, (c) in-process
     host-only (host_procs=0); byte-equal VCF bodies, no kernel launched
     in the parent, both kernels and the phasing EM launched inside the
     workers of (a), device DP cells in at least two workers, none in (b)
     or (c), and jax never imported.  A host with fewer than 8 cores
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
     rule), Lp in {256, 2048}, batch 64, plus B = Lp = 4096, bit-equal,
     with plen == 0 pairs, dummies and, where the pattern is long enough
     for its path to leave the band, a band-escape pair; (b) CUDA-event ms
     and DP cells/s of both kernels at bench.py's microbench shape (batch
     64, B 2048, Lp 2000); (c) the walk on random traceback bytes at B
     1024 and 4096, bit-equal, with walks off the left edge and off the
     right edge counted apart (each must happen), and on the long runs at
     B 1024 and 4096, Lp 33 and 1000, as in phase 3 (c); (d) BatchAligner.
     _align_batch on cuda:0 over seeded SV-like pairs (band buckets 1024,
     4096 and 5128), equal to the same aligner on CPU tensors (the plain
     versions), with both kernels launched at 1024 and 4096 and nothing
     launched for the 5128 group.
Every phase fails if jax or any module of the JAX package (longcalld_tpu)
is in sys.modules, and its last line says so.
The last lines are the card line, a JSON line of the kernels (with
``shapes`` and ``bands`` lists per kernel), and {"ok": true, "device":
{...}}.
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
BANDS = (128, 384, 1024, 1152, 2048, 4096)
BAND_LP = 2048               # the Lp of each width's timing in the JSON line
BAND_SHAPES = ([(b, Lp, 64) for b in BANDS for Lp in (256, BAND_LP)]
               + [(4096, 4096, 64)])
BENCH_SHAPE = (2048, 2000, 64)   # bench.py:178's microbench (B, Lp, batch)
WALK_BANDS = (1024, 4096)
LONG_RUN_LPS = (33, 1000)    # Lp of the long-run walks, phases 3 (c), 7 (c)
WINDOW = 500_000             # CallOpts' default window
POOL_PROCS = 8               # phase 5 workers (capped by the host's cores)
MESH_SHARDS = 4              # phase 6 mesh size
EM_SHAPES = [(2048, 2048), (8192, 8192)]   # phase 6 (a): (R, V) buckets


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


def check_kernels(shapes, plain_reps=1):
    """Kernel vs plain on the card; returns per-shape rows."""
    import torch

    from longcalld_torch.ops import band, wfa
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
        tbs_p, fin_p, edge_p = band.banded_dp_plain(*args, *dp)
        torch.cuda.synchronize()
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
        bargs = (tbs_k, args[2], args[3], args[4], fin_k, B, Lp)
        pk_k, b0_k = band.backward_resolve(*bargs)
        pk_p, b0_p, _ = band.backward_resolve_plain(*bargs)
        torch.cuda.synchronize()
        err_b = max(int((pk_k - pk_p).abs().max()),
                    int((b0_k - b0_p).abs().max()))
        if err_b:
            raise AssertionError(f"band_bwd differs from its plain version "
                                 f"at B={B} Lp={Lp} batch={n}: max |diff| "
                                 f"{err_b}")
        reps = max(2, min(20, 40960 // Lp))
        # the walk's epilogue in ops/wfa.py:align_device
        nins, ops = pk_k & ((1 << 14) - 1), pk_k >> 14
        fb, fb_by = fwd_bound(B, Lp, n, int_rate)
        bb, bb_by = bwd_bound(arrays[2], Lp, n, int_rate)
        row = {
            "B": B, "Lp": Lp, "batch": n, "escape": escape,
            "config": list(band.band_fwd_config(B, n, band.sm_count(dev))),
            "fwd_ms": cuda_ms(lambda: band.banded_dp(*args, *dp), reps),
            "fwd_plain_ms": cuda_ms(lambda: band.banded_dp_plain(*args, *dp),
                                    plain_reps),
            # band_bwd and compact_events run faster than the host issues
            # them: their ms are the card's (queued), the wrapper's and
            # compact_events' host-included ones beside them
            "bwd_ms": cuda_ms(lambda: band.backward_resolve(*bargs), reps,
                              queued=True),
            "bwd_wrapper_ms": cuda_ms(lambda: band.backward_resolve(*bargs),
                                      reps),
            "bwd_plain_ms": cuda_ms(
                lambda: band.backward_resolve_plain(*bargs), plain_reps),
            "compact_ms": cuda_ms(lambda: wfa.compact_events(nins, ops, Lp),
                                  reps, queued=True),
            "compact_host_ms": cuda_ms(
                lambda: wfa.compact_events(nins, ops, Lp), reps),
            "fwd_err": err_f, "bwd_err": err_b,
            "fwd_bound_ms": fb, "fwd_bound_by": fb_by,
            "bwd_bound_ms": bb, "bwd_bound_by": bb_by,
        }
        rows.append(row)
        print(f"kernel B={B} Lp={Lp} batch={n}: band_fwd "
              f"{row['fwd_ms']:.3f} ms (warps per pair, pairs per CTA "
              f"{tuple(row['config'])}; bound {fb:.3f} ms, {fb_by}; plain "
              f"{row['fwd_plain_ms']:.1f} ms), band_bwd {row['bwd_ms']:.3f} "
              f"ms (bound {bb:.4f} ms, {bb_by}; plain "
              f"{row['bwd_plain_ms']:.1f} ms; wrapper, host included "
              f"{row['bwd_wrapper_ms']:.3f} ms), bit-equal; compact_events "
              f"{row['compact_ms']:.3f} ms (host included "
              f"{row['compact_host_ms']:.3f} ms)", flush=True)
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
    n_off = {"left": int((off_edge == band.OFF_LEFT).sum()),
             "right": int((off_edge == band.OFF_RIGHT).sum())}
    if not all(n_off.values()):
        raise AssertionError(f"random walks at B={B} did not leave the band "
                             f"through both edges: {n_off}")
    print(f"band_bwd on random traceback bytes (B={B}, Lp={Lp}, batch={n}):"
          f" bit-equal, walks off the band {n_off}", flush=True)
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
        out[Lp] = int(reloads.item())
        if out[Lp] <= 0:
            raise AssertionError(f"the long runs at B={B} Lp={Lp} never "
                                 "left band_bwd's window")
    print(f"band_bwd on the long runs (B={B}, batch={n}): bit-equal, window "
          f"reloads by Lp {out}", flush=True)
    return out


def bench_kernels():
    """Phase 7 (b): CUDA-event ms of both kernels at bench.py's microbench
    shape and inputs (random P and T, plen = tlen = Lp, dlo = -B/2), with
    DP cells/s = batch * (Lp + 1) * B / time (bench.py:188,254)."""
    import torch

    from longcalld_torch.ops import band
    from longcalld_torch.ops.convert import from_numpy

    B, Lp, n = BENCH_SHAPE
    rng = np.random.default_rng(0)
    P, Tband, plen, tlen, dlo = from_numpy((
        rng.integers(0, 4, (n, Lp)).astype(np.int8),
        rng.integers(0, 4, (n, Lp + B)).astype(np.int8),
        np.full(n, Lp, np.int32), np.full(n, Lp, np.int32),
        np.full(n, -B // 2, np.int32)), torch.device("cuda:0"))
    dp = (B, Lp, X, O1, E1, O2, E2)
    tbs, fin, _ = band.banded_dp(P, Tband, plen, tlen, dlo, *dp)
    fwd = cuda_ms(lambda: band.banded_dp(P, Tband, plen, tlen, dlo, *dp), 10)
    bwd = cuda_ms(lambda: band.backward_resolve(tbs, plen, tlen, dlo, fin, B,
                                                Lp), 10, queued=True)
    cells = n * (Lp + 1) * B
    row = {"B": B, "Lp": Lp, "batch": n, "fwd_ms": fwd, "bwd_ms": bwd,
           "fwd_cells_per_s": cells / (fwd * 1e-3),
           "bwd_cells_per_s": cells / (bwd * 1e-3)}
    print(f"bench shape (B={B}, Lp={Lp}, batch={n}): band_fwd {fwd:.3f} ms "
          f"({row['fwd_cells_per_s']:.4g} DP cells/s), band_bwd {bwd:.3f} ms "
          f"({row['bwd_cells_per_s']:.4g} cells/s)", flush=True)
    return row


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
            "launches": band.launch_counts(),
            "launch_shapes": band.launch_shapes(),
            "phase_cuda_calls": phase_kernel.cuda_calls(),
            "device_min_cells": al.device_min_cells if kw["use_device"]
            else None,
            "aligner_totals": wfa.aligner_totals(),
            "counters": counters.summary_lines(),
        }
        print(f"main path [{name}]: {json.dumps(reports[name])}", flush=True)
    return bodies, reports


class MemPeak:
    """Peak card memory in use (total - free, all processes) sampled from
    torch.cuda.mem_get_info every 50 ms while the block runs."""

    def __init__(self):
        import threading
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)

    def _poll(self):
        import torch
        while not self._stop.is_set():
            free, total = torch.cuda.mem_get_info(0)
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
               ("in_process", 0, dict(use_device=False))]
    bodies, reports = {}, {}
    try:
        for name, procs, kw in configs:
            opt = CallOpts.hifi(ref_fa_fn=fa, in_bam_fns=[bam], n_threads=8,
                                host_procs=procs, **kw)
            counters.reset()
            wfa._ALIGNER_CACHE.clear()
            # the parent's own launch counts: they must stay 0
            band.reset_launch_counts()
            phase_kernel.reset_cuda_calls()
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
                "parent_launches": band.launch_counts(),
                "parent_phase_cuda_calls": phase_kernel.cuda_calls(),
                "worker_launches": {
                    k: snap.get(f"aln_{k}_launches", 0)
                    for k in ("band_fwd", "band_bwd")},
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
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_rec = run_call(opt, out, "chip_smoke", device=mesh[0], mesh=mesh)
    torch.cuda.synchronize()
    report = {"wall_s": time.perf_counter() - t0, "records": n_rec,
              "mesh": mesh, "launches": band.launch_counts(),
              "phase_cuda_calls": phase_kernel.cuda_calls(),
              "phase_sharded_calls": phase_kernel.sharded_calls()}
    print(f"mesh call: {json.dumps(report)}", flush=True)
    return vcf_body(out.getvalue()), report


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


def kernel_entries(krows, brows, bench, arows, path_launches, path_shapes):
    """The ``kernels`` JSON list: per kernel the launch counts of each path
    (``path_launches``: JSON key -> {kernel: count}), the main path's
    launches by "B,Lp,batch" (``path_shapes``), the time and bound at
    phase 3's largest shape (no PyTorch call computes either kernel's
    function, so ``library_ms`` is null), every phase 3 shape's time,
    bound and share of it, the same at each shape the main path launched
    with its launches (``main_path``; band_bwd's entry also has
    compact_events' ms there), per band width the phase 7 time at Lp =
    BAND_LP, the bench-shape time and the _align_batch launches per band
    bucket."""
    big = max(krows, key=lambda r: (r["Lp"], r["batch"]))
    kernels = []
    for name, src, ref, key in (
            ("band_fwd", "longcalld_torch/csrc/band_fwd.cu",
             "longcalld_tpu/ops/pallas_band.py:76", "fwd"),
            ("band_bwd", "longcalld_torch/csrc/band_bwd.cu",
             "longcalld_tpu/ops/pallas_band.py:355", "bwd")):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": ref,
            **{k: v[name] for k, v in path_launches.items()},
            "launch_shapes": path_shapes[name],
            "max_abs_err": max(r[f"{key}_err"] for r in krows + brows),
            "ms": big[f"{key}_ms"], "plain_ms": big[f"{key}_plain_ms"],
            "bound_ms": big[f"{key}_bound_ms"],
            "bound_by": big[f"{key}_bound_by"], "library_ms": None,
            "shape": {"B": big["B"], "Lp": big["Lp"], "batch": big["batch"]},
            "shapes": [{
                "B": r["B"], "Lp": r["Lp"], "batch": r["batch"],
                **({"config": r["config"]} if key == "fwd" else {}),
                "ms": r[f"{key}_ms"], "bound_ms": r[f"{key}_bound_ms"],
                "bound_by": r[f"{key}_bound_by"],
                "share": r[f"{key}_bound_ms"] / r[f"{key}_ms"]}
                for r in krows],
            "main_path": [{
                "B": r["B"], "Lp": r["Lp"], "batch": r["batch"],
                "launches": path_shapes[name][shape_key(r)],
                "ms": r[f"{key}_ms"], "bound_ms": r[f"{key}_bound_ms"],
                **({"wrapper_ms": r["bwd_wrapper_ms"],
                    "compact_events_ms": r["compact_ms"],
                    "compact_events_host_ms": r["compact_host_ms"]}
                   if key == "bwd" else {})}
                for r in krows if shape_key(r) in path_shapes[name]],
            "bands": [{
                "B": r["B"], "Lp": r["Lp"], "batch": r["batch"],
                "ms": r[f"{key}_ms"], "plain_ms": r[f"{key}_plain_ms"],
                "max_abs_err": max(q[f"{key}_err"] for q in brows
                                   if q["B"] == r["B"])}
                for r in brows if r["Lp"] == BAND_LP],
            "bench_shape": {"B": bench["B"], "Lp": bench["Lp"],
                            "batch": bench["batch"],
                            "ms": bench[f"{key}_ms"],
                            "cells_per_s": bench[f"{key}_cells_per_s"]},
            "align_batch_launches": {str(r["B"]): r["launches"][name]
                                     for r in arows}})
    return kernels


def main() -> int:
    import torch
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
    if reports["host"]["launches"] != {"band_fwd": 0, "band_bwd": 0}:
        raise AssertionError("host-only run launched a kernel")
    print(f"VCF bodies byte-equal across calibrated/forced/host: "
          f"{len(bodies['host'])} records", flush=True)
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
        if (rep["parent_launches"] != {"band_fwd": 0, "band_bwd": 0}
                or rep["parent_phase_cuda_calls"]):
            raise AssertionError(f"the parent launched a kernel in the "
                                 f"{name} run")
    for k, v in pdev["worker_launches"].items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched in a device "
                                 "worker")
    if pdev["worker_phase_cuda_calls"] <= 0:
        raise AssertionError("phasing EM never ran on CUDA in a worker")
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
          f"(in-process, host only); device cells in {len(busy)} workers; card "
          f"memory in use {pdev['card_mem_before_mib']:.0f} MiB before, "
          f"{pdev['peak_card_mem_mib']:.0f} MiB at peak", flush=True)
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
    for k, v in mrep["launches"].items():
        if v <= 0:
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
    arows = run_align_batch()
    print(f"band widths: both kernels bit-equal at B={list(BANDS)}, "
          f"{sum(r['escape'] for r in brows)} batches with an escape pair; "
          f"walks off band {walks}; long-run reloads {long_runs}; phase 7 "
          f"took "
          f"{time.perf_counter() - t7:.1f} s", flush=True)
    print(guard("7"), flush=True)

    kernels = kernel_entries(krows, brows, bench, arows, {
        "launches": forced["launches"],
        "procs_launches": pdev["worker_launches"],
        "mesh_launches": mrep["launches"]}, forced["launch_shapes"])
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
