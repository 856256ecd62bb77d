"""Time band_bwd on one CUDA card, in turns, against a baseline build of an
earlier band_bwd.cu.

    python3 tools/time_band_bwd.py --baseline OLD/band_bwd.cu \
        [--out FILE.json] [--quick]

The baseline source exports the earlier C entry point ``lcd_band_bwd(tbs,
plen, tlen, dlo, finals, packed, b0, [reload_count,] batch, B, Lp,
stream)``; nvcc builds it into a temporary directory with the port's
flags.  Shapes (B, Lp,
batch): at B = 256 the main path's (256, 64), (256, 512), (256, 2048),
(1024, 64), (1024, 512), and (4096, 64), (4096, 512); at B = 1024 and
4096, (2048, 64).  Each shape walks two inputs: ``real``, the traceback
bytes of the port's band_fwd on chip_smoke.make_batch pairs (escape pair
included), and ``random``, tests/torch_helpers.py:random_walk_inputs with
its long runs (an insertion chain of 151 columns, a D run of 46 rows),
whose walks leave the kernel's window far more often (batch capped at 64,
at 16 for B >= 1024).  Before any timing the kernel must give the
baseline's outputs and the plain version's bit for bit on both; so must
it on the long-run inputs at B 256, 1024, 4096 and Lp 33, 1000.  Then
baseline, kernel, kernel, baseline with CUDA events, each run of calls
queued behind a sleep kernel so that the events time the card, not the
host's calls (chip_smoke.cuda_ms); then the wrapper unqueued, host
included, as ops/wfa.py:align_device meets it.  Per shape and input
one JSON line: mean ms of both, the bound (chip_smoke.bwd_bound), us per
row of the longest walk (ms / max plen: the walk is a chain of rows, and
the pairs run side by side), and the kernel's synchronous window reloads
(in all and per walked row).  ``--quick`` checks and times nothing.
``--out`` writes every line with the card's name, power limit and clocks.

``--events`` times the entry that ops/wfa.py:align_device launches,
band.backward_events (the walk with its events epilogue: evs and meta,
no packed walk), against the round it replaced: the baseline source's
walk, then chip_smoke.old_tail (ops/wfa.py:compact_events, the score min
and the meta stack), at the main path's five shapes and (4096, 512), B
256, on both inputs (``real`` with band_fwd's edge_min, ``random`` with
seeded random edge_min).  Both must give the plain version's evs and meta
bit for bit (backward_events_plain), here and on the long-run inputs;
each is timed in turns as above, queued (the card's time) and host
included; the bound is chip_smoke.events_bound.  The baseline may be a
source whose lcd_band_bwd has no reload counter argument (an earlier one)
or has one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as cs  # noqa: E402

MAIN_SHAPES = [(256, 64), (256, 512), (256, 2048), (1024, 64), (1024, 512)]
SHAPES = ([(256, Lp, n) for Lp, n in MAIN_SHAPES + [(4096, 64), (4096, 512)]]
          + [(B, 2048, 64) for B in (1024, 4096)])
EVENT_SHAPES = [(256, Lp, n) for Lp, n in MAIN_SHAPES + [(4096, 512)]]
LONG_SHAPES = [(B, Lp, 16) for B in (256, 1024, 4096) for Lp in (33, 1000)]


def build_baseline(src: str, out_dir: str):
    """nvcc the baseline source into a library; returns its ctypes entry
    point and the -Xptxas -v lines."""
    from longcalld_torch.utils import kbuild
    so = os.path.join(out_dir, "libbaseline_band_bwd.so")
    proc = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"baseline build failed:\n{proc.stderr}")
    fn = ctypes.CDLL(so).lcd_band_bwd
    # the entry gained a nullable reload counter after packed and b0
    with open(src) as f:
        counter = "reload_count" in f.read()
    fn.argtypes = [ctypes.c_void_p] * (8 if counter else 7) + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    log = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
           if "registers" in ln or "spill" in ln]

    def call(*ptrs, batch, B, Lp, stream):
        """ptrs: tbs, plen, tlen, dlo, finals, packed, b0."""
        return fn(*ptrs, *((None,) if counter else ()), batch, B, Lp, stream)
    return call, log


def real_inputs(rng, B, Lp, n, dev):
    """Walk inputs from the port's band_fwd on make_batch pairs, with its
    edge_min."""
    from longcalld_torch.ops import band
    from longcalld_torch.ops.convert import from_numpy
    arrays, _ = cs.make_batch(rng, n, Lp, B)
    a = from_numpy(arrays, dev)
    tbs, finals, edge_min = band.banded_dp(*a, B, Lp, cs.X, cs.O1, cs.E1,
                                           cs.O2, cs.E2)
    return (tbs, a[2], a[3], a[4], finals), arrays[2], edge_min


def random_inputs(rng, B, Lp, n, dev):
    """random_walk_inputs with long runs, and a seeded random edge_min."""
    from longcalld_torch.ops.convert import from_numpy
    from torch_helpers import random_walk_inputs
    arrays = random_walk_inputs(rng, B, Lp, n, spread=60, long_runs=True)
    edge_min = from_numpy((rng.integers(0, 1 << 20, n).astype(np.int32),),
                          dev)[0]
    return tuple(from_numpy(arrays, dev)), arrays[1], edge_min


def main() -> int:
    import torch

    from longcalld_torch.ops import band
    from longcalld_torch.utils import kbuild

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--events", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_band_bwd: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = cs.card_line()
    clocks = cs.nvidia_smi("clocks.sm,clocks.max.sm")
    print(f"card: {card}; SM clock now, max: {clocks}", flush=True)
    t0 = time.perf_counter()
    kbuild.load()
    build_s = time.perf_counter() - t0
    nvcc = [ln.strip() for ln in kbuild.build_log.splitlines()
            if any(w in ln for w in ("Compiling", "registers", "spill"))]
    for line in nvcc:
        print(f"  nvcc: {line}")
    base_fn, base_log = build_baseline(args.baseline,
                                       tempfile.mkdtemp(prefix="band_bwd_"))
    print(f"port kernels built in {build_s:.2f} s; baseline: {base_log}",
          flush=True)
    int_rate = cs.card_int32_rate()
    rng = np.random.default_rng(2026)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run_base(a, B, Lp):
        n = a[0].shape[1]
        packed = torch.empty((Lp, n), dtype=torch.int32, device=dev)
        b0 = torch.empty((n,), dtype=torch.int32, device=dev)
        err = base_fn(*(t.data_ptr() for t in a), packed.data_ptr(),
                      b0.data_ptr(), batch=n, B=B, Lp=Lp, stream=stream)
        kbuild.check(err, "baseline band_bwd")
        return packed, b0

    def fns_of(a, e, B, Lp):
        """The two functions timed against each other: (baseline,
        kernel)."""
        if args.events:
            return (lambda: cs.old_tail(run_base(a, B, Lp), a[4], e, Lp),
                    lambda: band.backward_events(*a, e, B, Lp))
        return (lambda: run_base(a, B, Lp),
                lambda: band.backward_resolve(*a, B, Lp))

    def check(a, e, B, Lp, what):
        """Kernel against baseline and plain version; returns reloads."""
        reloads = torch.zeros(1, dtype=torch.int32, device=dev)
        if args.events:
            got = band.backward_events(*a, e, B, Lp, reloads=reloads)
            plain = band.backward_events_plain(*a, e, B, Lp)
        else:
            got = band.backward_resolve(*a, B, Lp, reloads=reloads)
            plain = band.backward_resolve_plain(*a, B, Lp)[:2]
        ref = fns_of(a, e, B, Lp)[0]()
        torch.cuda.synchronize()
        for name, want in (("baseline", ref), ("plain version", plain)):
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"band_bwd differs from the {name} on "
                                     f"{what} inputs at B={B} Lp={Lp} "
                                     f"batch={a[0].shape[1]}")
        return int(reloads.item())

    long_rows = []
    for B, Lp, n in LONG_SHAPES:
        a, plen, e = random_inputs(rng, B, Lp, n, dev)
        r = check(a, e, B, Lp, "long-run")
        long_rows.append({"B": B, "Lp": Lp, "batch": n, "reloads": r,
                          "walked_rows": int(plen.sum())})
        print(f"long runs B={B} Lp={Lp} batch={n}: bit-equal to baseline "
              f"and plain, {r} window reloads", flush=True)

    rows = []
    for B, Lp, n in EVENT_SHAPES if args.events else SHAPES:
        for kind in ("real", "random"):
            if kind == "real":
                a, plen, e = real_inputs(rng, B, Lp, n, dev)
            else:
                a, plen, e = random_inputs(
                    rng, B, Lp, min(n, 64 if B == 256 else 16), dev)
            bn = a[0].shape[1]
            walked = int(np.minimum(plen, Lp).sum())
            deepest = int(np.clip(plen, 0, Lp).max())
            reloads = check(a, e, B, Lp, kind)
            row = {"B": B, "Lp": Lp, "batch": bn, "input": kind,
                   "main_path": B == 256 and (Lp, n) in MAIN_SHAPES,
                   "walked_rows": walked, "deepest_walk": deepest,
                   "reloads": reloads,
                   "reloads_per_walked_row": reloads / max(walked, 1)}
            if args.events:
                ev = band.backward_events(*a, e, B, Lp)[1][:, 3]
                row.update(events=int(ev.clamp_min(0).sum()),
                           unencodable=int((ev < 0).sum()))
            if not args.quick:
                fns = dict(zip(("baseline", "kernel"), fns_of(a, e, B, Lp)))
                est = cs.cuda_ms(fns["baseline"], 2)
                # queued calls must all fit in the launch queue behind the
                # sleep kernel: the events baseline is ~31 launches a call
                reps = max(3, min(10 if args.events else 50,
                                  int(60 / max(est, 1e-3))))
                times = {k: [] for k in fns}
                for k in ("baseline", "kernel", "kernel", "baseline"):
                    times[k].append(cs.cuda_ms(fns[k], reps, queued=True))
                mean = {k: sum(v) / len(v) for k, v in times.items()}
                bound, by = (cs.events_bound if args.events
                             else cs.bwd_bound)(plen, Lp, bn, int_rate)
                row.update(
                    reps=reps, ms=times, mean_ms=mean, bound_ms=bound,
                    bound_by=by, speedup=mean["baseline"] / mean["kernel"],
                    us_per_row={k: v * 1e3 / max(deepest, 1)
                                for k, v in mean.items()},
                    # the wrapper as align_device calls it, host included
                    wrapper_ms=cs.cuda_ms(fns["kernel"], reps),
                    baseline_host_ms=cs.cuda_ms(fns["baseline"], reps))
            rows.append(row)
            print(json.dumps(row), flush=True)
    out = {"card": card, "clocks_sm_now_max": clocks,
           "mode": "events" if args.events else "walk",
           "clocks_after": cs.nvidia_smi("clocks.sm,clocks.max.sm"),
           "int32_ops_per_s": int_rate, "rows": rows, "long_runs": long_rows,
           "nvcc": nvcc, "baseline_nvcc": base_log}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(f"time_band_bwd: {len(rows)} shape-inputs and {len(long_rows)} "
          "long-run shapes, bit-equal to the baseline and the plain version",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
