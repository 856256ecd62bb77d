"""Time band_fwd's warp design on one CUDA card, in turns, against a
baseline build of an earlier band_fwd.cu.

    python3 tools/time_band_fwd.py --baseline OLD/band_fwd.cu \
        [--out chiprun_out/time_band_fwd.json] [--quick]

The baseline source exports the earlier C entry point ``lcd_band_fwd(P,
Tband, plen, tlen, dlo, tbs, finals, edge_min, batch, B, Lp, x, o1, e1, o2,
e2, stream)``; nvcc builds it into a temporary directory with the port's
flags.  At each shape -- B = 256 at Lp {256, 1024, 4096} x batch {64, 512}
and at Lp {256, 1024} x batch 2048, and B = 128, 384, 512 at Lp 1024 x
batch {64, 512} -- every configuration of the warp design (warps per pair x pairs per
CTA, ops/band.py:WARP_CONFIGS) must first give the baseline's outputs bit
for bit (at the first shape of each width also the plain version's); then
all are timed with CUDA events in turns: baseline, each configuration,
each configuration again in reverse order, baseline.  Each time is beside
the shape's bound (chip_smoke.py:fwd_bound).  ``--quick`` checks every
configuration at one small shape per width and times nothing.  Prints one
JSON line per shape; ``--out`` writes them all with the card's name, power
limit and clocks.
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

import chip_smoke as cs  # noqa: E402

SHAPES = ([(256, Lp, n) for Lp in (256, 1024, 4096) for n in (64, 512)]
          + [(256, Lp, 2048) for Lp in (256, 1024)]
          + [(B, 1024, n) for B in (128, 384, 512) for n in (64, 512)])
QUICK_SHAPES = [(B, 320, 67) for B in (128, 256, 384, 512)]


def build_baseline(src: str, out_dir: str):
    """nvcc the baseline source into a library; returns its ctypes handle
    and the -Xptxas -v lines."""
    from longcalld_torch.utils import kbuild
    so = os.path.join(out_dir, "libbaseline_band_fwd.so")
    proc = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"baseline build failed:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    fn = lib.lcd_band_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    log = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
           if "registers" in ln or "spill" in ln or "Compiling" in ln]
    return fn, log


def variants(B: int):
    from longcalld_torch.ops import band
    return [(wpp, ppc) for wpp in band.WARP_CONFIGS[B]
            for ppc in (1, 2, 4, 8) if wpp * ppc <= band.MAX_GROUP_WARPS]


def main() -> int:
    import torch

    from longcalld_torch.ops import band
    from longcalld_torch.ops.convert import from_numpy
    from longcalld_torch.utils import kbuild

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_band_fwd: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = cs.card_line()
    clocks = cs.nvidia_smi("clocks.sm,clocks.max.sm")
    print(f"card: {card}; SM clock now, max: {clocks}", flush=True)
    t0 = time.perf_counter()
    kbuild.load()
    build_s = time.perf_counter() - t0
    for line in kbuild.build_log.splitlines():
        if any(w in line for w in ("Compiling", "registers", "spill")):
            print(f"  nvcc: {line.strip()}")
    tmp = tempfile.mkdtemp(prefix="band_fwd_baseline_")
    base_fn, base_log = build_baseline(args.baseline, tmp)
    print(f"port kernels built in {build_s:.2f} s; baseline: "
          f"{base_log}", flush=True)
    int_rate = cs.card_int32_rate()
    rng = np.random.default_rng(2026)
    rows = []
    seen_widths = set()
    for B, Lp, n in (QUICK_SHAPES if args.quick else SHAPES):
        arrays, escape = cs.make_batch(rng, n, Lp, B)
        a = from_numpy(arrays, dev)
        dp = (B, Lp, cs.X, cs.O1, cs.E1, cs.O2, cs.E2)

        def run_base():
            tbs = torch.empty((Lp + 1, n, B), dtype=torch.uint8, device=dev)
            fin = torch.empty((n, 5), dtype=torch.int32, device=dev)
            edge = torch.empty((n,), dtype=torch.int32, device=dev)
            err = base_fn(*(t.data_ptr() for t in a), tbs.data_ptr(),
                          fin.data_ptr(), edge.data_ptr(), n, *dp,
                          torch.cuda.current_stream(dev).cuda_stream)
            kbuild.check(err, "baseline band_fwd")
            return tbs, fin, edge

        ref = run_base()
        if args.quick or B not in seen_widths:
            plain = band.banded_dp_plain(*a, *dp)
            if not all(torch.equal(x, y) for x, y in zip(ref, plain)):
                raise AssertionError(f"baseline differs from the plain "
                                     f"version at B={B}")
            seen_widths.add(B)
        cfgs = variants(B)
        for cfg in cfgs:
            got = band.banded_dp(*a, *dp, config=cfg)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                raise AssertionError(f"configuration {cfg} differs from the "
                                     f"baseline at B={B} Lp={Lp} batch={n}")
        row = {"B": B, "Lp": Lp, "batch": n, "escape": escape,
               "rule": list(band.band_fwd_config(B, n))}
        if not args.quick:
            est = cs.cuda_ms(run_base, 2)
            reps = max(3, min(50, int(60 / max(est, 1e-3))))
            fns = {"baseline": run_base}
            for cfg in cfgs:
                fns[f"{cfg[0]}x{cfg[1]}"] = (
                    lambda c=cfg: band.banded_dp(*a, *dp, config=c))
            names = list(fns)
            order = ["baseline"] + names[1:] + names[1:][::-1] + ["baseline"]
            times = {k: [] for k in names}
            for k in order:
                times[k].append(cs.cuda_ms(fns[k], reps))
            bound, by = cs.fwd_bound(B, Lp, n, int_rate)
            row.update(reps=reps, bound_ms=bound, bound_by=by,
                       ms={k: v for k, v in times.items()},
                       mean_ms={k: sum(v) / len(v) for k, v in times.items()})
            best = min(names[1:], key=lambda k: row["mean_ms"][k])
            row["best"] = best
            row["share_best"] = bound / row["mean_ms"][best]
            row["share_baseline"] = bound / row["mean_ms"]["baseline"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = {"card": card, "clocks_sm_now_max": clocks,
           "clocks_after": cs.nvidia_smi("clocks.sm,clocks.max.sm"),
           "int32_ops_per_s": int_rate, "rows": rows,
           "nvcc": [ln for ln in kbuild.build_log.splitlines()
                    if "registers" in ln or "spill" in ln],
           "baseline_nvcc": base_log}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(f"time_band_fwd: {len(rows)} shapes, every configuration "
          "bit-equal to the baseline", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
