"""Profile the device rounds of a forced call on one CUDA card: per pass
the card's busy time, its kernels by name, the count of device events
(kernels, copies, fills) and the band kernels' launches.

    python3 tools/profile_device_round.py [--root DIR] [--passes N] \
        [--work DIR] [--out FILE]

The call is bench_torch.py's ``device_forced`` configuration
(device_min_cells=1, every DP pair on the card) over the seeded 2 Mb
contig of chip_smoke.py phase 4 (chip_smoke.build_workload, seed 2026),
built once under ``--work`` (default build/profile_work, git-ignored)
and reused.  The modules are those of the checkout at ``--root``
(default: this one), put first on sys.path, so that two checkouts can be
compared in turns in one call (parent, change, change, parent), each
building its own kernels.  The measuring code is this checkout's
(bench_torch.profiled_pass with every event name, loaded from here
whatever ``--root`` is).  One warm-up pass, then ``--passes`` passes
under torch.profiler (the busy ms is the union of the card's event
intervals; ``by_name`` each event name's ms and count).  One JSON line a
pass, with the card's name and power limit, the band kernels' launches
and the EM kernel's (``phase_em``, where the checkout has it); ``--out``
appends them to a file.
"""

from __future__ import annotations

import argparse
import importlib.util
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--work", default=os.path.join(HERE, "build",
                                                   "profile_work"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "tests")]

    import torch
    if not torch.cuda.is_available():
        print("profile_device_round: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from longcalld_torch.core.pipeline import run_call
    from longcalld_torch.ops import band, phase_kernel
    # this checkout's bench module, over the modules of --root
    spec = importlib.util.spec_from_file_location(
        "profile_bench", os.path.join(HERE, "bench_torch.py"))
    bench_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_torch)
    em_counts = getattr(phase_kernel, "em_launch_counts", dict)
    em_shapes = getattr(phase_kernel, "em_launch_shapes", dict)
    em_reset = getattr(phase_kernel, "reset_em_launch_counts", lambda: None)

    dev = torch.device("cuda:0")
    fa = os.path.join(args.work, "synth2000000.fa")
    bam = os.path.join(args.work, "synth2000000.bam")
    if not (os.path.exists(fa) and os.path.exists(bam)):
        os.makedirs(args.work, exist_ok=True)
        chip_smoke.build_workload(args.work)
    opt = bench_torch.call_configs(fa, bam)["device_forced"]
    run_call(opt, io.StringIO(), "profile", device=dev)          # warm
    card = chip_smoke.card_line()
    for k in range(args.passes):
        band.reset_launch_counts()
        em_reset()
        row = bench_torch.profiled_pass(opt, dev, every_name=True)
        row.update(root=os.path.relpath(root, HERE), card=card, pass_=k,
                   launches={**band.launch_counts(), **em_counts()},
                   launch_shapes=band.launch_shapes(),
                   em_launch_shapes=em_shapes())
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
