"""The readings the correctness limits are set from, on the chip.

    python3 -m perfbench.control --workload <cell> --seeds 12 \
        --control-seeds 3 --first-seed <n> --out <file.jsonl>

In one process, after one warm-up call, this calls one fresh contig a
seed through the cell's timed path (the same options, sizes and
capture as a benchmark run; the pool is stopped after each call, so
that its workers write their sample) and writes one JSON line a seed:

* the program's readings, judged as a run judges them: ``rec_err``
  (and ``tr_err``), ``aln_bad``, ``em_bad`` and the sample sizes;
* the control's readings on the same seed.  The configuration states
  no numeric precision (the DP and the EM are integer), so each control
  breaks one guarantee the configuration states and is judged by the
  same number as the program:
  - ``control_aln_bad``: the reference aligner put in the program's
    place with its exactness broken, a band of HALF_BANDS[0] diagonals
    beyond the pair's length difference and no escape check, on the
    pairs the program was sampled on;
  - ``control_em_bad``: the reference EM stopped after one round, not at
    its fixpoint, on the EM inputs the program was sampled on
    (``fault_unchanged_em_bad``: the fault "state left unchanged", the
    EM stopped before its first round);
  - ``control_rec_err`` (the first ``--control-seeds`` seeds): the
    program on the same contig with every other read left out, so the
    stated 30x becomes 15x; and ``control_tr_err``, the same call's
    ``tr_err``, where the configuration plants tandem repeats.

The benchmark's own runs never run this."""

import argparse
import gzip
import io
import json
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from perfbench import gen, reference
from perfbench import run
from perfbench.run import call_opts, contig_seeds, judge, log

# the control aligner's half bands beyond the length difference: the
# first is the control, the narrower ones show how far it is from the edge
HALF_BANDS = (16, 4, 0)


def control_readings(cfg, capdir):
    sc = cfg["scoring"]
    score = (sc["mismatch"], sc["gap_open1"], sc["gap_ext1"],
             sc["gap_open2"], sc["gap_ext2"])
    aln = [0] * len(HALF_BANDS)
    em = em0 = n_pairs = n_ems = 0
    for name in sorted(os.listdir(capdir)):
        z = np.load(os.path.join(capdir, name)) if name.endswith(".npz") \
            else None
        if z is None:
            continue
        if name.startswith("pair_"):
            n_pairs += 1
            p, t = z["p"], z["t"]
            bound = reference.cigar_cost(p, t, z["cigar"], *score)
            best = reference.align_cost(p, t, *score, bound=bound)
            for k, hb in enumerate(HALF_BANDS):
                aln[k] += reference.align_cost(p, t, *score,
                                               half_band=hb) != best
        elif name.startswith("em_"):
            n_ems += 1
            ins = [z[f"in{k}"] for k in range(11)]
            full = reference.phase_fixpoint(*ins, max_iter=int(z["max_iter"]))
            em += not np.array_equal(
                reference.phase_fixpoint(*ins, max_iter=1), full)
            em0 += not np.array_equal(
                reference.phase_fixpoint(*ins, max_iter=0), full)
    out = {"control_aln_bad": aln[0], "control_em_bad": int(em),
           "fault_unchanged_em_bad": int(em0),
           "control_pairs": n_pairs, "control_ems": n_ems}
    for hb, n in zip(HALF_BANDS[1:], aln[1:]):
        out[f"control_aln_bad_band{hb}"] = n
    return out


def readings(spec, cell, seeds, control_seeds, device="cuda:0",
             out=None, vcf_dir=None):
    """One row of readings a seed (see the module's docstring); with
    ``vcf_dir`` each call's VCF is kept there, gzipped."""
    import torch

    cfg, traffic, lim = spec.config(cell), spec.traffic(cell), \
        spec.limits(cell)["limits"]
    on_cuda = str(device).startswith("cuda")
    work = tempfile.mkdtemp(prefix="perfbench-control-")
    rows = []
    try:
        model, genome = cfg["reads"], cfg.get("genome", {})
        n = traffic["contig_len"]
        tasks = [(work, "warm", "chr1", contig_seeds(seeds[0] - 1, 1)[0],
                  model, genome, n, 1)]
        for k, s in enumerate(seeds):
            cs = contig_seeds(s, 1)[0]
            tasks.append((work, f"s{s}", "chr1", cs, model, genome, n, 1))
            if k < control_seeds:
                tasks.append((work, f"h{s}", "chr1", cs, model, genome, n,
                              1, 2))
        t = time.time()
        with ProcessPoolExecutor(
                run.GEN_PROCS,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            contigs = {c["stem"]: c for c in ex.map(gen.make_contig, tasks)}
        log(f"made {len(contigs)} contigs in {time.time() - t:.1f} s")

        from longcalld_torch import cli
        from longcalld_torch.core import pipeline, procpool
        from longcalld_torch.ops import phase_kernel
        from longcalld_torch.utils import counters
        from perfbench import capture

        def em_launches():
            if traffic["expect"] == "pool":
                return counters.snapshot().get("aln_phase_em_launches", 0)
            return phase_kernel.em_launch_counts()["phase_em"]

        def one_call(contig, capdir, index):
            os.makedirs(capdir, exist_ok=True)
            opt = call_opts(cli, cfg, traffic, contig, bench_call=index,
                            bench_dir=capdir,
                            bench_seed=contig["seed"] % (1 << 31),
                            bench_root_pid=os.getpid(),
                            bench_em_every=run.EM_EVERY,
                            bench_host_pair_cells=run.HOST_PAIR_CELLS,
                            bench_device_pair_cells=run.DEVICE_PAIR_CELLS)
            capture.install(opt)
            e0 = em_launches()
            buf = io.StringIO()
            t0 = time.time()
            pipeline.run_call(opt, buf, device=device)
            if on_cuda:
                torch.cuda.synchronize()
            # the sample is written after the call: this process's now,
            # the pool workers' as they exit
            capture.flush()
            procpool.shutdown()
            return {"contig": contig, "t0": t0, "t1": time.time(),
                    "vcf": buf.getvalue(), "em_launches": em_launches() - e0,
                    "ok": True}

        def checks(call, capdir):
            if vcf_dir:
                name = os.path.basename(capdir) + ".vcf.gz"
                with gzip.open(os.path.join(vcf_dir, name), "wt") as fh:
                    fh.write(call["vcf"])
            return {ch["name"]: ch["value"] for ch in
                    judge(cfg, lim, [call], capdir, on_cuda,
                          call["contig"]["seed"])}

        one_call(contigs["warm"], os.path.join(work, "cap_warm"), -1)
        for k, s in enumerate(seeds):
            capdir = os.path.join(work, f"cap_{s}")
            c = one_call(contigs[f"s{s}"], capdir, 0)
            row = {"cell": cell["name"], "seed": s,
                   "call_s": c["t1"] - c["t0"],
                   "read_bases": c["contig"]["read_bases"],
                   **checks(c, capdir), **control_readings(cfg, capdir)}
            if k < control_seeds:
                hdir = os.path.join(work, f"caph_{s}")
                half = checks(one_call(contigs[f"h{s}"], hdir, 0), hdir)
                row["control_rec_err"] = half["rec_err"]
                if "tr_err" in half:
                    row["control_tr_err"] = half["tr_err"]
            rows.append(row)
            log(json.dumps(row))
            if out is not None:
                out.write(json.dumps(row) + "\n")
                out.flush()
    finally:
        try:
            from longcalld_torch.core import procpool
            from perfbench import capture
            procpool.shutdown()
            capture.reset()
        except ImportError:
            pass
        shutil.rmtree(work, ignore_errors=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--vcf-dir", default=None)
    args = ap.parse_args(argv)

    import torch

    from perfbench.spec import Spec
    if not torch.cuda.is_available():
        log("needs a CUDA card")
        return 2
    spec = Spec()
    seeds = [args.first_seed + k for k in range(args.seeds)]
    with open(args.out, "a") as fh:
        if args.vcf_dir:
            os.makedirs(args.vcf_dir, exist_ok=True)
        readings(spec, spec.cell(args.workload), seeds, args.control_seeds,
                 out=fh, vcf_dir=args.vcf_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
