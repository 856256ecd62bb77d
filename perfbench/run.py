"""Run one cell of the benchmark once.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the cell's contigs from the seed (perfbench/gen.py, on a
pool of processes), then calls one more contig than the window uses, so
that the pool, the kernels and the aligner's calibration are warm.  The
window then calls fresh contigs back to back through
``longcalld_torch.core.pipeline.run_call`` (the body of the CLI's
``call``), with the options the CLI gives the cell's arguments, until
``--seconds`` have passed; every call's wall ends in
``torch.cuda.synchronize()``.  No contig is called twice in a process.

With ``--trace 0`` the result carries the end-to-end metrics, with
``--trace 1`` the per-layer ones (perfbench/metrics/), read under
torch.profiler.  After the window the run judges what the window
produced (perfbench/reference.py): each call's records against the
variants planted in its contig, and the sampled answers of the aligner
and of the phasing EM against the plain references; where the
configuration plants tandem repeats, the loci by haplotype sequence
(``tr_err``, against the cell's limit of that name).  The numbers
compared are printed with their limits as the last lines on standard
error and under ``checks`` in the result, the last line of standard
output."""

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import glob  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "longcalld_tpu")
GIB = float(1 << 30)

# set-up: contigs called before the window (pool start, calibration, the
# kernels' first launches), and the processes that make the inputs
WARMUP_CONTIGS = 1
GEN_PROCS = 8
# the sample of the device layers' answers judged after the window: every
# EM_EVERY-th phasing EM; an aligner pair every HOST_PAIR_CELLS DP cells
# of the pairs the aligner keeps on the host, and every DEVICE_PAIR_CELLS
# of those it sends to the band kernels, of which at most
# DEVICE_PAIRS_JUDGED, drawn from the seed, are judged
EM_EVERY = 4
HOST_PAIR_CELLS = 20_000_000
DEVICE_PAIR_CELLS = 500_000
DEVICE_PAIRS_JUDGED = 150
# fewer judged than these, and the check has not seen the layer
MIN_DEVICE_PAIRS = 20
MIN_EMS = 1


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def banned_modules():
    """Loaded modules whose top-level name is a banned one, compared
    whole (the port's name begins with the JAX package's)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in BANNED})


def contig_seeds(seed: int, n: int):
    """Seeds of the run's n contigs: the generator uses s and s + 1 of
    each, so they are spaced apart."""
    base = int(seed) % (1 << 61)
    return [base * 64 + 2 * k for k in range(n)]


class Memory:
    """perfbench/memsample.py in a process of its own: the host memory of
    this process's tree, and the card's memory in use."""

    def __init__(self, card_uuid="", interval=0.5):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "perfbench.memsample", str(os.getpid()),
             str(interval), card_uuid], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, cwd=ROOT)

    def _send(self, line):
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def go(self):
        self._send("go")

    def host_done(self):
        """No more host samples; the card's go on."""
        self._send("host")

    def stop(self):
        """(host samples as [Unix time, bytes], the card's peak bytes in
        use or None)."""
        out, _ = self.proc.communicate("stop\n", timeout=60)
        got = json.loads(out.strip().splitlines()[-1])
        return got["samples"], got["card_peak"]


def card_uuid(device) -> str:
    """The NVML UUID of ``device`` ("" off CUDA, or where torch has none)."""
    import torch
    if not str(device).startswith("cuda"):
        return ""
    try:
        return "GPU-" + str(torch.cuda.get_device_properties(device).uuid)
    except (AttributeError, RuntimeError):
        return ""


def mem_peak(samples, calls, n_calls):
    """Bytes of the highest sample taken up to the end of the window's
    ``n_calls``-th call (all of them, where it made fewer).  The pool's
    memory grows with each call (its workers' aligner memos keep every
    pair they align), so a fixed count of calls keeps a faster program
    from reading as a larger one."""
    if not calls:
        return 0
    t_end = calls[min(n_calls, len(calls)) - 1]["t1"]
    return max((b for t, b in samples if t <= t_end), default=0)


def stage_seconds(counters) -> dict:
    """{stage: seconds} of utils/counters' stage timers."""
    out = {}
    for line in counters.summary_lines():
        if line.startswith("stage "):
            name, rest = line[len("stage "):].split(": ", 1)
            out[name] = float(rest.split()[0])
    return out


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def read_rate(calls):
    """Mbp/s of read bases over the window: every call's bases over the
    time from the first call's start to the last call's end."""
    if not calls:
        return None
    span = calls[-1]["t1"] - calls[0]["t0"]
    bases = sum(c["contig"]["read_bases"] for c in calls)
    return bases / span / 1e6 if span > 0 else None


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


class BandLaunches:
    """(B, Lp, batch, sum of real rows) of every band_fwd launch of the
    window (traced runs only).  The launch's row lengths stay on the
    device, held, until the window has closed: summing them there would
    add kernels to the traced window."""

    def __init__(self):
        from longcalld_torch.ops import band
        self.band = band
        self.real = band.banded_dp
        self.rows = []

        def banded_dp(P, Tband, plen, tlen, dlo, B, Lp, *a, **k):
            self.rows.append((int(B), int(Lp), int(P.shape[0]), plen))
            return self.real(P, Tband, plen, tlen, dlo, B, Lp, *a, **k)
        self.hook = banded_dp

    def __enter__(self):
        self.band.banded_dp = self.hook
        return self

    def __exit__(self, *exc):
        self.band.banded_dp = self.real

    def launches(self):
        self.__exit__()
        return [(b, lp, n, int(plen.sum())) for b, lp, n, plen in self.rows]


def call_opts(cli, cfg, traffic, contig, **bench):
    """The options the CLI makes of the cell's arguments, for one contig,
    as BenchOpts."""
    from perfbench import capture
    args = cli.build_parser().parse_args(
        ["call", contig["fasta"], contig["bam"]] + list(cfg["cli"])
        + list(traffic["cli"]))
    opt = dataclasses.replace(cli.opts_from_args(args),
                              **traffic.get("opts", {}))
    return capture.bench_opts(opt, **bench)


def run_cell(spec, cell, seed, seconds, trace, device="cuda:0", fault=""):
    """One run of ``cell``; returns (result dict, list of checks).  The
    inputs go to a temporary directory (under $TMPDIR), removed at the
    end."""
    import torch

    cfg, traffic, lim = spec.config(cell), spec.traffic(cell), \
        spec.limits(cell)["limits"]
    workdir = tempfile.mkdtemp(prefix="perfbench-")
    capdir = os.path.join(workdir, "capture")
    os.makedirs(capdir, exist_ok=True)
    on_cuda = str(device).startswith("cuda")
    stack = contextlib.ExitStack()
    try:
        from perfbench import gen
        from perfbench import trace as tr
        n_warm = WARMUP_CONTIGS
        n_win = int(traffic["contigs"])
        seeds = contig_seeds(seed, n_warm + n_win)
        t = time.time()
        contigs = gen.make_contigs(
            workdir, "chr1", seeds, cfg["reads"], cfg.get("genome", {}),
            traffic["contig_len"], procs=GEN_PROCS)
        log(f"made {len(contigs)} contigs of {traffic['contig_len']} bp in "
            f"{time.time() - t:.1f} s")

        from longcalld_torch import cli
        from longcalld_torch.core import pipeline, procpool
        from longcalld_torch.ops import phase_kernel, wfa
        from longcalld_torch.utils import counters
        from perfbench import capture
        if fault == "half_windows":
            stack.enter_context(capture.half_windows())
        bench_kw = dict(bench_dir=capdir, bench_seed=int(seed) % (1 << 31),
                        bench_trace=int(trace), bench_root_pid=os.getpid(),
                        bench_em_every=EM_EVERY,
                        bench_host_pair_cells=HOST_PAIR_CELLS,
                        bench_device_pair_cells=DEVICE_PAIR_CELLS,
                        bench_fault=fault if fault != "half_windows" else "")

        def one_call(contig, index):
            opt = call_opts(cli, cfg, traffic, contig, bench_call=index,
                            **bench_kw)
            capture.install(opt)
            out = io.StringIO()
            t0 = time.time()
            run_call_ok = True
            try:
                pipeline.run_call(opt, out, device=device)
            except Exception:
                run_call_ok = False
                log(f"call {index} failed:\n{traceback.format_exc()}")
            if on_cuda:
                torch.cuda.synchronize()
            return t0, time.time(), out.getvalue(), run_call_ok

        def em_launches():
            if traffic["expect"] == "pool":
                return counters.snapshot().get("aln_phase_em_launches", 0)
            return phase_kernel.em_launch_counts()["phase_em"]

        for k in range(n_warm):
            t0, t1, _, ok = one_call(contigs[k], -1)
            log(f"warm-up call {k}: {t1 - t0:.2f} s")
            if not ok:
                raise RuntimeError("the warm-up call failed")

        mem = Memory(card_uuid(device))
        mem_calls = int(traffic["mem_calls"])
        stage0 = stage_seconds(counters)
        aln0 = wfa.aligner_totals()
        cnt0 = counters.snapshot()
        prof = band_rec = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if on_cuda:
                acts.append(ProfilerActivity.CUDA)
            band_rec = stack.enter_context(BandLaunches())
            prof = profile(activities=acts)
            prof.__enter__()
        mem.go()
        t_window = time.time()
        setup_s = t_window - T_START
        calls = []
        failed = 0
        for contig in contigs[n_warm:]:
            if time.time() - t_window >= seconds:
                break
            e0 = em_launches()
            t0, t1, vcf, ok = one_call(contig, len(calls))
            grew = em_launches() - e0
            calls.append({"contig": contig, "t0": t0, "t1": t1, "vcf": vcf,
                          "em_launches": grew, "ok": ok})
            failed += not ok
            if len(calls) == mem_calls:
                mem.host_done()
        else:
            if time.time() - t_window < seconds:
                log(f"the window ran out of data: {len(calls)} calls took "
                    f"{time.time() - t_window:.1f} s of {seconds} s; a later "
                    "benchmark PR raises the traffic's contig count")
        t_end = calls[-1]["t1"] if calls else time.time()
        if prof is not None:
            prof.__exit__(None, None, None)
        launches = band_rec.launches() if band_rec is not None else []
        host, dev_peak = mem.stop()
        capture.flush()
        if len(calls) < mem_calls:
            log(f"host memory over {len(calls)} calls, fewer than the "
                f"traffic's {mem_calls}")
        if dev_peak is None and on_cuda:
            # no NVML: what this process sees in use now, after the window
            free, total = torch.cuda.mem_get_info(device)
            dev_peak = total - free
            log("the card's memory is read once, after the window: NVML "
                "could not be loaded")
        stage1 = stage_seconds(counters)
        aln1 = wfa.aligner_totals()
        cnt1 = counters.snapshot()
        t_first = calls[0]["t0"] if calls else t_window
        window_s = t_end - t_first
        read_bases = sum(c["contig"]["read_bases"] for c in calls)
        rate = read_rate(calls)
        mb_called = sum(c["contig"]["length"] for c in calls) / 1e6
        log(f"window: {len(calls)} calls, {read_bases} read bases, "
            f"{window_s:.2f} s; {len(host)} host memory samples")

        # stop the pool: a traced worker writes its device trace at exit
        procpool.shutdown()
        events = None
        if trace:
            parts = [tr.Events.of_profiler(prof)]
            for path in sorted(glob.glob(os.path.join(capdir,
                                                      "trace_*.npz"))):
                parts.append(tr.Events.load(path))
            events = tr.Events.merge(parts)
            log(f"traced: {len(parts) - 1} worker traces, "
                f"{len(events.dev)} device events")
        # free the program's state before the reference runs
        for al in list(wfa._ALIGNER_CACHE.values()):
            al.memo_clear()
        if on_cuda:
            torch.cuda.empty_cache()

        metrics = {}
        t0_ns, t1_ns = int(t_first * 1e9), int(t_end * 1e9)
        if not trace:
            values = {
                "read_mbp_per_s": rate,
                # no sample above 0: the source read nothing; no metric
                "peak_host_mem_gib": mem_peak(host, calls, mem_calls) / GIB
                or None,
                "setup_s": setup_s}
            for m in spec.metrics(cell, trace=False):
                if values.get(m["name"]) is not None:
                    metrics[m["name"]] = {"value": values[m["name"]],
                                          "unit": m["unit"]}
        else:
            ctx = {"events": events, "t0_ns": t0_ns, "t1_ns": t1_ns,
                   "mb_called": mb_called, "in_process":
                   traffic["expect"] != "pool",
                   "aligner": delta(aln1, aln0),
                   "counters": delta(cnt1, cnt0),
                   "stages": delta(stage1, stage0),
                   "band_fwd_launches": launches}
            for m in spec.metrics(cell, trace=True):
                v = spec.reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}

        device_info = {"platform": "gpu" if on_cuda else "cpu",
                       "kind": (torch.cuda.get_device_name(0) if on_cuda
                                else "cpu"),
                       "count": int(cell.get("chips", 1)),
                       "memory_peak_bytes": int(dev_peak or 0)}
        result = {"correct": None, "attempted": len(calls),
                  "failed": failed, "metrics": metrics,
                  "device": device_info,
                  "contigs": {"warm_up": [c["seed"] for c in
                                          contigs[:n_warm]],
                              "window": [c["contig"]["seed"] for c in calls]}}
        if trace:
            device_info["busy_s"] = tr.busy_ns(events, t0_ns, t1_ns) / 1e9
            device_info["window_s"] = window_s
            result["breakdown"] = tr.breakdown(events, t0_ns, t1_ns)

        checks = judge(cfg, lim, calls, capdir, on_cuda, seed)
        result["correct"] = bool(calls) and failed == 0 and all(
            c["value"] <= c["limit"] for c in checks)
        result["checks"] = {c["name"]: {"value": c["value"],
                                        "limit": c["limit"]}
                            for c in checks}
        return result, checks
    finally:
        stack.close()
        try:
            from longcalld_torch.core import procpool
            from perfbench import capture
            procpool.shutdown()
            capture.reset()
        except ImportError:
            pass
        shutil.rmtree(workdir, ignore_errors=True)


def judge(cfg, lim, calls, capdir, on_cuda, seed):
    """The numbers compared, each with its limit (``lim``: the cell's)."""
    import numpy as np

    from perfbench import gen, reference

    checks = []
    genome = cfg.get("genome", {})
    repeats = bool(genome.get("tandem_repeats"))
    if repeats and "tr_err" not in lim:
        raise KeyError("the configuration plants tandem repeats, and the "
                       "cell's limits have no tr_err to judge them by")
    # 1. each call's records against its contig's planted variants, in
    # the part of the contig that the reads cover at full depth: within a
    # read length of either end of the simulated span the depth ramps
    # down, and the calls missed there are the contig's, not the caller's.
    # Planted tandem repeat loci are judged by haplotype sequence, and the
    # records and plants of their windows are left out of the rest
    tot = {"truth": 0, "fp": 0, "fn": 0, "zygosity": 0, "tr_loci": 0,
           "tr_bad": 0}
    margin = int(cfg["reads"].get("margin", 2000))
    edge = margin + int(cfg["reads"]["read_len"])
    for c in calls:
        ct = c["contig"]
        ref4, truth = gen.genome_truth(ct["seed"], ct["length"],
                                       cfg["reads"], genome)
        body = [ln for ln in c["vcf"].splitlines()
                if ln and not ln.startswith("#")]
        plants = [t for t in truth if t[1] != "tr"]
        beg, end = edge, ct["length"] - edge
        if repeats:
            loci = [(t[2].beg, t[2].end, t[2].allele(ref4, 1),
                     t[2].allele(ref4, 2)) for t in truth if t[1] == "tr"]
            got = reference.score_tr_loci(body, loci, ref4, beg, end, plants)
            tot["tr_loci"] += got["tr_loci"]
            tot["tr_bad"] += got["tr_bad"]
            body, plants = reference.outside(body, plants, got["windows"])
        got = reference.score_records(body, plants, beg, end, ref4)
        for k in ("truth", "fp", "fn", "zygosity"):
            tot[k] += got[k]
    rec_err = ((tot["fp"] + tot["fn"] + tot["zygosity"])
               / max(tot["truth"], 1))
    log(f"records: {tot['truth']} planted, fp {tot['fp']}, fn {tot['fn']}, "
        f"zygosity {tot['zygosity']}")
    checks.append({"name": "rec_err", "value": rec_err,
                   "limit": lim["rec_err"]})
    if repeats:
        log(f"tandem repeats: {tot['tr_loci']} loci, {tot['tr_bad']} wrong")
        checks.append({"name": "tr_err",
                       "value": tot["tr_bad"] / max(tot["tr_loci"], 1),
                       "limit": lim["tr_err"]})

    # 2. the pool (or the in-process path) drove the card in every call
    if on_cuda:
        no_em = sum(1 for c in calls if c["em_launches"] <= 0)
        checks.append({"name": "calls_without_em_launch", "value": no_em,
                       "limit": 0})

    # 3. the aligner's sampled answers: valid, and at the least cost
    sc = cfg["scoring"]
    score = (sc["mismatch"], sc["gap_open1"], sc["gap_ext1"],
             sc["gap_open2"], sc["gap_ext2"])
    host, dev = [], []
    for path in sorted(glob.glob(os.path.join(capdir, "pair_*.npz"))):
        z = np.load(path)
        (dev if int(z["device"]) else host).append(z)
    n_dev = len(dev)
    if n_dev > DEVICE_PAIRS_JUDGED:
        pick = np.random.default_rng(int(seed) % (1 << 63)).choice(
            n_dev, DEVICE_PAIRS_JUDGED, replace=False)
        dev = [dev[k] for k in sorted(pick)]
    bad = 0
    t = time.time()
    for z in host + dev:
        p, tt = z["p"], z["t"]
        cost = reference.cigar_cost(p, tt, z["cigar"], *score)
        if cost is None or cost != int(z["score"]) or \
                reference.align_cost(p, tt, *score, bound=cost) != cost:
            bad += 1
    log(f"aligner: {len(host)} host-routed and {len(dev)} device-routed "
        f"pairs (of {n_dev} kept) judged in {time.time() - t:.1f} s, "
        f"{bad} bad")
    checks.append({"name": "aln_bad", "value": bad,
                   "limit": lim["aln_bad"]})
    checks.append({"name": "aln_device_pairs_missing",
                   "value": max(0, MIN_DEVICE_PAIRS - len(dev)), "limit": 0})

    # 4. the EM's sampled answers against the plain EM
    ems = sorted(glob.glob(os.path.join(capdir, "em_*.npz")))
    bad = 0
    t = time.time()
    for path in ems:
        z = np.load(path)
        ins = [z[f"in{k}"] for k in range(11)]
        ref = reference.phase_fixpoint(*ins, max_iter=int(z["max_iter"]))
        bad += not np.array_equal(ref, z["out"])
    log(f"phasing EM: {len(ems)} sampled EMs judged in "
        f"{time.time() - t:.1f} s, {bad} differ")
    checks.append({"name": "em_bad", "value": bad, "limit": lim["em_bad"]})
    checks.append({"name": "em_unsampled",
                   "value": int(len(ems) < MIN_EMS), "limit": 0})
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build caches at fixed paths inside the checkout, so only a cell's
    # first run there builds (the port's kernels build into build/ by
    # themselves, its host C libraries into longcalld_torch/native/)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)

    from perfbench.spec import Spec
    try:
        spec = Spec()
        cell = spec.cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        log(f"cannot resolve the cell: {e}")
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell.get("chips", 1)):
        log(f"needs {cell.get('chips', 1)} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import longcalld_torch  # noqa: F401
    except ImportError as e:
        log(f"the program is not here: {e}")
        return 2
    card = power_limit()
    log(f"card: {card}")
    result, checks = run_cell(spec, cell, args.seed, args.seconds,
                              bool(args.trace))
    found = banned_modules()
    if found:
        log(f"modules that must not load did: {', '.join(found)}")
        return 3
    result["card"] = card
    checks_ = result.pop("checks")
    result["checks"] = checks_
    for c in checks:
        log(f"check {c['name']}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
