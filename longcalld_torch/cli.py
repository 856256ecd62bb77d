"""Command-line interface of the port: `longcalld-torch call ref.fa in.bam`.

Option surface mirrors the reference CLI (reference/src/call_var_main.c
:907-987) including the two-pass preset handling (--hifi/--ont first, then
overrides); build_parser, merge_vcfs and opts_from_args are
longcalld_tpu/cli.py's.  `call` runs longcalld_torch's run_call on cuda:0
(``--no-device``: host only), and ``--profile DIR`` writes a
torch.profiler trace (DIR/trace.json, viewable in Perfetto or
chrome://tracing) with the spans of every process of the run
(utils/counters: the pool workers' windows and stages among them) as
events of their own processes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Optional

from longcalld_torch.config import CallOpts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="longcalld-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("call", help="call small + structural variants")
    c.add_argument("ref_fa")
    # reference usage: <ref.fa> <input.bam/cram> [region ...] — trailing
    # positionals that are not existing files are treated as regions
    c.add_argument("bams", nargs="+",
                   help="input BAM/CRAM(s), then optional region specs")
    c.add_argument("--hifi", action="store_true",
                   help="PacBio HiFi preset (default)")
    c.add_argument("--ont", action="store_true", help="ONT preset")
    c.add_argument("-L", "--input-is-list", action="store_true",
                   help="the input file is a list of BAM/CRAM paths")
    c.add_argument("-X", "--extra-bam", action="append", default=[],
                   help="extra input BAM/CRAM of the same sample")
    c.add_argument("-o", "--out-vcf", default=None)
    c.add_argument("-O", "--out-type", default=None, choices=["v", "z"],
                   help="v: plain VCF, z: bgzip-compressed VCF")
    c.add_argument("-b", "--out-bam", default=None,
                   help="write phased BAM with HP/PS tags")
    c.add_argument("-C", "--out-cram", default=None,
                   help="write phased CRAM with HP/PS tags")
    c.add_argument("-S", "--out-sam", default=None,
                   help="write phased SAM text with HP/PS tags")
    c.add_argument("--refine-aln", action="store_true")
    c.add_argument("-s", "--mosaic", "--somatic", dest="mosaic",
                   action="store_true",
                   help="call somatic/mosaic variants")
    c.add_argument("-T", "--te-seqs", "--trans-elem", dest="te_seqs",
                   default=None,
                   help="TE consensus FASTA for MEI annotation")
    c.add_argument("-r", "--region", action="append", default=[],
                   help="region(s) chr[:beg[-end]]")
    c.add_argument("-R", "--region-file", "--regions-file",
                   dest="region_file", default=None, help="BED file")
    c.add_argument("--ref-idx", default=None,
                   help=".fai index path for the reference FASTA")
    c.add_argument("-n", "--sample-name", default=None)
    c.add_argument("-t", "--threads", type=int, default=8)
    c.add_argument("-a", "--autosome", action="store_true",
                   help="autosomes only")
    c.add_argument("--autosome-XY", dest="autosome_xy", action="store_true",
                   default=True)
    c.add_argument("--all-ctg", action="store_true",
                   help="call on all chromosomes/contigs")
    c.add_argument("-E", "--exclude-ctg", action="append", default=[],
                   help="exclude contig/chromosome (repeatable)")
    c.add_argument("-m", "--min-mq", "--min-mapq", dest="min_mq",
                   type=int, default=None)
    c.add_argument("-q", "--min-bq", dest="min_bq", type=int, default=None)
    c.add_argument("-d", "--min-dp", "--min-cov", dest="min_dp",
                   type=int, default=None)
    c.add_argument("-D", "--min-alt-dp", "--alt-cov", dest="min_alt_dp",
                   type=int, default=None)
    c.add_argument("--min-af", "--alt-ratio", dest="min_af",
                   type=float, default=None)
    c.add_argument("--max-af", type=float, default=None)
    c.add_argument("--max-cov", type=int, default=None,
                   help="max. read coverage for noisy regions")
    c.add_argument("-l", "--min-sv-len", type=int, default=None,
                   help="min length to flag as SV (SVLEN/SVTYPE/TSD INFO)")
    c.add_argument("--gap-aln", default=None,
                   choices=["left", "right", "l", "r"],
                   help="gap placement convention")
    c.add_argument("--som-alt", type=int, default=None,
                   help="min alt reads for a somatic variant")
    c.add_argument("--som-mei-alt", type=int, default=None,
                   help="min alt reads for a somatic MEI variant")
    c.add_argument("--max-somvar", default=None, metavar="M,W",
                   help="max somatic vars per window (m,w)")
    c.add_argument("--max-xgap", type=int, default=None,
                   help="max subs/gap-bases per noisy sliding window")
    c.add_argument("--win-size", type=int, default=None,
                   help="noisy-region sliding window size")
    c.add_argument("--merge-dis", type=int, default=None,
                   help="max distance to merge noisy SV regions")
    c.add_argument("--end-clip", type=int, default=None,
                   help="max end-clip bases before a clip region is noisy")
    c.add_argument("--clip-flank", type=int, default=None,
                   help="flank window for noisy clip regions")
    c.add_argument("--hap-read", type=int, default=None,
                   help="min full-span reads per hap in noisy regions")
    c.add_argument("--no-vcf-header", "-H", action="store_true")
    c.add_argument("--amb-base", action="store_true")
    c.add_argument("--read-names", "--out-var-rnames", dest="read_names",
                   action="store_true",
                   help="output supporting read names (ALTREADS)")
    c.add_argument("--out-sv-rnames", action="store_true",
                   help="output supporting read names for SVs")
    c.add_argument("--out-som-var-rnames", action="store_true",
                   help="output supporting read names for somatic variants")
    c.add_argument("--no-device", action="store_true",
                   help="host-only execution (no CUDA kernels)")
    c.add_argument("--host-procs", type=int, default=-1,
                   help="window-range worker processes for many-window "
                        "streams (-1 = follow -t, 0 = disable)")
    c.add_argument("--window-devices", type=int, default=0,
                   help="round-robin busy windows over this many local "
                        "devices (0 = all visible)")
    c.add_argument("--device-min-cells", type=int, default=None,
                   help="alignment pairs at or below this many DP cells "
                        "run on the host C aligner (default: derived from "
                        "measured link latency + host throughput)")
    c.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run, with the "
                        "spans of every process of the run (pool workers' "
                        "windows and stages included), to DIR/trace.json "
                        "(view in Perfetto)")
    c.add_argument("-V", "--verbose", action="count", default=0,
                   help="debug verbosity (repeat: 1 window summaries, "
                        "2 candidate sites, 3 digars)")
    c.add_argument("--shard", default=None, metavar="i/n|auto",
                   help="multi-host: process region chunks with "
                        "chunk %% n == i ('auto' = RANK of WORLD_SIZE)")
    c.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="persist per-window results under DIR; a re-run "
                        "with the same options resumes from completed "
                        "windows (VCF and -b/-C/-S alignment output)")
    m = sub.add_parser("merge", help="merge per-shard VCFs")
    m.add_argument("vcfs", nargs="+")
    m.add_argument("-o", "--out-vcf", default=None)
    return p


def merge_vcfs(paths: List[str], out) -> int:
    """Concatenate shard VCFs into one position-sorted VCF.  The header is
    taken from the first file; contig rank follows its ##contig order."""
    import gzip as _gzip

    def open_text(p):
        return _gzip.open(p, "rt") if p.endswith(".gz") else open(p)

    header: List[str] = []
    rank: dict = {}
    records = []
    for pi, path in enumerate(paths):
        with open_text(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if line.startswith("#"):
                    if pi == 0:
                        header.append(line)
                        if line.startswith("##contig=<ID="):
                            name = line.split("ID=")[1].split(",")[0] \
                                .rstrip(">")
                            rank[name] = len(rank)
                    continue
                f0 = line.split("\t", 2)
                records.append((rank.get(f0[0], 1 << 30), int(f0[1]), line))
    records.sort(key=lambda r: (r[0], r[1]))
    for line in header:
        out.write(line + "\n")
    for _, _, line in records:
        out.write(line + "\n")
    return len(records)


def _split_inputs(args: argparse.Namespace):
    """Reference usage `<ref.fa> <input> [region ...]`: trailing
    positionals that are not existing files are region specs; -L expands a
    list file; -X appends extra BAM/CRAMs of the same sample."""
    import os
    bams: List[str] = []
    regions = list(args.region)
    for i, a in enumerate(args.bams):
        if i == 0 or os.path.exists(a) or "://" in a:
            bams.append(a)
        else:
            regions.append(a)
    if args.input_is_list:
        expanded: List[str] = []
        for path in bams:
            with open(path) as f:
                expanded += [l.strip() for l in f if l.strip()]
        bams = expanded
    bams += list(args.extra_bam)
    return bams, regions


def opts_from_args(args: argparse.Namespace) -> CallOpts:
    base = CallOpts.ont() if args.ont else CallOpts.hifi()
    bams, regions = _split_inputs(args)
    out_aln = args.out_cram or args.out_bam or args.out_sam
    overrides = dict(
        ref_fa_fn=args.ref_fa,
        in_bam_fns=bams,
        regions=regions,
        reg_bed_fn=args.region_file,
        ref_fai_fn=args.ref_idx,
        sample_name=args.sample_name,
        out_vcf_fn=args.out_vcf,
        out_bam_fn=out_aln,
        out_is_cram=args.out_cram is not None,
        out_is_sam=(args.out_cram is None and args.out_bam is None
                    and args.out_sam is not None),
        refine_bam=args.refine_aln,
        out_somatic=args.mosaic,
        te_seq_fn=args.te_seqs,
        n_threads=args.threads,
        only_autosome=args.autosome,
        only_autosome_XY=not args.all_ctg,
        exc_tnames=args.exclude_ctg,
        no_vcf_header=args.no_vcf_header,
        out_amb_base=args.amb_base,
        output_var_rnames=args.read_names,
        output_sv_rnames=args.out_sv_rnames,
        output_somatic_var_rnames=args.out_som_var_rnames,
        use_device=not args.no_device,
        host_procs=args.host_procs,
        window_devices=args.window_devices,
        device_min_cells=args.device_min_cells,
        shard=args.shard,
        checkpoint_dir=args.checkpoint,
    )
    if args.all_ctg:
        overrides["only_autosome"] = False
    for name, key in (("min_mq", "min_mq"), ("min_bq", "min_bq"),
                      ("min_dp", "min_dp"), ("min_alt_dp", "min_alt_dp"),
                      ("min_af", "min_af"), ("max_af", "max_af"),
                      ("max_cov", "max_noisy_reg_cov"),
                      ("min_sv_len", "min_sv_len"),
                      ("som_alt", "min_somatic_alt_dp"),
                      ("som_mei_alt", "min_somatic_te_dp"),
                      ("max_xgap", "noisy_reg_max_xgaps"),
                      ("win_size", "noisy_reg_slide_win"),
                      ("merge_dis", "noisy_reg_merge_dis"),
                      ("end_clip", "end_clip_reg"),
                      ("clip_flank", "end_clip_reg_flank_win"),
                      ("hap_read", "min_hap_full_reads")):
        v = getattr(args, name)
        if v is not None:
            overrides[key] = v
    if args.gap_aln is not None:
        overrides["gap_aln"] = 1 if args.gap_aln in ("left", "l") else 2
    if args.max_somvar is not None:
        m, w = args.max_somvar.split(",")
        overrides["somatic_win_max_vars"] = int(m)
        overrides["somatic_win"] = int(w)
    return dataclasses.replace(base, **overrides)


def _start_profiler():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, path: str) -> str:
    prof.stop()
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "trace.json")
    prof.export_chrome_trace(out)
    _add_spans(out)
    return out


def _add_spans(path: str) -> None:
    """Add the spans of every process of the run (utils/counters, the
    pool workers' shipped ones among them) to the Chrome trace at
    ``path`` as complete ("X") events, each under its own process id and
    thread, on the trace's own time base: kineto writes ``ts`` in
    microseconds after ``baseTimeNanoseconds`` of the same Unix-ns clock
    that stamps the spans."""
    from longcalld_torch.utils import counters
    with open(path) as fh:
        trace = json.load(fh)
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = trace.setdefault("traceEvents", [])
    workers = {}
    for s in counters.spans():
        if s.worker is not None:
            workers[s.pid] = s.worker
        args = dict(s.attrs or {}, window=s.window, span_id=s.id,
                    parent_id=s.parent)
        events.append({"ph": "X", "cat": "span", "name": s.name,
                       "pid": s.pid, "tid": s.tid,
                       "ts": (s.t0 - base) / 1e3, "dur": (s.t1 - s.t0) / 1e3,
                       "args": args})
    for pid, k in workers.items():
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": f"pool worker {k}"}})
    with open(path, "w") as fh:
        json.dump(trace, fh)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    bad = [a for a in extra if a.startswith("-")]
    if bad:
        parser.error(f"unrecognized arguments: {' '.join(bad)}")
    if extra:
        if getattr(args, "bams", None) is None:
            parser.error(f"unrecognized arguments: {' '.join(extra)}")
        args.bams = list(args.bams) + extra
    from longcalld_torch.utils import log
    if args.cmd == "call":
        log.set_verbose(args.verbose)
        from longcalld_torch.core.pipeline import run_call
        opt = opts_from_args(args)
        cmdline = "longcalld-torch " + " ".join(argv)
        log.info("main", f"Command: {cmdline}")
        prof = _start_profiler() if args.profile else None
        bgzip_out = (getattr(args, "out_type", None) == "z"
                     or (opt.out_vcf_fn or "").endswith(".gz"))
        if bgzip_out:
            from longcalld_torch.io.bgzf import BgzfWriter

            raw = (open(opt.out_vcf_fn, "wb") if opt.out_vcf_fn
                   else sys.stdout.buffer)
            w = BgzfWriter(raw, n_threads=opt.n_threads)

            class _Text:
                def write(self, s: str) -> int:
                    w.write(s.encode())
                    return len(s)

            run_call(opt, _Text(), cmdline)
            w.close()
            if opt.out_vcf_fn:
                raw.close()
        elif opt.out_vcf_fn:
            with open(opt.out_vcf_fn, "w") as f:
                run_call(opt, f, cmdline)
        else:
            run_call(opt, sys.stdout, cmdline)
        if prof is not None:
            out = _stop_profiler(prof, args.profile)
            log.info("main", f"profiler trace written to {out}")
        log.exit_summary()
        return 0
    if args.cmd == "merge":
        if args.out_vcf:
            with open(args.out_vcf, "w") as f:
                merge_vcfs(args.vcfs, f)
        else:
            merge_vcfs(args.vcfs, sys.stdout)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
