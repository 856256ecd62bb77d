"""Command-line interface of the port: `longcalld-torch call ref.fa in.bam`.

Counterpart of longcalld_tpu/cli.py:main (:258-329).  The option surface,
the option mapping and `merge` are the JAX package's (build_parser,
opts_from_args, merge_vcfs); `call` runs longcalld_torch's run_call on
cuda:0 (``--no-device``: host only), and ``--profile DIR`` writes a
torch.profiler trace (DIR/trace.json, viewable in Perfetto or
chrome://tracing).
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from longcalld_tpu.cli import build_parser, merge_vcfs, opts_from_args


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
    return out


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    parser = build_parser()
    parser.prog = "longcalld-torch"
    args, extra = parser.parse_known_args(argv)
    bad = [a for a in extra if a.startswith("-")]
    if bad:
        parser.error(f"unrecognized arguments: {' '.join(bad)}")
    if extra:
        if getattr(args, "bams", None) is None:
            parser.error(f"unrecognized arguments: {' '.join(extra)}")
        args.bams = list(args.bams) + extra
    from longcalld_tpu.utils import log
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
            from longcalld_tpu.io.bgzf import BgzfWriter

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
