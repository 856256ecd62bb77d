"""End-to-end calling pipeline of the port: longcalld_tpu/core/pipeline.py's
call_window (:153-237) and run_call (:672-944).  Window loading, digars,
sites, classify, profile, genotype, stitch and VCF output are the JAX
package's host code, imported unchanged; phasing and the noisy-region
stage go through the port (longcalld_torch.core.phase / .noisy), whose
device work runs on torch devices.

Differences from the JAX run_call:
* in-process only: the window-range process pool (_run_call_procs) is not
  ported yet, so ``host_procs`` is ignored;
* no executable prewarm (PyTorch has nothing to compile per shape);
* ``device`` is explicit (default cuda:0, raising when CUDA is absent);
  windows round-robin over ``torch.cuda.device_count()`` cards, capped by
  ``window_devices``;
* ``--shard auto`` (the JAX process index) raises; ``--shard i/n`` works;
* ``use_device=False`` is host-only and touches no torch device.
"""

from __future__ import annotations

import sys
from typing import Optional, TextIO

import numpy as np

from longcalld_tpu import config
from longcalld_tpu.config import CallOpts
from longcalld_tpu.core import classify, genotype, profile
from longcalld_tpu.core.chunk import WindowChunk
from longcalld_tpu.core.pipeline import (_filter_busy_windows, _open_aln,
                                         _sample_from_header, collect_digars,
                                         load_chunk, stitch_pair)
from longcalld_tpu.core.sites import (collect_all_cand_var_sites,
                                      collect_cand_vars_fast)
from longcalld_tpu.core.windows import plan_windows
from longcalld_tpu.io.fasta import FastaFile
from longcalld_tpu.io.vcf import write_var_records, write_vcf_header
from longcalld_torch.core import phase


def call_window(opt: CallOpts, chunk: WindowChunk) -> None:
    """collect_var_main (collect_var.c:2897-2980), clean path + noisy loop."""
    from longcalld_tpu.utils import counters, log

    with counters.timed("digar"):
        collect_digars(opt, chunk)

    with counters.timed("sites"):
        sites = collect_all_cand_var_sites(opt, chunk.digars, chunk.order,
                                           chunk.reg_beg, chunk.reg_end)
        if sites:
            from longcalld_tpu.core.sites import collect_cand_vars_native
            cand = collect_cand_vars_native(opt, sites, chunk.digars,
                                            chunk.order)
            chunk.cand_vars = (cand if cand is not None else
                               collect_cand_vars_fast(opt, sites,
                                                      chunk.digars,
                                                      chunk.order))
    with counters.timed("classify"):
        classify.pre_process_noisy_regs(chunk, opt)
        if sites:
            classify.classify_cand_vars(chunk, opt)
        else:
            from longcalld_tpu.core.sites import make_cand_vars
            chunk.cand_vars = make_cand_vars([])
            chunk.var_cate = np.zeros(0, dtype=np.int32)
    counters.inc("windows")
    counters.inc("cand_vars", len(chunk.cand_vars))

    if log.VERBOSE >= 1:
        n_noisy = len(chunk.noisy_regs) if chunk.noisy_regs is not None \
            else 0
        log.debug(1, "call_window",
                  f"{chunk.tname}:{chunk.reg_beg}-{chunk.reg_end}: "
                  f"{chunk.n_reads} reads, {len(sites)} sites, "
                  f"{len(chunk.cand_vars)} cand vars, "
                  f"{n_noisy} noisy regions")
        if log.VERBOSE >= 2:
            cand = chunk.cand_vars
            for i in range(len(cand)):
                log.debug(2, "cand_var",
                          f"{chunk.tname}:{cand.pos[i]} type={cand.type[i]} "
                          f"ref_len={cand.ref_len[i]} "
                          f"alt_len={cand.alt_len[i]} "
                          f"cov={cand.total_cov[i]} "
                          f"alle={list(cand.alle_covs[i])} "
                          f"cate={int(chunk.var_cate[i]):#x}")
        if log.VERBOSE >= 3:
            for ri in chunk.order:
                d = chunk.digars[ri]
                if d is None:
                    log.debug(3, "digar",
                              f"{chunk.read_names[ri]}: skipped")
                else:
                    log.debug(3, "digar",
                              f"{chunk.read_names[ri]}: {len(d.pos)} events,"
                              f" noisy={d.noisy_regs}")

    chunk.haps = np.zeros(chunk.n_reads, dtype=np.int8)
    chunk.phase_sets = np.full(chunk.n_reads, -1, dtype=np.int64)
    chunk.n_clean_agree_snps = np.zeros(chunk.n_reads, dtype=np.int32)
    chunk.n_clean_conflict_snps = np.zeros(chunk.n_reads, dtype=np.int32)
    chunk.is_skipped_for_somatic = np.zeros(chunk.n_reads, dtype=np.uint8)

    has_noisy = chunk.noisy_regs is not None and len(chunk.noisy_regs) > 0
    if len(chunk.cand_vars) == 0 and not has_noisy:
        return
    if len(chunk.cand_vars) > 0:
        with counters.timed("profile"):
            profile.collect_read_var_profile(opt, chunk)
        with counters.timed("phase"):
            phase.assign_haplotypes(
                opt, chunk, config.CLEAN_HET_SNP | config.CLEAN_HET_INDEL
                | config.CLEAN_HOM_VAR)
    if has_noisy:
        from longcalld_torch.core.noisy import process_noisy_regions
        with counters.timed("noisy"):
            process_noisy_regions(opt, chunk)
        counters.inc("noisy_regions", len(chunk.noisy_regs))
    if opt.out_somatic:
        from longcalld_tpu.core.somatic_call import collect_somatic_var
        with counters.timed("somatic"):
            collect_somatic_var(opt, chunk)


def _window_devices(opt: CallOpts, device):
    """Devices the windows round-robin over; empty for a host-only run."""
    if not getattr(opt, "use_device", True):
        return []
    if int(getattr(opt, "mesh_devices", 0) or 0) > 1:
        raise NotImplementedError(
            "mesh_devices > 1 (reads-axis sharded phasing) is not yet "
            "ported to longcalld_torch")
    import torch

    from longcalld_torch.utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    devs = [resolve_device(torch.device("cuda", k))
            for k in range(torch.cuda.device_count())]
    nd = int(getattr(opt, "window_devices", 0) or 0)
    if nd:
        devs = devs[:nd]
    return devs if len(devs) > 1 else [dev]


def run_call(opt: CallOpts, out: TextIO = sys.stdout,
             cmdline: str = "longcalld-torch call", device=None) -> int:
    """Full `call` command, in-process.  Returns the number of emitted
    variant lines.  ``device``: torch device of the kernels (default
    cuda:0) when ``opt.use_device``."""
    import os as _os
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from longcalld_tpu.utils import counters, log

    window_devs = _window_devices(opt, device)
    n_threads = max(1, int(getattr(opt, "n_threads", 1) or 1))
    fasta = FastaFile(opt.ref_fa_fn, getattr(opt, 'ref_fai_fn', None))
    bams = [_open_aln(fn, opt.ref_fa_fn) for fn in opt.in_bam_fns]
    if opt.te_seq_fn:
        from longcalld_tpu.core.kmer import TeKmerIndex
        idx = TeKmerIndex(opt.te_seq_fn, opt.te_kmer_len)
        setattr(opt, "_te_index", idx)
        setattr(opt, "_te_names", idx.names)
    sample = opt.sample_name or _sample_from_header(bams[0]) or "SAMPLE"

    def _busy_fn(tid, begs0, ends):
        m = np.zeros(len(begs0), dtype=bool)
        for b in bams:
            m |= np.asarray(b.windows_busy(tid, begs0, ends), dtype=bool)
        return m

    chunk_filter = None
    if opt.shard:
        # each host takes every n-th region chunk; the shard VCFs partition
        # the unsharded output (merge with `longcalld-torch merge`)
        if opt.shard == "auto":
            raise NotImplementedError(
                "--shard auto is not yet ported to longcalld_torch; pass "
                "--shard i/n")
        si, sn = (int(x) for x in opt.shard.split("/"))
        if not (0 <= si < sn):
            raise ValueError(f"bad shard spec {opt.shard!r}")
        chunk_filter = lambda ci: ci % sn == si  # noqa: E731
    plan_stats: dict = {}
    wins = plan_windows(opt, bams[0].references, bams[0].lengths,
                        max_reg_len=opt.window_size, busy_fn=_busy_fn,
                        chunk_filter=chunk_filter, stats=plan_stats)
    if not opt.no_vcf_header:
        write_vcf_header(out, bams[0].references, bams[0].lengths, sample,
                         cmdline)
    if plan_stats.get("busy_errors", 0):
        try:
            n_before = len(wins)
            wins = _filter_busy_windows(bams, wins)
            plan_stats["n_dropped"] = (plan_stats.get("n_dropped", 0)
                                       + n_before - len(wins))
        except Exception as e:
            log.warning("run_call",
                        f"window-emptiness filter failed ({type(e).__name__}:"
                        f" {e}); processing all {len(wins)} windows")
    n_wins_planned = plan_stats.get("n_planned", len(wins))
    n_dropped = plan_stats.get("n_dropped", 0)
    counters.inc("wins_planned", n_wins_planned)
    counters.inc("wins_skipped_by_index", n_dropped)
    if n_dropped:
        log.info("run_call",
                 f"{n_dropped}/{n_wins_planned} windows proven read-free by "
                 f"the alignment index; processing {len(wins)}.")

    bam_writer = None
    if opt.out_bam_fn:
        if opt.out_is_cram:
            from longcalld_tpu.io.bam_writer import PhasedCramWriter
            bam_writer = PhasedCramWriter(opt.out_bam_fn, bams[0],
                                          opt.ref_fa_fn)
        elif getattr(opt, "out_is_sam", False):
            from longcalld_tpu.io.bam_writer import PhasedSamWriter
            bam_writer = PhasedSamWriter(opt.out_bam_fn, bams[0])
        else:
            from longcalld_tpu.io.bam_writer import PhasedBamWriter
            bam_writer = PhasedBamWriter(opt.out_bam_fn, bams[0],
                                         n_threads=opt.n_threads)

    def _neighbors(wi: int):
        win = wins[wi]
        nxt = wins[wi + 1] if wi + 1 < len(wins) else None
        nxt = nxt if (nxt and nxt.chunk_i == win.chunk_i) else None
        pw = wins[wi - 1] if wi > 0 else None
        pw = pw if (pw and pw.chunk_i == win.chunk_i) else None
        return pw, nxt

    tls = threading.local()

    def _handles():
        if not hasattr(tls, "fasta"):
            tls.fasta = FastaFile(opt.ref_fa_fn,
                                  getattr(opt, 'ref_fai_fn', None))
            tls.bams = [_open_aln(fn, opt.ref_fa_fn)
                        for fn in opt.in_bam_fns]
        return tls.fasta, tls.bams

    def _stage0(wi: int) -> Optional[WindowChunk]:
        fasta_l, bams_l = _handles()
        pw, nxt = _neighbors(wi)
        chunk = load_chunk(opt, fasta_l, bams_l, wins[wi], pw, nxt)
        if chunk is not None:
            if window_devs:
                chunk._device = window_devs[wi % len(window_devs)]
            call_window(opt, chunk)
        return chunk

    # kt_for + kt_pipeline analog (pipeline.py:788-856): stage-0 workers
    # load + call windows; this thread stitches and emits in window order
    n_workers = int(getattr(opt, "stage0_workers", 0) or 0)
    if n_workers <= 0:
        n_workers = max(1, min(n_threads,
                               max(1, (_os.cpu_count() or 8) // 2)))
    depth = n_workers + 2
    pool = ThreadPoolExecutor(max_workers=n_workers)
    futures = {}

    ckpt = None
    if getattr(opt, "checkpoint_dir", None):
        from longcalld_tpu.utils.checkpoint import Checkpoint
        ckpt = Checkpoint(opt.checkpoint_dir, opt)
        ckpt.pin_window_plan(wins)

    try:
        n_out = 0
        n_reads_done = 0
        prev_chunk: Optional[WindowChunk] = None
        for wi, win in enumerate(wins):
            if ckpt is not None and ckpt.done(wi):
                body, n_rec, n_reads_w, prev_chunk = ckpt.load(wi)
                out.write(body)
                if bam_writer is not None:
                    from longcalld_tpu.io.bam_writer import \
                        replay_window_reads
                    replay_window_reads(bam_writer,
                                        ckpt.load_bam_payloads(wi))
                n_out += n_rec
                n_reads_done += n_reads_w
                log.info("run_call",
                         f"Processed {n_reads_done} reads, {wi + 1}/"
                         f"{len(wins)} chunks (resumed). Output {n_out} "
                         "variants.")
                continue
            for wj in range(wi, min(wi + depth, len(wins))):
                if wj not in futures and not (ckpt is not None
                                              and ckpt.done(wj)):
                    futures[wj] = pool.submit(_stage0, wj)
            chunk = futures.pop(wi).result()
            if chunk is None:
                prev_chunk = None
                if ckpt is not None:
                    ckpt.save(wi, "", 0, 0, None,
                              bam_payloads=([] if bam_writer is not None
                                            else None))
                continue
            if prev_chunk is not None and win.reg_i > 0:
                stitch_pair(opt, prev_chunk, chunk)
            variants = genotype.make_variants(opt, chunk)
            variants.sort(key=lambda v: v.pos)
            if ckpt is None:
                n_rec = write_var_records(out, win.tname, variants, opt)
                if bam_writer is not None:
                    from longcalld_tpu.io.bam_writer import \
                        write_window_reads
                    write_window_reads(bam_writer, chunk, opt)
            else:
                import io as _io
                buf = _io.StringIO()
                n_rec = write_var_records(buf, win.tname, variants, opt)
                body = buf.getvalue()
                out.write(body)
                cap = None
                if bam_writer is not None:
                    from longcalld_tpu.io.bam_writer import \
                        write_window_reads
                    cap = []
                    write_window_reads(bam_writer, chunk, opt, capture=cap)
                ckpt.save(wi, body, n_rec, chunk.n_reads, chunk,
                          bam_payloads=cap)
            n_out += n_rec
            n_reads_done += chunk.n_reads
            log.info("run_call",
                     f"Processed {n_reads_done} reads, {wi + 1}/{len(wins)} "
                     f"chunks. Output {n_out} variants.")
            prev_chunk = chunk
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    if bam_writer is not None:
        bam_writer.close()
    if log.VERBOSE >= 1:
        for line in counters.summary_lines():
            log.debug(1, "counters", line)
    return n_out
