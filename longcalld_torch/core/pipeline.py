"""End-to-end calling pipeline of the port: longcalld_tpu/core/pipeline.py's
call_window (:153-237), _range_worker (:379-408), _worker_env_fn
(:469-488), _run_call_procs (:571-669) and run_call (:672-944).  Window
loading, digars, sites, classify, profile, genotype, stitch, the
cross-range flip and VCF output are the JAX package's host code, imported
unchanged; phasing and the noisy-region stage go through the port
(longcalld_torch.core.phase / .noisy), whose device work runs on torch
devices.

run_call takes the same path as the JAX run_call for the same options:
many-window streams go to the window-range process pool
(core/procpool.py), host-only workers unless ``procs_use_device``.
Differences from the JAX run_call:
* no executable prewarm (PyTorch has nothing to compile per shape);
* ``device`` is explicit (default cuda:0, raising when CUDA is absent);
  in-process, windows round-robin over ``torch.cuda.device_count()``
  cards, capped by ``window_devices``; device workers own a card each
  through ``CUDA_VISIBLE_DEVICES`` (see _worker_env_fn);
* ``mesh_devices > 1`` (reads-axis sharded phasing, parallel/mesh.py):
  as in JAX, no window round-robin; the aligner runs on ``device`` and
  each window's EM over ``make_mesh(mesh_devices, device)`` or the
  explicit ``mesh`` list.  Device workers own one card, so
  ``procs_use_device`` with a CUDA mesh raises in the parent (the JAX
  worker quietly shards over the one chip it sees);
* ``--shard auto`` reads the process group's ``RANK``/``WORLD_SIZE``
  (as torchrun sets them; 0/1 when unset) in place of
  ``jax.process_index()``/``process_count()``;
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
from longcalld_tpu.core.pipeline import (_apply_cross_flip, _boundary_state,
                                         _cross_flip_decision,
                                         _filter_busy_windows, _open_aln,
                                         _plan_ranges, _sample_from_header,
                                         _worker_handles, collect_digars,
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


def _mesh_devices(opt: CallOpts) -> int:
    return int(getattr(opt, "mesh_devices", 0) or 0)


def _window_devices(opt: CallOpts, device):
    """Devices the windows round-robin over; empty for a host-only run.
    With a mesh (``mesh_devices > 1``) every window runs on ``device``."""
    if not getattr(opt, "use_device", True):
        return []
    import torch

    from longcalld_torch.utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda" or _mesh_devices(opt) > 1:
        return [dev]
    devs = [resolve_device(torch.device("cuda", k))
            for k in range(torch.cuda.device_count())]
    nd = int(getattr(opt, "window_devices", 0) or 0)
    if nd:
        devs = devs[:nd]
    return devs if len(devs) > 1 else [dev]


# ---------------- process-parallel window ranges (kt_for analog) ----------
#
# The JAX package's design (longcalld_tpu/core/pipeline.py:320-337):
# window RANGES run in share-nothing worker processes that genotype without
# stitching and return per-window records plus boundary-read states; the
# parent runs every stitch vote serially (_cross_flip_decision /
# _apply_cross_flip, imported unchanged).


def _worker_totals() -> dict:
    """This process's aligner counters plus the kernel launch counts and
    the phasing EM's CUDA and sharded calls: a range's delta of these
    proves, in the parent, that the kernels ran inside the worker."""
    from longcalld_torch.ops import band, phase_kernel
    from longcalld_torch.ops.wfa import aligner_totals
    tot = aligner_totals()
    for name, n in band.launch_counts().items():
        tot[f"{name}_launches"] = n
    tot["phase_cuda_calls"] = phase_kernel.cuda_calls()
    tot["phase_sharded_calls"] = phase_kernel.sharded_calls()
    return tot


def _range_worker(payload):
    """Process one contiguous window range in a pool worker.  ``device``
    is the torch device of a device worker (``opt.use_device``), resolved
    before any window so that a worker whose card is missing raises
    instead of running host-only.  Returns (per-window results, counter
    delta); each per-window entry is either None (no reads) or (sorted
    variant records, n_reads, boundary state)."""
    opt, wslice, first_k, count, device = payload
    dev = None
    if getattr(opt, "use_device", True):
        from longcalld_torch.utils.device import resolve_device
        dev = resolve_device(device)
    fasta, bams, te_idx = _worker_handles(opt)
    if te_idx is not None:
        setattr(opt, "_te_index", te_idx)
        setattr(opt, "_te_names", te_idx.names)
    before = _worker_totals()
    results = []
    for k in range(first_k, first_k + count):
        win = wslice[k]
        pw = wslice[k - 1] if k > 0 else None
        pw = pw if (pw and pw.chunk_i == win.chunk_i) else None
        nxt = wslice[k + 1] if k + 1 < len(wslice) else None
        nxt = nxt if (nxt and nxt.chunk_i == win.chunk_i) else None
        chunk = load_chunk(opt, fasta, bams, win, pw, nxt)
        if chunk is None:
            results.append(None)
            continue
        if dev is not None:
            chunk._device = dev
        call_window(opt, chunk)
        variants = genotype.make_variants(opt, chunk)
        variants.sort(key=lambda v: v.pos)
        results.append((variants, chunk.n_reads, _boundary_state(chunk)))
    after = _worker_totals()
    return results, {k: after[k] - before[k] for k in after}


# CallOpts.worker_device_env's default, written for TPU hosts
TPU_WORKER_ENV = "TPU_VISIBLE_DEVICES={k}"


def _worker_env_fn(opt, device):
    """Per-worker env overrides of device workers, from the CallOpts
    template ``worker_device_env`` (;-separated NAME=VALUE entries with
    {k} = worker index, {n} = pool size).  A template other than the
    default is applied verbatim.  The default, ``TPU_VISIBLE_DEVICES={k}``
    (worker k owns chip k on a TPU host), becomes
    ``CUDA_VISIBLE_DEVICES=cards[k mod len(cards)]`` for a CUDA
    ``device``.  ``cards`` are the cards this process may use: the
    entries of its own ``CUDA_VISIBLE_DEVICES`` when that is set (so a
    worker never leaves the parent's mask), else 0..device_count()-1;
    capped by ``window_devices``.  On one card every worker owns that
    card.  For a CPU ``device`` it becomes ``CUDA_VISIBLE_DEVICES=`` (no
    worker opens a CUDA context)."""
    import os

    import torch

    from longcalld_tpu.core.pipeline import _worker_env_fn as template_env

    if str(getattr(opt, "worker_device_env", "") or "") != TPU_WORKER_ENV:
        return template_env(opt)
    if torch.device(device).type == "cpu":
        return lambda k, n: {"CUDA_VISIBLE_DEVICES": ""}
    count = torch.cuda.device_count()
    mask = os.environ.get("CUDA_VISIBLE_DEVICES")
    if mask is not None:
        cards = [s.strip() for s in mask.split(",") if s.strip()][:count]
    else:
        cards = [str(i) for i in range(count)]
    nd = int(getattr(opt, "window_devices", 0) or 0)
    if nd:
        cards = cards[:nd]
    if not cards:
        raise RuntimeError("device workers requested but no CUDA card is "
                           "visible")
    return lambda k, n: {"CUDA_VISIBLE_DEVICES": cards[k % len(cards)]}


def _run_call_procs(opt: CallOpts, out: TextIO, wins, n_workers: int,
                    bams=None, device=None) -> int:
    """kt_for over windows as share-nothing worker processes; the parent
    is the serial stage-1/2 consumer: it runs every stitch vote in window
    order and emits records (the JAX _run_call_procs, :571-669).

    Workers are host-only by default.  With ``procs_use_device`` each
    worker keeps ``use_device`` and runs the band kernels and the phasing
    EM on its own card (worker_device_env), so N processes scale the host
    stages past the GIL AND drive the device.  Before the first device
    worker starts, the parent resolves ``device`` (raising without CUDA)
    and builds the kernels once, so the workers only load the library."""
    import dataclasses

    from longcalld_torch.core import procpool
    from longcalld_tpu.utils import counters, log

    dev_workers = bool(getattr(opt, "procs_use_device", False))
    opt_w = dataclasses.replace(opt, use_device=dev_workers,
                                checkpoint_dir=None)
    env_fn = None
    worker_dev = None
    if dev_workers:
        from longcalld_torch.utils.device import resolve_device
        dev = resolve_device(device)
        if dev.type == "cuda" and _mesh_devices(opt) > 1:
            raise ValueError(
                f"mesh_devices={opt.mesh_devices} with procs_use_device on "
                "CUDA: a device worker owns one card, so it has no mesh to "
                "shard over; run in-process (host_procs=0) or set "
                "mesh_devices=0")
        if dev.type == "cuda":
            from longcalld_torch.utils import kbuild
            kbuild.load()
        env_fn = _worker_env_fn(opt, dev)
        # a device worker runs on the first card it sees
        worker_dev = "cuda:0" if dev.type == "cuda" else str(dev)
    n_out = 0
    n_reads_done = 0
    prev_state = None
    wi = 0

    # checkpoint / resume (same per-window npz schema as the in-process
    # path, so either mode resumes the other's directory): replay the done
    # prefix, then plan ranges over the pending suffix only
    ckpt = None
    first_pending = 0
    if getattr(opt, "checkpoint_dir", None):
        from longcalld_tpu.utils.checkpoint import Checkpoint
        ckpt = Checkpoint(opt.checkpoint_dir, opt)
        ckpt.pin_window_plan(wins)
        first_pending = min(ckpt.resume_prefix(), len(wins))
        for wi in range(first_pending):
            body, n_rec, n_reads_w, prev_state = ckpt.load_procs_state(wi)
            out.write(body)
            n_out += n_rec
            n_reads_done += n_reads_w
            if n_rec or n_reads_w:
                log.info("run_call",
                         f"Processed {n_reads_done} reads, {wi + 1}/"
                         f"{len(wins)} chunks (resumed). Output {n_out} "
                         "variants.")
        wi = first_pending
        if first_pending >= len(wins):
            return n_out

    ranges, order = _plan_ranges(wins[first_pending:], n_workers, bams)
    ranges = [(first_pending + f, c) for f, c in ranges]
    range_worker: dict = {}
    for ridx, (results, cdelta) in enumerate(procpool.imap_ranges(
            opt_w, wins, ranges, n_workers, worker_env_fn=env_fn,
            range_worker_out=range_worker, order=order,
            device=worker_dev)):
        for k, v in cdelta.items():
            if v:
                counters.inc(f"aln_{k}", v)
                if dev_workers:
                    # per-worker attribution: which worker ran this
                    # range's alignment work and kernel launches
                    counters.inc(f"aln_{k}_w{range_worker.get(ridx, -1)}", v)
        for entry in results:
            win = wins[wi]
            if entry is None:
                prev_state = None
                if ckpt is not None:
                    ckpt.save_procs_state(wi, "", 0, 0, None)
                wi += 1
                continue
            variants, n_reads_w, state = entry
            if prev_state is not None and win.reg_i > 0:
                decision = _cross_flip_decision(prev_state, state)
                if decision is not None:
                    _apply_cross_flip(variants, state, decision)
            if ckpt is None:
                n_rec = write_var_records(out, win.tname, variants, opt)
            else:
                import io as _io
                buf = _io.StringIO()
                n_rec = write_var_records(buf, win.tname, variants, opt)
                body = buf.getvalue()
                out.write(body)
                # saved POST-flip, so a resume's first vote sees the same
                # boundary haps/PS the uninterrupted run would
                ckpt.save_procs_state(wi, body, n_rec, n_reads_w, state)
            n_out += n_rec
            n_reads_done += n_reads_w
            log.info("run_call",
                     f"Processed {n_reads_done} reads, {wi + 1}/"
                     f"{len(wins)} chunks. Output {n_out} variants.")
            prev_state = state
            wi += 1
    return n_out


def _shard_spec(shard: str):
    """(index, count) of ``--shard``: ``i/n``, or ``auto`` for the process
    group's RANK/WORLD_SIZE as torchrun sets them (0/1 when unset, which
    is what jax.process_index()/process_count() give in one process)."""
    import os as _os
    if shard == "auto":
        return (int(_os.environ.get("RANK", "0")),
                int(_os.environ.get("WORLD_SIZE", "1")))
    si, sn = (int(x) for x in shard.split("/"))
    return si, sn


def run_call(opt: CallOpts, out: TextIO = sys.stdout,
             cmdline: str = "longcalld-torch call", device=None,
             mesh=None) -> int:
    """Full `call` command.  Returns the number of emitted variant lines.
    ``device``: torch device of the kernels (default cuda:0) when
    ``opt.use_device`` in-process, or of the workers with
    ``procs_use_device``.  ``mesh``: an explicit device list (it may
    repeat a card) for the in-process phasing mesh, only with
    ``opt.mesh_devices > 1`` and of that length; default
    ``make_mesh(opt.mesh_devices, device)``."""
    import os as _os
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from longcalld_tpu.utils import counters, log

    # process-parallel eligibility, exactly the JAX run_call's
    # (pipeline.py:679-691): host_procs -1 = auto (follow -t), 0 = off,
    # N = exactly N workers; phased-alignment output pins in-process
    n_threads = max(1, int(getattr(opt, "n_threads", 1) or 1))
    hp = int(getattr(opt, "host_procs", -1))
    hp_explicit = hp > 0
    if hp < 0:
        hp = n_threads if n_threads > 1 else 0
    hp = min(hp, _os.cpu_count() or max(hp, 1))
    procs_eligible = hp > 1 and opt.out_bam_fn is None
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
        si, sn = _shard_spec(opt.shard)
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

    # hand many-window streams to the process pool (pipeline.py:769-773);
    # few-window runs stay on the in-process thread path
    use_procs = procs_eligible and len(wins) >= (2 if hp_explicit else 4) * hp
    if use_procs:
        return _run_call_procs(opt, out, wins, hp, bams, device)
    window_devs = _window_devices(opt, device)
    if mesh is not None and _mesh_devices(opt) <= 1:
        raise ValueError("run_call: a mesh is given but opt.mesh_devices "
                         f"is {opt.mesh_devices}")
    if window_devs and _mesh_devices(opt) > 1:
        from longcalld_torch.parallel.mesh import make_mesh
        mesh = make_mesh(opt.mesh_devices, window_devs[0], devices=mesh)

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
                chunk._mesh = mesh
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
