"""End-to-end calling pipeline: window loading -> digars -> candidates ->
classification -> phasing -> (noisy-region re-assembly) -> genotypes -> VCF.

The port's whole pipeline module.  Window loading, digars, stitch, the
cross-range flip and range planning are longcalld_tpu/core/pipeline.py's
host code, copied unchanged; call_window reaches the port's phasing and
noisy-region stages (longcalld_torch.core.phase / .noisy), whose device
work runs on torch devices.

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
from typing import List, Optional, Sequence, TextIO

import numpy as np

from longcalld_torch import config
from longcalld_torch.config import CallOpts
from longcalld_torch.core import classify, genotype, phase, profile
from longcalld_torch.core.chunk import WindowChunk
from longcalld_torch.core.digar import (collect_digar_eqx,
                                        collect_digar_from_cs,
                                        collect_digar_from_md,
                                        collect_digar_from_ref)
from longcalld_torch.core.sites import (collect_all_cand_var_sites,
                                        collect_cand_vars_fast)
from longcalld_torch.core.windows import Window, plan_windows
from longcalld_torch.io.bam import (FSECONDARY, FSUPPLEMENTARY, FUNMAP,
                                    BamReader, BamRecord)
from longcalld_torch.io.fasta import FastaFile
from longcalld_torch.io.vcf import write_var_records, write_vcf_header
from longcalld_torch.utils.intervals import IntervalSet
from longcalld_torch.utils.sdust import sdust_native

REF_FLANK = 50000


def load_chunk(opt: CallOpts, fasta: FastaFile, bams: Sequence[BamReader],
               win: Window, prev_win: Optional[Window],
               next_win: Optional[Window]) -> Optional[WindowChunk]:
    """collect_ref_seq_bam_main (reference/src/bam_utils.c:1659-1716)."""
    reads: List[BamRecord] = []
    up_ovlp: List[int] = []
    down_ovlp: List[int] = []

    def ovl(rec: BamRecord, w: Optional[Window]) -> bool:
        if w is None or w.tid != win.tid:
            return False
        return not (rec.endpos < w.beg or rec.pos + 1 > w.end)

    for bam in bams:
        for rec in bam.fetch(win.tid, win.beg - 1, win.end):
            if (rec.flag & (FUNMAP | FSECONDARY | FSUPPLEMENTARY)
                    or rec.mapq < opt.min_mq):
                continue
            if ovl(rec, prev_win):
                up_ovlp.append(len(reads))
            if ovl(rec, next_win):
                down_ovlp.append(len(reads))
            reads.append(rec)
    if not reads:
        return None

    min_read_beg = min(win.beg, min(r.pos + 1 for r in reads))
    max_read_end = max(win.end, max(r.endpos for r in reads))
    tname = win.tname
    ref_seq_len = fasta.seq_len(tname)
    ref_beg0 = max(REF_FLANK, min_read_beg - 1) - REF_FLANK   # 0-based
    ref_end0 = min(ref_seq_len - REF_FLANK - 1, max_read_end - 1) + REF_FLANK
    ref4 = fasta.fetch_nt4(tname, ref_beg0, ref_end0)

    chunk = WindowChunk(
        tid=win.tid, tname=tname, reg_beg=win.beg, reg_end=win.end,
        ref_beg=ref_beg0 + 1, ref_end=ref_beg0 + len(ref4),
        whole_ref_len=ref_seq_len, ref4=ref4,
        chunk_i=win.chunk_i, reg_i=win.reg_i)
    chunk.n_reads = len(reads)
    chunk.reads = reads  # kept for digar extraction only
    chunk.read_names = [r.qname for r in reads]
    chunk.up_ovlp_read_i = up_ovlp
    chunk.down_ovlp_read_i = down_ovlp
    chunk.is_skipped = np.zeros(len(reads), dtype=np.uint8)
    chunk.is_palindrome = np.zeros(len(reads), dtype=np.uint8)

    # low-complexity mask over the active region (sdust T=5 W=20)
    reg4 = chunk.ref4_slice(win.beg, win.end - win.beg + 1)
    ivs = sdust_native(reg4, config.SDUST_T, config.SDUST_W)
    chunk.low_comp = IntervalSet.from_arrays(ivs[:, 0] + (win.beg - 1),
                                             ivs[:, 1] + (win.beg - 1))

    # sort order: pos asc, end DESC, NM asc, qname (sort_chunk_reads,
    # src/bam_utils.c:1623-1656)
    keys = sorted(range(len(reads)),
                  key=lambda i: (reads[i].pos, -reads[i].endpos,
                                 reads[i].get_nm(), reads[i].qname))
    chunk.order = keys
    return chunk


def collect_digars(opt: CallOpts, chunk: WindowChunk) -> None:
    """collect_digars_from_bam (collect_var.c:1063-1110)."""
    n = chunk.n_reads
    chunk.digars = [None] * n
    noisy = IntervalSet()
    qual_arrays = []
    for ri in chunk.order:
        rec = chunk.reads[ri]
        qual_arrays.append(rec.qual())
        if rec.has_eqx_cigar():
            digar, regions, pal = collect_digar_eqx(
                rec, opt, chunk.reg_beg, chunk.reg_end, chunk.whole_ref_len)
        elif rec.has_tag("cs"):
            digar, regions, pal = collect_digar_from_cs(
                rec, opt, chunk.reg_beg, chunk.reg_end, chunk.whole_ref_len)
        elif rec.has_tag("MD"):
            digar, regions, pal = collect_digar_from_md(
                rec, opt, chunk.reg_beg, chunk.reg_end, chunk.whole_ref_len)
        else:
            digar, regions, pal = collect_digar_from_ref(
                rec, opt, chunk.reg_beg, chunk.reg_end, chunk.whole_ref_len,
                chunk.ref4, chunk.ref_beg)
        chunk.is_palindrome[ri] = 1 if pal else 0
        if digar is None:
            chunk.is_skipped[ri] = 2  # BAM_RECORD_WRONG_MAP
        else:
            chunk.digars[ri] = digar
            for s, e, lab in regions:
                noisy.add(s, e, lab)
    chunk.noisy_regs = noisy.index()

    # one C histogram over the window's concatenated quals (per-read
    # numpy bincounts showed up at ~8% of the warm profile)
    from longcalld_torch.core.sites import u8_hist
    qual_counts = u8_hist(
        np.concatenate(qual_arrays) if qual_arrays
        else np.zeros(0, dtype=np.uint8))
    total = int(qual_counts.sum())
    valid = [q for q in range(256)
             if qual_counts[q] > 0 and qual_counts[q] >= 0.0001 * total]
    if not valid:
        chunk.min_qual = chunk.first_quar_qual = 0
        chunk.median_qual = chunk.third_quar_qual = chunk.max_qual = 0
    else:
        nv = len(valid)
        chunk.min_qual = valid[0]
        chunk.first_quar_qual = valid[nv // 4]
        chunk.median_qual = valid[nv // 2]
        chunk.third_quar_qual = valid[nv * 3 // 4]
        chunk.max_qual = valid[nv - 1]


def call_window(opt: CallOpts, chunk: WindowChunk) -> None:
    """collect_var_main (collect_var.c:2897-2980), clean path + noisy loop."""
    from longcalld_torch.utils import counters, log

    with counters.timed("digar"):
        collect_digars(opt, chunk)

    with counters.timed("sites"):
        sites = collect_all_cand_var_sites(opt, chunk.digars, chunk.order,
                                           chunk.reg_beg, chunk.reg_end)
        if sites:
            from longcalld_torch.core.sites import collect_cand_vars_native
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
            from longcalld_torch.core.sites import make_cand_vars
            chunk.cand_vars = make_cand_vars([])
            chunk.var_cate = np.zeros(0, dtype=np.int32)
    counters.inc("windows")
    counters.inc("cand_vars", len(chunk.cand_vars))

    # -V debug dumps (the LONGCALLD_VERBOSE analog, collect_var.c:250-266,
    # 1374-1385): 1 = per-window summary, 2 = candidate sites, 3 = digars
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
        from longcalld_torch.core.somatic_call import collect_somatic_var
        with counters.timed("somatic"):
            collect_somatic_var(opt, chunk)


def stitch_pair(opt: CallOpts, prev: WindowChunk, cur: WindowChunk) -> None:
    """flip_variant_hap (collect_var.c:1640-1695): majority vote of shared
    boundary reads decides hap flip; phase sets renamed to extend blocks."""
    if prev is None or cur is None or prev.tid != cur.tid:
        return
    n_cur = len(cur.up_ovlp_read_i)
    n_pre = len(prev.down_ovlp_read_i)
    if n_cur != n_pre or n_cur <= 0:
        return
    if len(prev.cand_vars or []) <= 0 or len(cur.cand_vars or []) <= 0:
        return
    flip_score = 0
    max_pre_ps = -1
    min_cur_ps = np.iinfo(np.int64).max
    for j in range(n_cur):
        cur_i = cur.up_ovlp_read_i[j]
        pre_i = prev.down_ovlp_read_i[j]
        if (prev.is_skipped[pre_i] or prev.haps[pre_i] == 0
                or cur.is_skipped[cur_i] or cur.haps[cur_i] == 0):
            continue
        if prev.haps[pre_i] == cur.haps[cur_i]:
            flip_score -= 1
        else:
            flip_score += 1
        max_pre_ps = max(max_pre_ps, int(prev.phase_sets[pre_i]))
        min_cur_ps = min(min_cur_ps, int(cur.phase_sets[cur_i]))
    if flip_score == 0:
        return
    cur.flip_pre_ps = max_pre_ps
    cur.flip_cur_ps = min_cur_ps
    cur.flip_hap = flip_score > 0
    cand = cur.cand_vars
    if cur.flip_hap and cur.flip_cur_ps != -1 and cand.phase_set is not None:
        m = cand.phase_set == cur.flip_cur_ps
        h1 = cand.hap_cons_alle[m, 1].copy()
        cand.hap_cons_alle[m, 1] = cand.hap_cons_alle[m, 2]
        cand.hap_cons_alle[m, 2] = h1
    if (cur.flip_pre_ps != -1 and cur.flip_cur_ps != np.iinfo(np.int64).max
            and cand.phase_set is not None):
        cand.phase_set[cand.phase_set == cur.flip_cur_ps] = cur.flip_pre_ps
    # read-level flip (needed for phased-BAM output)
    if cur.flip_hap and cur.flip_cur_ps != -1:
        m = (cur.haps != 0) & (cur.phase_sets == cur.flip_cur_ps)
        cur.haps[m] = 3 - cur.haps[m]
    if cur.flip_pre_ps != -1 and cur.flip_cur_ps != np.iinfo(np.int64).max:
        m = cur.phase_sets == cur.flip_cur_ps
        cur.phase_sets[m] = cur.flip_pre_ps


def _filter_busy_windows(bams, wins):
    """Drop windows every input's index proves read-free — vectorized per
    contig (one numpy pass over all windows) instead of a per-window
    ``query_chunks``, whose O(tiles) scan dominated whole-genome window
    streams."""
    import numpy as np
    if not wins:
        return wins
    by_tid: dict = {}
    for k, w in enumerate(wins):
        by_tid.setdefault(w.tid, []).append(k)
    keep = np.zeros(len(wins), dtype=bool)
    for tid, idxs in by_tid.items():
        begs = np.array([wins[k].beg - 1 for k in idxs], dtype=np.int64)
        ends = np.array([wins[k].end for k in idxs], dtype=np.int64)
        busy = np.zeros(len(idxs), dtype=bool)
        for b in bams:
            busy |= np.asarray(b.windows_busy(tid, begs, ends), dtype=bool)
        keep[idxs] = busy
    return [w for k, w in enumerate(wins) if keep[k]]


def _open_aln(fn: str, ref_fa_fn: str):
    """BAM or CRAM by magic bytes (the reference accepts either,
    call_var_main.c:661-712; CRAM decode needs the FASTA)."""
    from longcalld_torch.io.cram import CramReader, is_cram
    if is_cram(fn):
        return CramReader(fn, ref_fa_fn)
    return BamReader(fn)


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
# CPython's GIL serializes the interpreted window stages across threads, so
# the thread pool in run_call only overlaps the GIL-releasing parts (the C
# aligner, zlib, device dispatch).  For host-stage scaling, window RANGES
# run in forkserver worker processes — the share-nothing form of the
# reference's kt_for over windows (reference/src/kthread.c:24-65).
#
# Workers do NO stitching: they return per-window genotyped records plus
# the window's boundary-read states, and the main process performs every
# stitch vote serially (flip_variant_hap,
# reference/src/collect_var.c:1640-1695).  This is exactly
# equivalent to stitch-before-genotype because a flip's only effects are
# (a) swapping hap_cons_alle columns 1/2 — which genotype.make_variants
# turns into the GT tuple order — and (b) renaming the block's PS id;
# both commute past genotyping as a GT-tuple swap + PS rename on the
# emitted records.  Equality with the sequential path is asserted in
# tests/test_procs.py on real data and under fuzz.

def _boundary_side(chunk, idx_list):
    idx = np.asarray(idx_list, dtype=np.int64)
    if len(idx) == 0:
        return (np.zeros(0, np.uint8), np.zeros(0, np.int8),
                np.zeros(0, np.int64))
    return (chunk.is_skipped[idx].copy(), chunk.haps[idx].copy(),
            chunk.phase_sets[idx].copy())


def _boundary_state(chunk):
    """What the main process's serial stitch needs from a chunk."""
    return {
        "tid": chunk.tid,
        "has_cands": chunk.cand_vars is not None and len(chunk.cand_vars) > 0,
        "up": _boundary_side(chunk, chunk.up_ovlp_read_i),
        "down": _boundary_side(chunk, chunk.down_ovlp_read_i),
    }


_WORKER_HANDLES: dict = {}


def _worker_handles(opt):
    """Per-process FASTA/BAM handle set (the call_var_io_aux_t analog,
    reference/src/call_var_main.h:187-191), cached across range
    tasks so each worker opens its inputs once."""
    key = (opt.ref_fa_fn, tuple(opt.in_bam_fns), opt.te_seq_fn)
    st = _WORKER_HANDLES.get(key)
    if st is None:
        fasta = FastaFile(opt.ref_fa_fn, getattr(opt, "ref_fai_fn", None))
        bams = [_open_aln(fn, opt.ref_fa_fn) for fn in opt.in_bam_fns]
        te_idx = None
        if opt.te_seq_fn:
            from longcalld_torch.core.kmer import TeKmerIndex
            te_idx = TeKmerIndex(opt.te_seq_fn, opt.te_kmer_len)
        st = (fasta, bams, te_idx)
        _WORKER_HANDLES[key] = st
    return st


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


_PS_MAX = np.iinfo(np.int64).max


def _cross_flip_decision(pre_state, cur_state):
    """flip_variant_hap's vote over the reads shared across a window
    boundary (collect_var.c:1640-1695); returns (flip_hap, flip_pre_ps,
    flip_cur_ps) or None when no flip/rename applies."""
    if pre_state is None or cur_state is None:
        return None
    if pre_state["tid"] != cur_state["tid"]:
        return None
    if not (pre_state["has_cands"] and cur_state["has_cands"]):
        return None
    p_skip, p_hap, p_ps = pre_state["down"]
    c_skip, c_hap, c_ps = cur_state["up"]
    n = len(c_skip)
    if n != len(p_skip) or n <= 0:
        return None
    flip_score = 0
    max_pre_ps = -1
    min_cur_ps = _PS_MAX
    for j in range(n):
        if p_skip[j] or p_hap[j] == 0 or c_skip[j] or c_hap[j] == 0:
            continue
        flip_score += 1 if p_hap[j] != c_hap[j] else -1
        max_pre_ps = max(max_pre_ps, int(p_ps[j]))
        min_cur_ps = min(min_cur_ps, int(c_ps[j]))
    if flip_score == 0:
        return None
    return flip_score > 0, max_pre_ps, min_cur_ps


def _apply_cross_flip(variants, state, decision):
    """Apply one boundary's flip/rename to a window's already-genotyped
    records (GT tuple swap + PS rename — the full effect flip_variant_hap's
    cand edits have on the final records) and to the window's boundary-read
    copies on BOTH sides, so the next boundary's vote sees post-flip haps
    exactly as the sequential path does."""
    flip_hap, pre_ps, cur_ps = decision
    do_flip = flip_hap and cur_ps != -1
    do_ren = pre_ps != -1 and cur_ps != _PS_MAX
    if not (do_flip or do_ren):
        return
    for v in variants:
        if v.ps == cur_ps:
            if do_flip:
                v.gt = (v.gt[1], v.gt[0])
            if do_ren:
                v.ps = pre_ps
    for side in ("up", "down"):
        _skip, hap, ps = state[side]
        if do_flip:
            m = (hap != 0) & (ps == cur_ps)
            hap[m] = 3 - hap[m]
        if do_ren:
            ps[ps == cur_ps] = pre_ps


# CallOpts.worker_device_env's default, written for TPU hosts
TPU_WORKER_ENV = "TPU_VISIBLE_DEVICES={k}"


def _template_env_fn(opt):
    """Build the per-worker env-override function from the CallOpts
    template (``worker_device_env``: ;-separated NAME=VALUE entries with
    {k} = worker index, {n} = pool size).  On a multi-chip v5e host the
    default ``TPU_VISIBLE_DEVICES={k}`` gives worker k exclusive ownership
    of chip k — the per-thread handle-set analog
    (reference/src/call_var_main.c:637-750) extended to devices."""
    tmpl = str(getattr(opt, "worker_device_env", "") or "")

    def fn(k: int, n: int) -> dict:
        env = {}
        for part in tmpl.split(";"):
            part = part.strip()
            if not part:
                continue
            name, _, val = part.partition("=")
            env[name.strip()] = val.format(k=k, n=n)
        return env

    return fn


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

    if str(getattr(opt, "worker_device_env", "") or "") != TPU_WORKER_ENV:
        return _template_env_fn(opt)
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


def _window_costs(bams, wins):
    """Per-window compressed-byte volumes from every input's index
    (BaiIndex.window_volumes), vectorized per contig — the
    range-balancing cost proxy.  None when any input has no usable
    index, which makes the caller fall back to count-balanced ranges."""
    est = np.zeros(len(wins), dtype=np.float64)
    by_tid: dict = {}
    for k, w in enumerate(wins):
        by_tid.setdefault(w.tid, []).append(k)
    for b in bams:
        idx = getattr(b, "index", None)
        if idx is None or not hasattr(idx, "window_volumes"):
            return None
        for tid, idxs in by_tid.items():
            begs = np.array([wins[k].beg - 1 for k in idxs],
                            dtype=np.int64)
            ends = np.array([wins[k].end for k in idxs], dtype=np.int64)
            est[idxs] += idx.window_volumes(tid, begs, ends)
    return est + 1.0


def _plan_ranges(wins, n_workers: int, bams=None):
    """Split the window stream into contiguous ranges for the pool and pick
    their execution order.  With an alignment index available, ranges are
    COST-balanced (each closes once it holds ~1/(4*workers) of the indexed
    byte volume, so a single hot window becomes its own range) and the
    heaviest ranges are scheduled first (LPT) — the work-stealing analog of
    kt_for's strided stealing (reference/src/kthread.c:24-46), which
    a fixed count-balanced split defeats when read depth is skewed.
    Returns (ranges, order-or-None)."""
    est = None
    if bams and len(wins) > n_workers:
        try:
            est = _window_costs(bams, wins)
        except Exception:
            est = None
    if est is None:
        n_ranges = max(1, min(len(wins), n_workers * 4))
        bounds = np.linspace(0, len(wins), n_ranges + 1).astype(np.int64)
        return [(int(b), int(e - b))
                for b, e in zip(bounds[:-1], bounds[1:]) if e > b], None
    target = float(est.sum()) / max(1, n_workers * 4)
    ranges, costs = [], []
    s, acc = 0, 0.0
    for k in range(len(wins)):
        if k > s and acc + est[k] > target:
            # close before overshoot, so a hot window never drags the
            # light windows queued in front of it into its range
            ranges.append((s, k - s))
            costs.append(acc)
            s, acc = k, 0.0
        acc += est[k]
        if acc >= target:
            ranges.append((s, k + 1 - s))
            costs.append(acc)
            s, acc = k + 1, 0.0
    if s < len(wins):
        ranges.append((s, len(wins) - s))
        costs.append(acc)
    return ranges, _block_lpt_order(costs, n_workers)


def _block_lpt_order(costs, n_workers: int):
    """Heaviest-first execution order applied WITHIN sliding blocks of the
    range stream rather than globally: global LPT can schedule the light
    early ranges last, so nearly every completed range's payload buffers in
    the parent (strict in-order yield) before the consumer drains any —
    measured at +1.2 GB main-process peak RSS on the 20 Mb synth run.
    Block-local LPT keeps the balancing where it matters (within the set of
    ranges concurrently in flight) while bounding out-of-order buffering to
    one block (2*workers ranges)."""
    block = max(2 * n_workers, 4)
    order: List[int] = []
    for b0 in range(0, len(costs), block):
        blk = list(range(b0, min(b0 + block, len(costs))))
        blk.sort(key=lambda i: -costs[i])
        order.extend(blk)
    return order


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
    from longcalld_torch.utils import counters, log

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
        from longcalld_torch.utils.checkpoint import Checkpoint
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

    from longcalld_torch.utils import counters, log

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
        from longcalld_torch.core.kmer import TeKmerIndex
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
            from longcalld_torch.io.bam_writer import PhasedCramWriter
            bam_writer = PhasedCramWriter(opt.out_bam_fn, bams[0],
                                          opt.ref_fa_fn)
        elif getattr(opt, "out_is_sam", False):
            from longcalld_torch.io.bam_writer import PhasedSamWriter
            bam_writer = PhasedSamWriter(opt.out_bam_fn, bams[0])
        else:
            from longcalld_torch.io.bam_writer import PhasedBamWriter
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
        from longcalld_torch.utils.checkpoint import Checkpoint
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
                    from longcalld_torch.io.bam_writer import \
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
                    from longcalld_torch.io.bam_writer import \
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
                    from longcalld_torch.io.bam_writer import \
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


def _sample_from_header(bam: BamReader) -> Optional[str]:
    for line in bam.header_text.splitlines():
        if line.startswith("@RG"):
            for field in line.split("\t"):
                if field.startswith("SM:"):
                    return field[3:]
    return None

