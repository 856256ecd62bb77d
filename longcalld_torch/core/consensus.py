"""Noisy-region engine of the port: longcalld_tpu/core/consensus.py's
_drive_lockstep (:275-302) and collect_noisy_vars1 (:1227-1385), copied
verbatim apart from one import.  The JAX package's _drive_lockstep imports
fuse_requests from longcalld_tpu.core.noisy, whose module imports the JAX
aligner; this copy imports it from longcalld_torch.core.noisy.  Every
helper comes from longcalld_tpu.core.consensus unchanged, so a diff of
these two functions against the originals shows only that line.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from longcalld_tpu import config
from longcalld_tpu.config import CallOpts
from longcalld_tpu.core import msa as msa_mod
from longcalld_tpu.core.alnstr import (AlnStr, cons_read_aln_from_msa,
                                       ref_read_aln_from_pair)
from longcalld_tpu.core.chunk import WindowChunk
from longcalld_tpu.core.consensus import (
    NoisyProfile, _merge_two_hap_vars, _mine_read_somatic_vars,
    _ref_is_homopolymer, _update_profile_one_cons_batch,
    _update_profile_two_cons_batch, collect_noisy_read_info,
    make_cand_vars_from_aln, phase_set_with_both_haps, sort_noisy_reads)
from longcalld_tpu.core.msa import GAP, MsaResult, is_both_cover, star_msa


def _drive_lockstep(gens):
    """Advance several alignment-requesting coroutines in lockstep, fusing
    each round's requests into ONE outer yield with per-pair left_align
    flags — the same round-fusion core.noisy applies across regions,
    nested one level down (across the two per-hap star MSAs of one
    region).  Returns the coroutines' return values in order."""
    n = len(gens)
    results = [None] * n
    to_send = [None] * n
    live = dict(enumerate(gens))
    while live:
        reqs = {}
        for i in list(live):
            try:
                reqs[i] = live[i].send(to_send[i])
            except StopIteration as e:
                results[i] = e.value
                del live[i]
        if not reqs:
            break
        from longcalld_torch.core.noisy import fuse_requests
        flat, flags, owners = fuse_requests(reqs.items())
        res = (yield (flat, flags)) if flat else []
        # generators whose round carried no pairs still receive []
        to_send = [[] if i in reqs else None for i in range(n)]
        for i, off, cnt in owners:
            to_send[i] = res[off:off + cnt]
    return results


def collect_noisy_vars1(opt: CallOpts, chunk: WindowChunk, reg_i: int):
    """One noisy region end-to-end (collect_noisy_vars1, collect_var.c:
    2648-2741), as a coroutine: yields (pairs, left_align) alignment
    requests (batched across regions by core.noisy), returns either
    ("done", n) for resolved-without-new-vars, ("retry",) when unresolvable
    (re-tried after phasing updates), or ("vars", cand, te, cate, profile)
    whose merge the driver applies in deterministic region order."""
    regs = chunk.noisy_regs
    # the reference uses cr_start (0-based) directly as a 1-based coordinate,
    # effectively extending the region one base left (collect_var.c:2650)
    reg_beg = int(regs.starts[reg_i])
    reg_end = int(regs.ends[reg_i])
    reg_beg = max(reg_beg, chunk.ref_beg)
    reg_end = min(reg_end, chunk.ref_end)
    if reg_end - reg_beg + 1 > opt.max_noisy_reg_len:
        return ("done", 0)
    read_ids = [ri for ri in chunk.order
                if chunk.digars[ri] is not None
                and not (chunk.digars[ri].beg > reg_end
                         or chunk.digars[ri].end <= reg_beg)]
    if len(read_ids) > opt.max_noisy_reg_cov:
        return ("done", 0)
    if not read_ids:
        return ("done", 0)
    ref_seq = chunk.ref4_slice(reg_beg, reg_end - reg_beg + 1)

    info = collect_noisy_read_info(opt, chunk, reg_beg, reg_end, read_ids)
    sampling = (reg_end - reg_beg + 1) >= opt.min_noisy_reg_size_to_sample_reads
    sort_noisy_reads(info, sampling)
    ps = phase_set_with_both_haps(info, opt.min_hap_full_reads,
                                  opt.min_hap_reads)
    n_full = int(sum(1 for c in info.covers if is_both_cover(int(c))))

    n_cons = 0
    results: List[Tuple[MsaResult, List[int]]] = []  # (msa, subset indices)
    if ps > 0:
        use_non_full = not _ref_is_homopolymer(ref_seq,
                                               opt.noisy_reg_flank_len)
        hap_msas = []
        gens, sels = [], []
        for hap in (1, 2):
            sel = [i for i in range(len(info.lens))
                   if info.lens[i] > 0 and info.phase_sets[i] == ps
                   and info.haps[i] == hap
                   and (use_non_full or is_both_cover(int(info.covers[i])))]
            if not sel:
                continue
            if info.lens[sel[0]] >= opt.max_noisy_reg_len:
                break
            gens.append(star_msa(opt, [info.seqs[i] for i in sel],
                                 [int(info.covers[i]) for i in sel], 1,
                                 sampling))
            sels.append(sel)
        # both haps' MSAs advance in lockstep so their alignment rounds
        # fuse into shared submits — sequential per-hap loops doubled the
        # link round-trip chain of every phased region
        ms = yield from _drive_lockstep(gens)
        for m, sel in zip(ms, sels):
            if m is not None and m.n_cons >= 1:
                hap_msas.append((m, sel))
        if len(hap_msas) == 2:
            n_cons = 2
            results = hap_msas
    elif n_full >= opt.min_dp:
        sel = [i for i in range(len(info.lens))
               if info.lens[i] > 0 and is_both_cover(int(info.covers[i]))]
        if sel and info.lens[sel[0]] < opt.max_noisy_reg_len:
            m = yield from star_msa(opt, [info.seqs[i] for i in sel],
                                    [int(info.covers[i]) for i in sel], 2,
                                    False)
            if m is not None:
                n_cons = m.n_cons
                if m.n_cons == 1:
                    results = [(m, sel)]
                else:
                    # split the 2-cluster result into two single-cons views
                    for ci in range(2):
                        sub = MsaResult(1, [m.cons_seqs[ci]],
                                        [m.clu_read_idx[ci]], m.msa_rows,
                                        [m.cons_rows[ci]], m.included)
                        results.append((sub, sel))
    if n_cons == 0:
        return ("retry",)

    # ref <-> cons alignment strings (batched) + per-cluster read data
    rc_res = yield ([(ref_seq, m.cons_seqs[0]) for m, _ in results],
                    opt.gap_aln == 1)
    clusters = []  # (ref_cons AlnStr, [(read_id, cons_read AlnStr)])
    for (m, sel), rc in zip(results, rc_res):
        L = len(rc.pattern_alg)
        ref_cons = AlnStr(rc.pattern_alg, rc.text_alg, 0, L - 1, 0, L - 1)
        rows = []
        for j in m.clu_read_idx[0]:
            rid = info.read_ids[sel[j]]
            row = m.msa_rows[j].copy()
            row[row == msa_mod.NOCOV] = GAP
            cons_read = cons_read_aln_from_msa(m.cons_rows[0], row,
                                               int(info.covers[sel[j]]))
            rows.append((rid, cons_read))
        clusters.append((ref_cons, rows))

    # ref<->read aln strings feed digar refinement (--refine-aln) and the
    # somatic SV miner (align.c:1786,1803: collect when refine_bam+out_bam
    # or somatic mode, then update_digars_from_aln_str before var extraction)
    ref_read_cache = {}
    if (opt.refine_bam and opt.out_bam_fn is not None) or opt.out_somatic:
        from longcalld_tpu.core.refine import splice_read_digar
        cov_by_rid = {info.read_ids[i]: int(info.covers[i])
                      for i in range(len(info.read_ids))}
        for ref_cons, rows in clusters:
            for rid, cons_read in rows:
                ref_read = ref_read_aln_from_pair(opt, ref_cons, cons_read)
                ref_read_cache[rid] = ref_read
                nd = splice_read_digar(
                    opt, chunk.digars[rid], cov_by_rid[rid], reg_beg, reg_end,
                    info.read_reg_beg[rid], info.read_reg_end[rid],
                    ref_read.target_aln, ref_read.query_aln)
                if nd is not None:
                    chunk.digars[rid] = nd

    # variant extraction
    n_reads_chunk = chunk.n_reads
    # NOTE: a region whose consensus matches the reference (zero germline
    # vars) still runs the somatic miner when -s: the reference calls
    # make_somatic_vars_from_aln_str unconditionally after
    # make_vars_from_msa_cons_aln (collect_var.c:2699-2712) — a carrier-
    # private SV in an otherwise clean region is exactly the somatic case
    if n_cons == 1:
        ref_cons, rows = clusters[0]
        cand, te_l, _ = make_cand_vars_from_aln(
            opt, chunk, reg_beg, ref_cons.target_aln, ref_cons.query_aln)
        if len(cand) == 0 and not opt.out_somatic:
            return ("done", 0)
        cate = np.full(len(cand), config.NOISY_CAND_HOM_VAR, dtype=np.int32)
        p = NoisyProfile(n_reads_chunk, len(cand))
        _update_profile_one_cons_batch(rows, reg_beg, cand, p)
    else:
        ref_cons1, rows1 = clusters[0]
        ref_cons2, rows2 = clusters[1]
        v1, te1, _ = make_cand_vars_from_aln(
            opt, chunk, reg_beg, ref_cons1.target_aln, ref_cons1.query_aln)
        v2, te2, _ = make_cand_vars_from_aln(
            opt, chunk, reg_beg, ref_cons2.target_aln, ref_cons2.query_aln)
        if len(v1) + len(v2) == 0 and not opt.out_somatic:
            return ("done", 0)
        cand, te_l, cate, from_cons = _merge_two_hap_vars(opt, v1, te1,
                                                          v2, te2)
        p = NoisyProfile(n_reads_chunk, len(cand))
        for clu_idx, (ref_cons, rows) in zip((1, 2), clusters):
            _update_profile_two_cons_batch(clu_idx, rows, ref_cons, reg_beg,
                                           cand, from_cons, p)

    somatic = None
    if opt.out_somatic:
        somatic = _mine_read_somatic_vars(opt, chunk, reg_beg, cand, clusters,
                                          ref_read_cache)
        if somatic[0] is None:
            somatic = None
    return ("vars", (cand, te_l, cate, p), somatic)
