"""Candidate-variant classification and noisy-region bookkeeping.

Re-implements classify_var_cate / classify_cand_vars
(reference/src/collect_var.c:270-1045) and the noisy-region
pre/post-processing (:480-666).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from longcalld_torch import config
from longcalld_torch.config import CallOpts
from longcalld_torch.core.chunk import WindowChunk
from longcalld_torch.core.sites import CandVars
from longcalld_torch.io.bam import CDEL, CDIFF, CINS
from longcalld_torch.utils.intervals import IntervalSet
from longcalld_torch.utils.mathx import fisher_exact_two_tailed


def var_is_strand_bias(cand: CandVars, i: int, opt: CallOpts) -> bool:
    """Fisher test of forward/reverse alt coverage vs an even split
    (var_is_strand_bias, collect_var.c:270-296)."""
    for_alt = int(cand.strand_covs[i, 0, 1])
    rev_alt = int(cand.strand_covs[i, 1, 1])
    expected = (for_alt + rev_alt) // 2
    if expected == 0:
        return False
    p = fisher_exact_two_tailed(for_alt, rev_alt, expected, expected)
    return p < opt.strand_bias_pval


def var_is_homopolymer(opt: CallOpts, chunk: WindowChunk, pos: int,
                       var_type: int, ref_len: int, alt_len: int) -> bool:
    """STR check: 1-6 bp unit repeated >=3x adjacent to the variant
    (var_is_homopolymer, collect_var.c:306-358)."""
    xid = opt.noisy_reg_max_xgaps
    if var_type == CDIFF:
        start_pos, end_pos = pos - 1, pos + 1
    elif var_type == CINS:
        if alt_len > xid:
            return False
        start_pos, end_pos = pos - 1, pos
    else:  # DEL
        if ref_len > xid:
            return False
        start_pos, end_pos = pos + ref_len - 1, pos
    max_unit, n_copy = 6, 3
    # unit u repeats 3x iff s[u:2u] == s[:u] and s[2u:3u] == s[:u]; bytes
    # slice compares run in C (the generator form cost ~200 numpy scalar
    # indexes per variant)
    fwd = chunk.ref4_slice(end_pos, max_unit * n_copy).tobytes()
    for u in range(1, max_unit + 1):
        if fwd[u:2 * u] == fwd[:u] and fwd[2 * u:3 * u] == fwd[:u]:
            return True
    rev = chunk.ref4_slice(start_pos - max_unit * n_copy + 1,
                           max_unit * n_copy)[::-1].tobytes()
    for u in range(1, max_unit + 1):
        if rev[u:2 * u] == rev[:u] and rev[2 * u:3 * u] == rev[:u]:
            return True
    return False


def var_is_repeat_region(opt: CallOpts, chunk: WindowChunk, pos: int,
                         var_type: int, ref_len: int, alt_len: int,
                         alt_seq: bytes) -> bool:
    """Indel whose sequence is a 3-fold tandem copy of the adjacent reference
    (var_is_repeat_region, collect_var.c:361-405)."""
    xid = opt.noisy_reg_max_xgaps
    if var_type == CDEL:
        if ref_len > xid:
            return False
        ln = ref_len * 3
        if pos < chunk.ref_beg or pos + ref_len + ln >= chunk.ref_end:
            return False
        a = chunk.ref4_slice(pos, ln)
        b = chunk.ref4_slice(pos + ref_len, ln)
        return bool((a == b).all())
    else:  # INS
        if alt_len > xid:
            return False
        ln = alt_len * 3
        if pos < chunk.ref_beg or pos + ln >= chunk.ref_end:
            return False
        ref_run = chunk.ref4_slice(pos, ln)
        ins = np.frombuffer(alt_seq, dtype=np.uint8)
        alt_run = np.tile(ins, 3)[:ln]  # == the C in-place periodic extension
        return bool((ref_run == alt_run).all())


def classify_var_cate(opt: CallOpts, chunk: WindowChunk, cand: CandVars,
                      i: int) -> int:
    """Single-site category (classify_var_cate, collect_var.c:413-434)."""
    total = int(cand.total_cov[i])
    lowq = int(cand.low_qual_cov[i])
    if total + lowq < opt.min_dp:
        return config.LOW_COV_VAR
    alt_dp = int(cand.alle_covs[i, 1])
    if alt_dp < opt.min_alt_dp:
        return config.LOW_COV_VAR
    if opt.is_ont and var_is_strand_bias(cand, i, opt):
        return config.STRAND_BIAS_VAR
    alt_af = alt_dp / total if total else 0.0
    if alt_af < opt.min_af:
        return config.LOW_AF_VAR
    if alt_af > opt.max_af:
        return config.CLEAN_HOM_VAR
    t = int(cand.type[i])
    pos = int(cand.pos[i])
    if t in (CINS, CDEL) and (
            var_is_homopolymer(opt, chunk, pos, t, int(cand.ref_len[i]),
                               int(cand.alt_len[i]))
            or var_is_repeat_region(opt, chunk, pos, t, int(cand.ref_len[i]),
                                    int(cand.alt_len[i]), cand.alt_seqs[i])):
        return config.REP_HET_VAR
    if t == CDIFF:
        return config.CLEAN_HET_SNP
    return config.CLEAN_HET_INDEL


# ---------- noisy-region processing ----------

def extend_with_low_comp(low_comp: IntervalSet, start: int,
                         end: int) -> Tuple[int, int]:
    """low_comp_cr_start_end (collect_var.c:466-478); [start,end] 1-based."""
    new_s, new_e = start, end
    if low_comp is None or len(low_comp) == 0:
        return new_s, new_e
    for j in low_comp.overlap_indices(start - 1, end):
        s = int(low_comp.starts[j]) + 1
        e = int(low_comp.ends[j])
        if s < new_s:
            new_s = s
        if e > new_e:
            new_e = e
    return new_s, new_e


def pre_process_noisy_regs(chunk: WindowChunk, opt: CallOpts) -> None:
    """Extend by low-complexity intervals, dynamic-window merge, drop regions
    with too few / too small a fraction of noisy reads
    (pre_process_noisy_regs, collect_var.c:557-642)."""
    regs = chunk.noisy_regs
    if regs is None or len(regs) == 0:
        return
    # extend with low-complexity, then dynamic merge (twice, like the C which
    # merges inside cr_extend_noisy_regs_with_low_comp and again after)
    if chunk.low_comp is not None and len(chunk.low_comp) > 0:
        new = IntervalSet()
        for s, e, lab in regs:
            ns, ne = extend_with_low_comp(chunk.low_comp, s + 1, e)
            new.add(ns - 1, ne, lab)
        regs = new.index()
    regs = regs.merge(-1)
    regs = regs.merge(-1)

    n = len(regs)
    rs, re_ = regs.starts, regs.ends
    sorted_disjoint = (n <= 1
                       or (bool(np.all(np.diff(rs) >= 0))
                           and bool(np.all(np.diff(re_) >= 0))))
    if sorted_disjoint:
        # overlapped regions form a contiguous index RANGE when both
        # boundary arrays are sorted, so the per-read per-region walk
        # (O(reads x regions x any_overlap)) collapses to two searchsorted
        # per read plus diff-array accumulation
        total_diff = np.zeros(n + 1, dtype=np.int64)
        noisy_diff = np.zeros(n + 1, dtype=np.int64)
        for ri in chunk.order:
            d = chunk.digars[ri]
            if d is None:
                continue
            aL = int(re_.searchsorted(d.beg - 1, side="right"))
            aR = int(rs.searchsorted(d.end, side="left"))
            if aL >= aR:
                continue
            total_diff[aL] += 1
            total_diff[aR] -= 1
            nr = d.noisy_regs
            if nr is None or len(nr) == 0:
                continue
            nr.index()
            # union of per-interval region ranges (count once per read)
            spans = sorted(
                (max(aL, int(re_.searchsorted(int(s), side="right"))),
                 min(aR, int(rs.searchsorted(int(e), side="left"))))
                for s, e in zip(nr.starts, nr.ends))
            cur_l = cur_r = None
            for bL, bR in spans:
                if bL >= bR:
                    continue
                if cur_l is None:
                    cur_l, cur_r = bL, bR
                elif bL <= cur_r:
                    cur_r = max(cur_r, bR)
                else:
                    noisy_diff[cur_l] += 1
                    noisy_diff[cur_r] -= 1
                    cur_l, cur_r = bL, bR
            if cur_l is not None:
                noisy_diff[cur_l] += 1
                noisy_diff[cur_r] -= 1
        total_reads = np.cumsum(total_diff[:-1])
        noisy_reads = np.cumsum(noisy_diff[:-1])
    else:
        total_reads = np.zeros(n, dtype=np.int64)
        noisy_reads = np.zeros(n, dtype=np.int64)
        for ri in chunk.order:
            d = chunk.digars[ri]
            if d is None:
                continue
            for r_i in regs.overlap_indices(d.beg - 1, d.end):
                total_reads[r_i] += 1
                if d.noisy_regs.any_overlap(int(regs.starts[r_i]),
                                            int(regs.ends[r_i])):
                    noisy_reads[r_i] += 1
    # skip condition: n_noisy < min_alt_dp OR noisy/total < min_af
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(total_reads > 0, noisy_reads / total_reads, 0.0)
    keep = ~((noisy_reads < opt.min_alt_dp) | (ratio < opt.min_af))
    chunk.noisy_regs = IntervalSet.from_arrays(
        regs.starts[keep], regs.ends[keep], regs.labels[keep])


def build_var_noisy_cache(chunk: WindowChunk) -> None:
    """Per-read coverage intervals and merged variant-event intervals
    (build_var_noisy_reads_ratio_cache, collect_var.c:668-716)."""
    if chunk.var_noisy_cov is not None:
        return
    cov = IntervalSet()
    err = IntervalSet()
    for ri in chunk.order:
        d = chunk.digars[ri]
        if d is None or len(d.pos) == 0 or d.beg > d.end:
            continue
        cov.add(d.beg - 1, d.end, ri)
        m = d.var_mask()
        if m.any():
            starts = d.pos[m] - 1
            ends = d.pos[m].copy()
            xe = (d.type[m] == CDIFF) | (d.type[m] == CDEL)
            ends[xe] += d.len[m][xe] - 1
            # merge runs where start < running-max end (events are
            # pos-sorted, so the global cummax equals the segment cummax
            # at every break candidate)
            cme = np.maximum.accumulate(ends)
            brk = np.nonzero(starts[1:] >= cme[:-1])[0] + 1
            seg = np.concatenate([[0], brk])
            err.add_many(starts[seg], np.maximum.reduceat(ends, seg), ri)
    chunk.var_noisy_cov = cov.index()
    chunk.var_noisy_err = err.index()


def var_noisy_reads_ratio(chunk: WindowChunk, var_start: int,
                          var_end: int) -> float:
    """Fraction of covering reads with a variant event overlapping
    [var_start, var_end] (var_noisy_reads_ratio, collect_var.c:718-751)."""
    build_var_noisy_cache(chunk)
    total = len(chunk.var_noisy_cov.overlap_indices(var_start - 1, var_end))
    if total == 0:
        return 0.0
    idx = chunk.var_noisy_err.overlap_indices(var_start - 1, var_end)
    n_noisy = len(np.unique(chunk.var_noisy_err.labels[idx]))
    return n_noisy / total


def _var_span(cand: CandVars, i: int) -> Tuple[int, int]:
    pos = int(cand.pos[i])
    if cand.type[i] == CINS:
        return pos, pos
    return pos, pos + int(cand.ref_len[i]) - 1


def add_var_region(opt: CallOpts, chunk: WindowChunk, var_cr: IntervalSet,
                   cand: CandVars, i: int, check_ratio: bool) -> None:
    """cr_add_var_cr (collect_var.c:754-777): extend the var span by
    overlapping low-complexity intervals, optionally gate on noisy ratio."""
    var_start, var_end = _var_span(cand, i)
    if chunk.low_comp is not None:
        for j in chunk.low_comp.overlap_indices(var_start - 1, var_end):
            s = int(chunk.low_comp.starts[j]) + 1
            e = int(chunk.low_comp.ends[j])
            var_start = min(var_start, s)
            var_end = max(var_end, e)
    if (not check_ratio
            or var_noisy_reads_ratio(chunk, var_start, var_end) >= opt.min_af):
        var_cr.add(var_start - 1, var_end, 1)


def post_process_noisy_regs(chunk: WindowChunk, opt: CallOpts,
                            var_cate: np.ndarray) -> None:
    """Pad regions by flank_len while keeping >=1 bp clear of adjacent clean
    variants (post_process_noisy_regs + collect_noisy_reg_start_end,
    collect_var.c:481-535, 646-666)."""
    regs = chunk.noisy_regs
    n_regs = len(regs)
    if n_regs == 0:
        return
    cand = chunk.cand_vars
    n_vars = len(cand) if cand is not None else 0
    valid = ((var_cate & config.NOT_CAND_VAR_CATE) == 0) if n_vars else \
        np.zeros(0, dtype=bool)

    max_left = np.full(n_regs, -1, dtype=np.int64)
    min_right = np.full(n_regs, -1, dtype=np.int64)
    reg_i = var_i = 0
    while reg_i < n_regs and var_i < n_vars:
        if not valid[var_i]:
            var_i += 1
            continue
        v_start = int(cand.pos[var_i])
        v_end = v_start + int(cand.ref_len[var_i]) - 1
        r_start = int(regs.starts[reg_i]) + 1
        r_end = int(regs.ends[reg_i])
        if v_start > r_end:
            if min_right[reg_i] == -1:
                min_right[reg_i] = var_i
            reg_i += 1
        elif v_end < r_start:
            max_left[reg_i] = var_i
            var_i += 1
        else:
            var_i += 1

    flank = opt.noisy_reg_flank_len
    out = IntervalSet()
    for r in range(n_regs):
        ml = int(max_left[r]) if max_left[r] != -1 else min(n_vars - 1, 0)
        mr = int(min_right[r]) if min_right[r] != -1 else max(0, n_vars - 1)
        ori_s = int(regs.starts[r]) + 1
        ori_e = int(regs.ends[r])
        cur_s = ori_s - flank
        vi = ml
        while vi >= 0 and n_vars > 0:
            if valid[vi]:
                v_start = int(cand.pos[vi])
                v_end = v_start + int(cand.ref_len[vi]) - 1
                if v_end < cur_s - 1:
                    break
                if v_start - flank < cur_s:
                    cur_s = v_start - flank
            vi -= 1
        cur_e = ori_e + flank
        vi = mr
        while vi < n_vars:
            if valid[vi]:
                v_start = int(cand.pos[vi])
                v_end = v_start + int(cand.ref_len[vi]) - 1
                if v_start > cur_e + 1:
                    break
                if v_end + flank > cur_e:
                    cur_e = v_end + flank
            vi += 1
        out.add(cur_s, cur_e, int(regs.labels[r]))
    chunk.noisy_regs = out.index().merge(0)


def classify_cand_vars(chunk: WindowChunk, opt: CallOpts) -> None:
    """Full classification pass (classify_cand_vars, collect_var.c:902-1045):
    category assignment, noisy-region overlap elimination, repeat-var noisy
    promotion, overlapping-var noisy promotion, somatic promotion, flanked
    noisy post-processing and compaction of the surviving variant array."""
    cand = chunk.cand_vars
    n = len(cand)
    cate = np.empty(n, dtype=np.int32)
    var_pos_cr = IntervalSet()
    noisy_var_cr = IntervalSet()
    for i in range(n):
        cate[i] = classify_var_cate(opt, chunk, cand, i)
        if cate[i] == config.LOW_COV_VAR:
            continue
        if opt.is_ont and cate[i] == config.STRAND_BIAS_VAR:
            continue
        pos = int(cand.pos[i])
        if cand.type[i] == CINS:
            var_pos_cr.add(pos - 1, pos, 1)
        else:
            var_pos_cr.add(pos - 1, pos + int(cand.ref_len[i]) - 1, 1)
    var_pos_cr.index()

    from longcalld_torch.core.somatic import var_is_cand_somatic

    for i in range(n):
        c = int(cate[i])
        if c in (config.NON_VAR, config.STRAND_BIAS_VAR):
            continue
        pos = int(cand.pos[i])
        if chunk.noisy_regs is not None and len(chunk.noisy_regs) > 0:
            if cand.type[i] == CINS:
                hit = chunk.noisy_regs.any_overlap(pos - 1, pos)
            else:
                hit = chunk.noisy_regs.any_overlap(
                    pos - 1, pos + int(cand.ref_len[i]) - 1)
            if hit:
                cate[i] = config.NON_VAR
                continue
        if c == config.LOW_COV_VAR:
            if opt.out_somatic and var_is_cand_somatic(chunk, opt, cand, i):
                cate[i] = config.CAND_SOMATIC_VAR
            continue
        if c == config.REP_HET_VAR:
            if chunk.reg_beg <= pos <= chunk.reg_end:
                add_var_region(opt, chunk, noisy_var_cr, cand, i, False)
            continue
        if cand.type[i] == CINS:
            n_ovlp = len(var_pos_cr.overlap_indices(pos - 1, pos))
        else:
            n_ovlp = len(var_pos_cr.overlap_indices(
                pos - 1, pos + int(cand.ref_len[i]) - 1))
        if n_ovlp > 1 and chunk.reg_beg <= pos <= chunk.reg_end:
            add_var_region(opt, chunk, noisy_var_cr, cand, i, True)
        if c == config.LOW_AF_VAR:
            if opt.out_somatic and var_is_cand_somatic(chunk, opt, cand, i):
                cate[i] = config.CAND_SOMATIC_VAR
                continue
            cate[i] = config.LOW_COV_VAR

    if len(noisy_var_cr) > 0:
        chunk.noisy_regs = chunk.noisy_regs.union_with(
            noisy_var_cr.index()).merge(-1)

    if opt.out_somatic:
        from longcalld_torch.core.somatic import merge_clean_somatic_vars
        merge_clean_somatic_vars(opt, cand, cate)

    post_process_noisy_regs(chunk, opt, cate)

    # drop vars fully contained in (post-processed) noisy regions; compact
    keep_idx: List[int] = []
    kept_cate: List[int] = []
    for i in range(n):
        c = int(cate[i])
        if c & config.NOT_CAND_VAR_CATE:
            continue
        pos = int(cand.pos[i])
        if (chunk.noisy_regs is not None and len(chunk.noisy_regs) > 0
                and chunk.noisy_regs.contained_in_any(
                    pos - 1, pos + int(cand.ref_len[i]))):
            continue
        keep_idx.append(i)
        kept_cate.append(c)
    chunk.cand_vars = cand.take(np.array(keep_idx, dtype=np.int64))
    chunk.var_cate = np.array(kept_cate, dtype=np.int32)
