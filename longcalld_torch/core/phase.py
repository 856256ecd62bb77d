"""Local haplotagging: iterative 2-cluster EM over the read x variant matrix.

Host reference implementation of assign_hap_based_on_germline_het_vars_kmeans
(reference/src/assign_hap.c:16-547): seed at the deepest clean het SNP,
sweep outward assigning reads to the haplotype maximizing weighted allele
agreement, then iterate (phase-set segmentation + consensus flip) and (read
re-assignment + consensus update) to a fixpoint (<=10 iterations).

The sequential sweep semantics (consensus updates feed later reads) are kept
exactly; the device kernel in longcalld_torch.ops.phase_kernel batches the
fixpoint iterations as masked matmuls and is bit-exact against this module
(tests/test_phase_kernel.py, on every real HiFi window).
"""

from __future__ import annotations

from typing import List

import numpy as np

from longcalld_torch import config
from longcalld_torch.config import CallOpts
from longcalld_torch.core.chunk import WindowChunk
from longcalld_torch.io.bam import CDIFF

HOM, H1, H2 = 0, 1, 2


def _init_max_cov_allele(opt: CallOpts, cand, i: int) -> int:
    """get_var_init_max_cov_allele (assign_hap.c:22-34)."""
    if opt.is_ont and cand.is_homopolymer_indel is not None \
            and cand.is_homopolymer_indel[i]:
        return -1
    covs = cand.alle_covs[i]
    max_cov, max_i = 0, -1
    for a in range(2):
        if covs[a] > max_cov:
            max_cov = int(covs[a])
            max_i = a
    return max_i


def init_var_hap_state(opt: CallOpts, chunk: WindowChunk,
                       valid_idx: np.ndarray) -> None:
    """var_init_hap_profile_cons_allele (assign_hap.c:39-63)."""
    cand = chunk.cand_vars
    n = len(cand)
    if cand.hap_cons_alle is None:
        cand.hap_cons_alle = np.full((n, 3), -1, dtype=np.int8)
        cand.hap_profile = np.zeros((n, 3, 2), dtype=np.int32)
        # phase_set starts at 0 = "unset" (init_cand_vars_based_on_sites,
        # collect_var.c:28) so unphased vars print '/' genotypes
        cand.phase_set = np.zeros(n, dtype=np.int64)
    for vi in valid_idx:
        cand.hap_profile[vi, 1:] = 0
        cand.hap_cons_alle[vi, HOM] = _init_max_cov_allele(opt, cand, vi)
        if chunk.var_cate[vi] in (config.NOISY_CAND_HOM_VAR,
                                  config.CLEAN_HOM_VAR):
            cand.hap_cons_alle[vi, 1:] = 1
        else:
            cand.hap_cons_alle[vi, 1:] = -1


def select_init_var(chunk: WindowChunk, valid_idx: np.ndarray) -> int:
    """Deepest clean het SNP > clean het indel > noisy het SNP > noisy het
    non-HP indel (select_init_var, assign_hap.c:94-125).  Returns position
    within valid_idx or -1."""
    cand = chunk.cand_vars
    cate = chunk.var_cate
    best = {k: (-1, 0) for k in range(4)}
    for j, vi in enumerate(valid_idx):
        c = cate[vi]
        cov = int(cand.total_cov[vi])
        if c == config.CLEAN_HET_SNP:
            k = 0
        elif c == config.CLEAN_HET_INDEL:
            k = 1
        elif c == config.NOISY_CAND_HET_VAR:
            if cand.type[vi] == CDIFF:
                k = 2
            elif (cand.is_homopolymer_indel is None
                  or not cand.is_homopolymer_indel[vi]):
                k = 3
            else:
                continue
        else:
            continue
        if best[k][0] == -1 or best[k][1] < cov:
            best[k] = (j, cov)
    for k in range(4):
        if best[k][0] != -1:
            return best[k][0]
    return -1


def _score_masks(chunk: WindowChunk, target_cate: int):
    """Shared per-var masks for the vectorized scorers.  Returns
    (scoreable, w_score, clean_snp): vars that participate in scoring (in
    target cate, non-HP, non-noisy-hom), their score weight (0 for clean
    hom, which fills/counts but never scores), and the clean-SNP mask for
    the agree/conflict counters."""
    cand = chunk.cand_vars
    cate = chunk.var_cate
    # identity-cached: the seeded outward sweep calls this once per read,
    # and the inputs (identity fields, categories, hp flags) are immutable
    # for a given (cand, cate) pair
    c = getattr(chunk, "_smc", None)
    if c is not None and c[0] is cand and c[1] is cate \
            and c[2] == target_cate:
        return c[3]
    in_target = (cate & target_cate) != 0
    hp = (cand.is_homopolymer_indel
          if cand.is_homopolymer_indel is not None
          else np.zeros(len(cand), dtype=bool))
    scoreable = in_target & ~hp & (cate != config.NOISY_CAND_HOM_VAR)
    w = np.where((cate == config.CLEAN_HET_SNP)
                 | (cate == config.CLEAN_HET_INDEL), 2, 1).astype(np.int64)
    w_score = np.where(cate == config.CLEAN_HOM_VAR, 0, w)
    clean_snp = ((cate & config.CAND_GERMLINE_CLEAN_VAR_CATE) != 0) \
        & (cand.type == CDIFF)
    out = (scoreable, w_score, clean_snp)
    chunk._smc = (cand, cate, target_cate, out)
    return out


def _complement_fill(cand, mask: np.ndarray) -> None:
    """read_to_cons_allele_score's one-sided fill (assign_hap.c:139-143)
    applied to every var in ``mask`` (exactly the vars at least one read
    scores, so the mutation matches the sequential walk)."""
    hc = cand.hap_cons_alle
    one = mask & (hc[:, 1] == -1) & (hc[:, 2] != -1)
    hc[one, 1] = 1 - hc[one, 2]
    two = mask & (hc[:, 2] == -1) & (hc[:, 1] != -1)
    hc[two, 2] = 1 - hc[two, 1]


def _decide_haps(s1, s2, n_used, agree1, agree2, conflict1, conflict2,
                 chunk: WindowChunk, read_idx: np.ndarray) -> np.ndarray:
    """The max/min decision of init_assign_read_hap_based_on_cons_alle
    (assign_hap.c:182-197), vectorized.  Returns int8 haps (-1/0/1/2) and
    writes the clean-SNP counters for positively assigned reads."""
    max_s = np.maximum(s1, s2)
    min_s = np.minimum(s1, s2)
    max_hap = np.where(s1 >= s2, 1, 2)   # hap 1 wins ties (strict > in C)
    min_hap = np.where(s1 <= s2, 1, 2)
    hap = np.where(max_s > 0, max_hap,
                   np.where(min_s < 0, 3 - min_hap, 0)).astype(np.int8)
    hap = np.where(n_used == 0, -1, hap)
    chunk.n_clean_agree_snps[read_idx] = 0
    chunk.n_clean_conflict_snps[read_idx] = 0
    pos = max_s > 0
    if pos.any():
        sel = np.where(max_hap == 1, agree1, agree2)
        chunk.n_clean_agree_snps[read_idx[pos]] = sel[pos]
        selc = np.where(max_hap == 1, conflict1, conflict2)
        chunk.n_clean_conflict_snps[read_idx[pos]] = selc[pos]
    return hap


def _score_all_reads(chunk: WindowChunk, target_cate: int,
                     read_idx: np.ndarray) -> np.ndarray:
    """Vectorized assign_read_hap over every read in ``read_idx`` against
    the CURRENT consensus (valid because iter_update_var_hap_to_cons_alle
    scores all reads before any consensus update, assign_hap.c:425-467).
    Applies the complement fill to scored vars first.  Returns per-read
    haps in {-1, 0, 1, 2}."""
    cand = chunk.cand_vars
    scoreable, w_score, clean_snp = _score_masks(chunk, target_cate)
    A = chunk.alleles[read_idx]
    A0 = (A == 0)
    A1 = (A == 1)
    scored_any = scoreable & ((A0 | A1).any(axis=0))
    _complement_fill(cand, scored_any)
    hc = cand.hap_cons_alle
    cons_set = scoreable & (hc[:, 1] != -1)          # both set after fill
    D = A0.astype(np.int64) - A1.astype(np.int64)
    # sign vector: +w if cons==0 (ref agrees), -w if cons==1
    sv1 = np.where(cons_set, w_score * (1 - 2 * hc[:, 1].astype(np.int64)), 0)
    sv2 = np.where(cons_set, w_score * (1 - 2 * hc[:, 2].astype(np.int64)), 0)
    s1 = D @ sv1
    s2 = D @ sv2
    used_v = cons_set & (w_score > 0)
    n_used = (A0 | A1) @ used_v.astype(np.int64)
    cs = clean_snp & cons_set
    cs0_1 = cs & (hc[:, 1] == 0)
    cs1_1 = cs & (hc[:, 1] == 1)
    cs0_2 = cs & (hc[:, 2] == 0)
    cs1_2 = cs & (hc[:, 2] == 1)
    # NOTE: bool @ bool is a logical any in numpy — cast to count
    agree1 = A0 @ cs0_1.astype(np.int64) + A1 @ cs1_1.astype(np.int64)
    conflict1 = A0 @ cs1_1.astype(np.int64) + A1 @ cs0_1.astype(np.int64)
    agree2 = A0 @ cs0_2.astype(np.int64) + A1 @ cs1_2.astype(np.int64)
    conflict2 = A0 @ cs1_2.astype(np.int64) + A1 @ cs0_2.astype(np.int64)
    return _decide_haps(s1, s2, n_used, agree1, agree2, conflict1, conflict2,
                        chunk, read_idx)


def assign_read_hap(chunk: WindowChunk, read_i: int, target_cate: int
                    ) -> int:
    """init_assign_read_hap_based_on_cons_alle (assign_hap.c:151-198),
    row-vectorized.  Returns -1 (no usable var), 0 (tied) or 1/2; updates
    the read's clean-SNP agree/conflict counters."""
    cand = chunk.cand_vars
    chunk.n_clean_agree_snps[read_i] = 0
    chunk.n_clean_conflict_snps[read_i] = 0
    if chunk.read_start_var[read_i] < 0:
        return -1
    scoreable, w_score, clean_snp = _score_masks(chunk, target_cate)
    A = chunk.alleles[read_i]
    A0 = (A == 0)
    A1 = (A == 1)
    _complement_fill(cand, scoreable & (A0 | A1))
    hc = cand.hap_cons_alle
    cons_set = scoreable & (hc[:, 1] != -1)
    D = A0.astype(np.int64) - A1.astype(np.int64)
    sv1 = np.where(cons_set, w_score * (1 - 2 * hc[:, 1].astype(np.int64)), 0)
    sv2 = np.where(cons_set, w_score * (1 - 2 * hc[:, 2].astype(np.int64)), 0)
    s1 = int(D @ sv1)
    s2 = int(D @ sv2)
    n_used = int(((A0 | A1) & cons_set & (w_score > 0)).sum())
    if n_used == 0:
        return -1
    if s1 == 0 and s2 == 0:
        return 0
    max_s, max_hap = (s1, 1) if s1 >= s2 else (s2, 2)
    if max_s > 0:
        hsel = hc[:, max_hap]
        cs = clean_snp & cons_set
        chunk.n_clean_agree_snps[read_i] = int(
            (cs & ((A0 & (hsel == 0)) | (A1 & (hsel == 1)))).sum())
        chunk.n_clean_conflict_snps[read_i] = int(
            (cs & ((A0 & (hsel == 1)) | (A1 & (hsel == 0)))).sum())
        return max_hap
    min_hap = 1 if s1 <= s2 else 2
    return 3 - min_hap


def _apply_read_to_profiles(opt: CallOpts, chunk: WindowChunk, read_i: int,
                            hap: int, target_cate: int,
                            update_cons: bool) -> None:
    """update_var_hap_profile{_cons_alle}_based_on_read_hap
    (assign_hap.c:270-305), row-vectorized (per-var updates within one read
    are independent)."""
    cand = chunk.cand_vars
    if chunk.read_start_var[read_i] < 0:
        return
    alleles = chunk.alleles[read_i]
    m = ((chunk.var_cate & target_cate) != 0) & (alleles >= 0)
    vi = np.nonzero(m)[0]
    if len(vi) == 0:
        return
    av = alleles[vi].astype(np.int64)
    haps = (1, 2) if hap == 0 else (hap,)
    for h in haps:
        np.add.at(cand.hap_profile, (vi, h, av), 1)
        if update_cons:
            p0 = cand.hap_profile[vi, h, 0].astype(np.int64)
            p1 = cand.hap_profile[vi, h, 1].astype(np.int64)
            max_i = np.where(p1 > p0, 1, np.where(p0 > 0, 0, -1))
            if opt.is_ont and cand.is_homopolymer_indel is not None:
                hp = cand.is_homopolymer_indel[vi]
                max_cov = np.where(max_i == 1, p1,
                                   np.where(max_i == 0, p0, 0))
                max_i = np.where(hp & (max_cov < (p0 + p1) * 0.67), -1,
                                 max_i)
            cand.hap_cons_alle[vi, h] = max_i.astype(np.int8)


def _reads_covering_var(chunk: WindowChunk, vi: int) -> List[int]:
    """Reads whose profile span contains var vi, in (start_var, end_var,
    insertion-order) — matches the cgranges read_var_cr iteration order."""
    order = chunk._read_var_order
    starts = chunk.read_start_var[order]
    ends = chunk.read_end_var[order]
    m = (starts <= vi) & (ends >= vi)
    return [int(order[k]) for k in np.nonzero(m)[0]]


def _prepare_read_var_order(chunk: WindowChunk) -> None:
    reads = [ri for ri in chunk.order
             if chunk.digars[ri] is not None
             and chunk.read_start_var[ri] >= 0]
    keys = [(int(chunk.read_start_var[r]), int(chunk.read_end_var[r]) + 1)
            for r in reads]
    idx = sorted(range(len(reads)), key=lambda k: keys[k])
    chunk._read_var_order = np.array([reads[k] for k in idx], dtype=np.int64)


def _iter_update_phase_set(chunk: WindowChunk, valid_idx: np.ndarray) -> bool:
    """iter_update_var_hap_cons_phase_set (assign_hap.c:345-422): phase-set
    segmentation from adjacent-het read agreement, plus consensus flipping."""
    cand = chunk.cand_vars
    n_valid = len(valid_idx)
    is_het = np.zeros(n_valid, dtype=bool)
    het_pos: List[int] = []
    for j, vi in enumerate(valid_idx):
        hc = cand.hap_cons_alle[vi]
        hp = (cand.is_homopolymer_indel is not None
              and cand.is_homopolymer_indel[vi])
        if hc[1] != -1 and hc[2] != -1 and hc[1] != hc[2] and not hp:
            is_het[j] = True
            het_pos.append(j)
    n_agree = np.zeros(n_valid, dtype=np.int64)
    n_conflict = np.zeros(n_valid, dtype=np.int64)
    # per adjacent-het pair, count agreeing/conflicting phased reads in one
    # column pass (iter_update_var_hap_cons_phase_set's inner read loop,
    # assign_hap.c:357-388, vectorized over reads)
    haps_r = chunk.haps
    starts = chunk.read_start_var
    ends = chunk.read_end_var
    hc_all = cand.hap_cons_alle
    for k in range(1, len(het_pos)):
        j = het_pos[k]
        vi = int(valid_idx[j])
        prev_vi = int(valid_idx[het_pos[k - 1]])
        a1 = chunk.alleles[:, prev_vi]
        a2 = chunk.alleles[:, vi]
        # digar-less reads never get profile entries (their allele rows
        # stay -1), so a1/a2 >= 0 already excludes them
        m = ((haps_r != 0) & (starts >= 0) & (starts <= prev_vi)
             & (ends >= vi) & (a1 >= 0) & (a2 >= 0))
        if not m.any():
            continue
        h = haps_r[m].astype(np.int64)
        c_prev_own = np.where(h == 1, hc_all[prev_vi, 1], hc_all[prev_vi, 2])
        c_cur_own = np.where(h == 1, hc_all[vi, 1], hc_all[vi, 2])
        c_cur_other = np.where(h == 1, hc_all[vi, 2], hc_all[vi, 1])
        first = c_prev_own == a1[m]
        agree = first & (c_cur_own == a2[m])
        confl = first & ~agree & (c_cur_other == a2[m])
        n_agree[j] = int(agree.sum())
        n_conflict[j] = int(confl.sum())
    changed = False
    flip = 0
    phase_set = -1
    for j in range(n_valid):
        vi = int(valid_idx[j])
        if j == 0:
            phase_set = (int(cand.pos[vi]) if cand.type[vi] == CDIFF
                         else int(cand.pos[vi]) - 1)
            cand.phase_set[vi] = phase_set
            continue
        if is_het[j]:
            if n_agree[j] < 2 and n_conflict[j] < 2:
                phase_set = (int(cand.pos[vi]) if cand.type[vi] == CDIFF
                             else int(cand.pos[vi]) - 1)
            elif n_conflict[j] > n_agree[j]:
                flip ^= 1
            if flip == 1:
                changed = True
                cand.hap_cons_alle[vi, 1], cand.hap_cons_alle[vi, 2] = (
                    cand.hap_cons_alle[vi, 2], cand.hap_cons_alle[vi, 1])
        cand.phase_set[vi] = phase_set
    return changed


def _batch_update_profiles(opt: CallOpts, chunk: WindowChunk,
                           read_idx: np.ndarray, haps: np.ndarray,
                           target_cate: int) -> None:
    """update_var_hap_profile_based_on_read_hap for every read at once
    (assign_hap.c:270-305, update_cons=False path): hap-0 reads credit both
    haplotypes; only in-target vars with allele >= 0 count."""
    cand = chunk.cand_vars
    in_target = (chunk.var_cate & target_cate) != 0
    A = chunk.alleles[read_idx]
    A0 = ((A == 0) & in_target[None, :])
    A1 = ((A == 1) & in_target[None, :])
    h1 = ((haps == 1) | (haps == 0)).astype(np.int64)
    h2 = ((haps == 2) | (haps == 0)).astype(np.int64)
    cand.hap_profile[:, 1, 0] += h1 @ A0
    cand.hap_profile[:, 1, 1] += h1 @ A1
    cand.hap_profile[:, 2, 0] += h2 @ A0
    cand.hap_profile[:, 2, 1] += h2 @ A1


def _batch_update_cons(opt: CallOpts, chunk: WindowChunk,
                       valid_idx: np.ndarray) -> None:
    """update_var_hap_to_cons_alle over valid_idx x both haps
    (assign_hap.c:244-268): majority allele, ref preferred on ties, -1 when
    uncovered; ONT homopolymer indels need a 67% majority."""
    cand = chunk.cand_vars
    hp = (cand.is_homopolymer_indel[valid_idx]
          if opt.is_ont and cand.is_homopolymer_indel is not None
          else np.zeros(len(valid_idx), dtype=bool))
    for hap in (1, 2):
        p0 = cand.hap_profile[valid_idx, hap, 0].astype(np.int64)
        p1 = cand.hap_profile[valid_idx, hap, 1].astype(np.int64)
        max_i = np.where(p1 > p0, 1, np.where(p0 > 0, 0, -1))
        max_cov = np.where(max_i == 1, p1, np.where(max_i == 0, p0, 0))
        weak = hp & (max_cov < (p0 + p1) * 0.67)
        max_i = np.where(weak, -1, max_i)
        cand.hap_cons_alle[valid_idx, hap] = max_i.astype(np.int8)


def _iter_update_cons(opt: CallOpts, chunk: WindowChunk,
                      valid_idx: np.ndarray, target_cate: int) -> bool:
    """iter_update_var_hap_to_cons_alle (assign_hap.c:425-467), fully
    vectorized: every read is scored against the same (fixed) consensus,
    then profiles and consensus refresh in one batched pass."""
    cand = chunk.cand_vars
    prev = cand.hap_cons_alle[valid_idx, 1:].copy()
    cand.hap_profile[valid_idx, :, :] = 0
    read_idx = np.array([ri for ri in chunk.order
                         if chunk.digars[ri] is not None], dtype=np.int64)
    if len(read_idx) == 0:
        return False
    haps = _score_all_reads(chunk, target_cate, read_idx)
    haps = np.where(haps == -1, 0, haps).astype(np.int8)
    # reads with no profile span score 0 usable vars -> hap 0 there already
    chunk.haps[read_idx] = haps
    _batch_update_profiles(opt, chunk, read_idx, haps, target_cate)
    _batch_update_cons(opt, chunk, valid_idx)
    return bool((cand.hap_cons_alle[valid_idx, 1:] != prev).any())


def _update_read_phase_sets(chunk: WindowChunk, valid_mask: np.ndarray) -> None:
    """update_read_phase_set (assign_hap.c:322-339): each read takes the
    phase set of the first het valid var in its span (searchsorted over the
    het var index list instead of a per-read scan)."""
    cand = chunk.cand_vars
    hc = cand.hap_cons_alle
    het = valid_mask & (hc[:, 1] != -1) & (hc[:, 2] != -1) \
        & (hc[:, 1] != hc[:, 2])
    het_idx = np.nonzero(het)[0]
    for ri in chunk.order:
        if chunk.digars[ri] is None:
            continue
        p_start = int(chunk.read_start_var[ri])
        if p_start < 0:
            continue
        k = int(np.searchsorted(het_idx, p_start))
        if k < len(het_idx) and het_idx[k] <= chunk.read_end_var[ri]:
            chunk.phase_sets[ri] = int(cand.phase_set[het_idx[k]])
        else:
            chunk.phase_sets[ri] = -1


def seed_sweep(opt: CallOpts, chunk: WindowChunk, valid_idx: np.ndarray,
               target_cate: int) -> None:
    """Seeded outward sweep (assign_hap.c:496-527): per var in outward
    order, score-and-assign every still-unassigned covering read, folding
    each assignment into profiles and consensus before the next read."""
    init_j = select_init_var(chunk, valid_idx)
    if init_j == -1:
        return
    sweep = [init_j] + list(range(init_j - 1, -1, -1)) \
        + list(range(init_j + 1, len(valid_idx)))
    for j in sweep:
        vi = int(valid_idx[j])
        c = int(chunk.var_cate[vi])
        if c in (config.NOISY_CAND_HOM_VAR, config.CLEAN_HOM_VAR):
            continue
        for read_i in _reads_covering_var(chunk, vi):
            if chunk.haps[read_i] != 0:
                continue
            hap = assign_read_hap(chunk, read_i, target_cate)
            if hap == -1:
                hap = 1
            chunk.haps[read_i] = hap
            _apply_read_to_profiles(opt, chunk, read_i, hap, target_cate,
                                    update_cons=True)


def assign_haplotypes(opt: CallOpts, chunk: WindowChunk,
                      target_cate: int) -> None:
    """Top-level phasing driver (assign_hap.c:473-547).

    The sequential seeded sweep always runs on host (each assignment feeds
    the next read's consensus — O(reads), cheap).  With ``use_device`` the
    O(reads x vars) fixpoint iterations then run as ONE device dispatch
    (longcalld_torch.ops.phase_kernel), bit-exact against the host loop
    below (tests/test_phase_kernel.py asserts equality on every real HiFi
    window)."""
    cand = chunk.cand_vars
    n_vars = len(cand)
    if n_vars == 0:
        return
    valid_mask = (chunk.var_cate & target_cate) != 0
    valid_idx = np.nonzero(valid_mask)[0]
    if len(valid_idx) == 0:
        return

    chunk.haps[:] = 0
    chunk.phase_sets[:] = -1
    init_var_hap_state(opt, chunk, valid_idx)
    _prepare_read_var_order(chunk)
    seed_sweep(opt, chunk, valid_idx, target_cate)

    done = False
    if getattr(opt, "use_device", False) and getattr(
            opt, "use_device_phase", True):
        from longcalld_torch.ops.phase_kernel import run_phase_kernel
        done = run_phase_kernel(opt, chunk, target_cate, valid_idx)
    if not done:
        for _ in range(10):
            changed1 = _iter_update_phase_set(chunk, valid_idx)
            changed2 = _iter_update_cons(opt, chunk, valid_idx, target_cate)
            if not changed1 and not changed2:
                break
    _update_read_phase_sets(chunk, valid_mask)
