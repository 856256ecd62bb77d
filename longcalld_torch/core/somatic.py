"""Somatic / mosaic candidate handling (clean-region part).

Re-implements var_is_cand_somatic and merge_clean_somatic_vars
(reference/src/collect_var.c:793-892).  The full phased-evidence
somatic filter stack (assign_hap.c:549-1668) lands with the mosaic mode.
"""

from __future__ import annotations

import numpy as np

from longcalld_torch import config
from longcalld_torch.config import CallOpts
from longcalld_torch.core.chunk import WindowChunk
from longcalld_torch.core.sites import CandVars
from longcalld_torch.io.bam import CDEL, CDIFF, CINS


def collect_te_info_from_var(opt: CallOpts, chunk: WindowChunk,
                             cand: CandVars, i: int) -> int:
    """TSD / polyA annotation for a >=min_sv_len indel; returns TSD length
    and caches the full TeInfo on chunk.var_te_info
    (collect_te_info_from_var, reference/src/align.c:87-132)."""
    from longcalld_torch.core.te import NO_TE, te_info_for_gap
    t = int(cand.type[i])
    if t == CINS:
        if int(cand.alt_len[i]) < opt.min_sv_len:
            return 0
        gap_len = int(cand.alt_len[i])
        gap_seq = np.frombuffer(cand.alt_seqs[i], dtype=np.uint8)
    elif t == CDEL:
        if int(cand.ref_len[i]) < opt.min_sv_len:
            return 0
        gap_len = int(cand.ref_len[i])
        gap_seq = None
    else:
        return 0
    # the reference caches TeInfo per cand_var_t; the window-level list on
    # chunk is only valid for chunk.cand_vars — region/read-local CandVars
    # (the noisy somatic miner) carry their own cache
    if cand is chunk.cand_vars:
        te_list = getattr(chunk, "var_te_info", None)
        if te_list is None or len(te_list) != len(cand):
            te_list = [None] * len(cand)
            chunk.var_te_info = te_list
    else:
        te_list = getattr(cand, "_te_info", None)
        if te_list is None or len(te_list) != len(cand):
            te_list = [None] * len(cand)
            cand._te_info = te_list
    if te_list[i] is None or te_list[i] is NO_TE:
        te_list[i] = te_info_for_gap(opt, chunk, t, int(cand.pos[i]),
                                     gap_seq, gap_len,
                                     getattr(opt, "_te_index", None))
    return te_list[i].tsd_len


def var_is_cand_somatic(chunk: WindowChunk, opt: CallOpts, cand: CandVars,
                        i: int) -> bool:
    """var_is_cand_somatic (collect_var.c:796-811)."""
    t = int(cand.type[i])
    alt_cov = int(cand.alle_covs[i, 1])
    if t == CDIFF:
        return alt_cov >= opt.min_somatic_alt_dp
    tsd_len = collect_te_info_from_var(opt, chunk, cand, i)
    if (int(cand.alt_len[i]) >= opt.min_sv_len
            or int(cand.ref_len[i]) >= opt.min_sv_len):
        if alt_cov >= opt.min_somatic_alt_dp:
            return True
        if t == CINS and alt_cov >= opt.min_somatic_te_dp and tsd_len > 0:
            return True
    return False


def merge_clean_somatic_vars(opt: CallOpts, cand: CandVars,
                             cate: np.ndarray) -> None:
    """Fuzzy-merge overlapping somatic SV candidates
    (merge_clean_somatic_vars, collect_var.c:816-892)."""
    somatic_idx = np.nonzero(cate == config.CAND_SOMATIC_VAR)[0]
    if len(somatic_idx) == 0:
        return
    from longcalld_torch.core.align_screen import vntr_fuzzy_comp_seq
    for a_i in range(len(somatic_idx) - 1):
        vi = int(somatic_idx[a_i])
        if cate[vi] != config.CAND_SOMATIC_VAR:
            continue
        for b_i in range(a_i + 1, len(somatic_idx)):
            vj = int(somatic_idx[b_i])
            if cate[vi] != config.CAND_SOMATIC_VAR:
                break
            if cate[vj] != config.CAND_SOMATIC_VAR:
                continue
            comp = -1
            ti, tj = int(cand.type[vi]), int(cand.type[vj])
            if ti == CINS and tj == CINS:
                min_alt = min(int(cand.alt_len[vi]), int(cand.alt_len[vj]))
                if min_alt >= abs(int(cand.pos[vi]) - int(cand.pos[vj])):
                    mn = min(int(cand.alt_len[vi]), int(cand.alt_len[vj]))
                    mx = max(int(cand.alt_len[vi]), int(cand.alt_len[vj]))
                    if mn >= mx * 0.8 and vntr_fuzzy_comp_seq(
                            np.frombuffer(cand.alt_seqs[vi], dtype=np.uint8),
                            np.frombuffer(cand.alt_seqs[vj], dtype=np.uint8)) == 0:
                        comp = 0
            elif ti == CDEL and tj == CDEL:
                min_end = min(int(cand.pos[vi]) + int(cand.ref_len[vi]),
                              int(cand.pos[vj]) + int(cand.ref_len[vj]))
                max_beg = max(int(cand.pos[vi]), int(cand.pos[vj]))
                if min_end >= max_beg:
                    mn = min(int(cand.ref_len[vi]), int(cand.ref_len[vj]))
                    mx = max(int(cand.ref_len[vi]), int(cand.ref_len[vj]))
                    if mn >= mx * 0.8:
                        comp = 0
            if comp == 0:
                if cand.alle_covs[vj, 1] > cand.alle_covs[vi, 1]:
                    cate[vi] = config.NON_VAR
                else:
                    cate[vj] = config.NON_VAR
                cand.total_cov[vi] = max(int(cand.total_cov[vi]),
                                         int(cand.total_cov[vj]))
