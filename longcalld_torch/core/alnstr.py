"""Gap-padded alignment-string utilities (aln_str_t analog,
reference/src/collect_var.h:106-112).

Strings are uint8 arrays over 0-4 bases + 5 '-'; target/query begin/end mark
the valid sub-range for partially covering reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from longcalld_torch.config import CallOpts
from longcalld_torch.core.msa import (LEFT_GAP,
                                    RIGHT_COVER, RIGHT_GAP, is_both_cover,
                                    is_left_cover, is_right_cover)
from longcalld_torch.ops.affine_align import align_affine2p

GAP = 5


@dataclasses.dataclass
class AlnStr:
    target_aln: np.ndarray
    query_aln: np.ndarray
    target_beg: int = 0
    target_end: int = -1
    query_beg: int = 0
    query_end: int = -1

    @property
    def aln_len(self) -> int:
        return len(self.target_aln)


def empty_aln_str() -> AlnStr:
    z = np.zeros(0, dtype=np.uint8)
    return AlnStr(z, z, 0, -1, 0, -1)


def trim_aln_str(full_cover: int, s: AlnStr) -> None:
    """wfa_trim_aln_str (reference/src/align.c:496-562): for
    left/right-cover reads, clip the alignment past the last/first match and
    record query bounds."""
    not_cover = not (is_left_cover(full_cover) or is_right_cover(full_cover))
    if not_cover or is_both_cover(full_cover):
        return
    if ((is_left_cover(full_cover) and (full_cover & RIGHT_GAP))
            or (is_right_cover(full_cover) and (full_cover & LEFT_GAP))):
        s.target_beg = 0
        s.target_end = s.aln_len - 1
        s.query_beg = 0
        s.query_end = s.aln_len - 1
        return
    t, q = s.target_aln, s.query_aln
    if is_left_cover(full_cover):
        query_end = target_end = -1
        for i in range(s.aln_len - 1, -1, -1):
            if query_end == -1 and q[i] != GAP and t[i] == q[i]:
                query_end = i
            if target_end == -1 and t[i] != GAP:
                target_end = i
            if target_end != -1 and query_end != -1:
                break
        if query_end == -1:
            query_end = target_end
        s.target_aln = t[:target_end + 1]
        s.query_aln = q[:target_end + 1].copy()
        s.query_aln[query_end + 1:] = GAP
        s.target_beg, s.target_end = 0, target_end
        s.query_beg, s.query_end = 0, query_end
    else:  # right cover
        query_start = target_start = -1
        for i in range(s.aln_len):
            if query_start == -1 and q[i] != GAP and t[i] == q[i]:
                query_start = i
            if target_start == -1 and t[i] != GAP:
                target_start = i
            if target_start != -1 and query_start != -1:
                break
        if query_start == -1:
            query_start = target_start
        s.target_aln = t[target_start:]
        s.query_aln = q[target_start:].copy()
        new_len = len(s.target_aln)
        qb = query_start - target_start
        s.query_aln[:qb] = GAP
        s.target_beg, s.target_end = 0, new_len - 1
        s.query_beg, s.query_end = qb, new_len - 1


def wfa_aln_str(opt: CallOpts, target: np.ndarray, query: np.ndarray) -> AlnStr:
    """Full end-to-end alignment string pair (wfa_collect_aln_str both-cover
    path, align.c:569-573)."""
    res = align_affine2p(target, query, opt.mismatch, opt.gap_open1,
                         opt.gap_ext1, opt.gap_open2, opt.gap_ext2,
                         left_align=(opt.gap_aln == 1))
    L = len(res.pattern_alg)
    return AlnStr(res.pattern_alg, res.text_alg, 0, L - 1, 0, L - 1)


def cons_read_aln_from_msa(cons_row: np.ndarray, read_row: np.ndarray,
                           full_cover: int) -> AlnStr:
    """make_cons_read_aln_str (align.c:1029-1054): drop both-gap columns,
    then cover-trim."""
    keep = (cons_row != GAP) | (read_row != GAP)
    s = AlnStr(cons_row[keep].copy(), read_row[keep].copy())
    s.target_beg, s.target_end = 0, s.aln_len - 1
    s.query_beg, s.query_end = 0, s.aln_len - 1
    trim_aln_str(full_cover, s)
    return s


def ref_read_aln_from_pair(opt: CallOpts, ref_cons: AlnStr,
                           cons_read: AlnStr) -> AlnStr:
    """make_ref_read_aln_str (align.c:1056-1146): transitive composition of
    ref<->cons and cons<->read alignment strings, re-aligning double-gap
    stretches with WFA.

    Both inputs index the same consensus (rc query / cr target), so the
    column walk synchronizes on consensus bases: runs of paired bases copy
    as slices, and only gap boundaries (one-sided streams or double-gap
    WFA patches) need per-run handling.  The suffix past the last paired
    base keeps the sequential oracle (_compose_cols) — equality with the
    pure column walk is asserted on real data in
    tests/test_refine_vectorized.py."""
    rc_t, rc_q = ref_cons.target_aln, ref_cons.query_aln
    cr_t, cr_q = cons_read.target_aln, cons_read.query_aln
    nb_i = np.nonzero(rc_q != GAP)[0]
    nb_j = np.nonzero(cr_t != GAP)[0]
    K = min(len(nb_i), len(nb_j))
    t_out: list = []
    q_out: list = []
    if K:
        start_i = np.concatenate([[0], nb_i[:K - 1] + 1])
        end_i = nb_i[:K]
        start_j = np.concatenate([[0], nb_j[:K - 1] + 1])
        end_j = nb_j[:K]
        ri = end_i - start_i
        rj = end_j - start_j
        active = np.nonzero((ri > 0) | (rj > 0))[0]
        prev = 0
        for k in active:
            k = int(k)
            if k > prev:
                t_out.append(rc_t[nb_i[prev]:nb_i[k - 1] + 1])
                q_out.append(cr_q[nb_j[prev]:nb_j[k - 1] + 1])
            if ri[k] and rj[k]:
                sub = align_affine2p(
                    rc_t[start_i[k]:end_i[k]], cr_q[start_j[k]:end_j[k]],
                    opt.mismatch, opt.gap_open1, opt.gap_ext1,
                    opt.gap_open2, opt.gap_ext2,
                    left_align=(opt.gap_aln == 1))
                t_out.append(sub.pattern_alg)
                q_out.append(sub.text_alg)
            elif ri[k]:
                t_out.append(rc_t[start_i[k]:end_i[k]])
                q_out.append(np.full(int(ri[k]), GAP, dtype=np.uint8))
            else:
                t_out.append(np.full(int(rj[k]), GAP, dtype=np.uint8))
                q_out.append(cr_q[start_j[k]:end_j[k]])
            prev = k
        t_out.append(rc_t[nb_i[prev]:nb_i[K - 1] + 1])
        q_out.append(cr_q[nb_j[prev]:nb_j[K - 1] + 1])
        i0 = int(nb_i[K - 1]) + 1
        j0 = int(nb_j[K - 1]) + 1
    else:
        i0 = j0 = 0
    _compose_cols(opt, rc_t[i0:], rc_q[i0:], cr_t[j0:], cr_q[j0:],
                  t_out, q_out)
    t = np.concatenate(t_out) if t_out else np.zeros(0, dtype=np.uint8)
    q = np.concatenate(q_out) if q_out else np.zeros(0, dtype=np.uint8)
    return AlnStr(t, q, -1, -1, -1, -1)


def _compose_cols(opt: CallOpts, rc_t, rc_q, cr_t, cr_q,
                  t_out: list, q_out: list) -> None:
    """The sequential column walk of make_ref_read_aln_str
    (align.c:1056-1146), appending to the output segment lists."""
    i = j = 0
    n_i, n_j = len(rc_t), len(cr_t)
    while i < n_i and j < n_j:
        if rc_q[i] == GAP and cr_t[j] == GAP:
            ref_del = 1
            while i + ref_del < n_i and rc_q[i + ref_del] == GAP:
                ref_del += 1
            read_del = 1
            while j + read_del < n_j and cr_t[j + read_del] == GAP:
                read_del += 1
            sub = align_affine2p(rc_t[i:i + ref_del], cr_q[j:j + read_del],
                                 opt.mismatch, opt.gap_open1, opt.gap_ext1,
                                 opt.gap_open2, opt.gap_ext2,
                                 left_align=(opt.gap_aln == 1))
            t_out.append(sub.pattern_alg)
            q_out.append(sub.text_alg)
            i += ref_del
            j += read_del
        elif rc_q[i] != GAP and cr_t[j] != GAP:
            t_out.append(rc_t[i:i + 1])
            q_out.append(cr_q[j:j + 1])
            i += 1
            j += 1
        elif rc_q[i] == GAP:
            t_out.append(rc_t[i:i + 1])
            q_out.append(np.array([GAP], dtype=np.uint8))
            i += 1
        else:
            t_out.append(np.array([GAP], dtype=np.uint8))
            q_out.append(cr_q[j:j + 1])
            j += 1
    if i < n_i:
        t_out.append(rc_t[i:])
        q_out.append(np.full(n_i - i, GAP, dtype=np.uint8))
    if j < n_j:
        t_out.append(np.full(n_j - j, GAP, dtype=np.uint8))
        q_out.append(cr_q[j:])
