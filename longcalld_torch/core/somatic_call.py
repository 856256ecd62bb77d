"""Somatic / mosaic variant calling from phased-read evidence.

Re-implements the reference's hard-filter stack
(assign_somatic_hap_based_on_phased_reads and helpers,
reference/src/assign_hap.c:549-1668, and collect_somatic_var,
reference/src/collect_var.c:2803-2895): phase-set/haplotype election
for each candidate, a per-alt-read feature vector (alt qual vs window
quartiles, distance to non-variant indel errors, dense-diff and long-clip
proximity, homopolymer-error reconstruction with HP-compression + WFA), and
the phased/unphased SNV and SV gates, followed by window-density read
tainting.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from longcalld_torch import config
from longcalld_torch.config import CallOpts
from longcalld_torch.core.align_screen import vntr_fuzzy_comp_seq
from longcalld_torch.core.chunk import WindowChunk
from longcalld_torch.core.te import te_info_for_gap
from longcalld_torch.io.bam import CDEL, CDIFF, CHARD_CLIP, CINS, CSOFT_CLIP
from longcalld_torch.ops.affine_align import align_affine2p
from longcalld_torch.utils.sdust import sdust_native


def median_int(vals: List[int]) -> int:
    """median_int (math_utils.c:31-42): lower-middle for even length."""
    if not vals:
        return 0
    s = sorted(vals)
    n = len(s)
    return s[n // 2 - 1] if n % 2 == 0 else s[n // 2]


def min_int(vals: List[int]) -> int:
    return min(vals) if vals else 0


@dataclasses.dataclass
class SomaticAux:
    """cand_somatic_var_aux_info_t analog."""
    is_low_comp: int = 0
    total_dp: int = 0
    hap_total_dp: int = 0
    hap_alt_dp: int = 0
    hap_ref_for_cov: int = 0
    hap_ref_rev_cov: int = 0
    hap_alt_for_cov: int = 0
    hap_alt_rev_cov: int = 0
    min_dis_to_var: int = 1 << 30
    alt_read_ids: List[int] = dataclasses.field(default_factory=list)
    alt_quals: List[int] = dataclasses.field(default_factory=list)
    win_low_qual: List[int] = dataclasses.field(default_factory=list)
    dis_to_indel_error: List[int] = dataclasses.field(default_factory=list)
    no_dense_diff: List[int] = dataclasses.field(default_factory=list)
    no_near_long_clipping: List[int] = dataclasses.field(default_factory=list)
    is_not_homopolymer_error: List[int] = dataclasses.field(default_factory=list)
    low_comp_reg_has_no_error: List[int] = dataclasses.field(default_factory=list)


def _reads_covering_var(chunk: WindowChunk, vi: int) -> List[int]:
    """Reads (chunk order) whose profile span contains var vi; the span
    arrays are cached per profile generation (invalidated whenever
    merge_var_profile swaps in new read_start_var arrays)."""
    cached = getattr(chunk, "_som_cov_cache", None)
    if cached is None or cached[0] is not chunk.read_start_var:
        order = np.asarray([ri for ri in chunk.order
                            if chunk.digars[ri] is not None], dtype=np.int64)
        cached = (chunk.read_start_var, order,
                  chunk.read_start_var[order], chunk.read_end_var[order])
        chunk._som_cov_cache = cached
    _, order, starts, ends = cached
    m = (starts >= 0) & (starts <= vi) & (ends >= vi)
    return [int(x) for x in order[m]]


def get_min_dis_to_var(chunk: WindowChunk, var_i: int) -> int:
    """Distance to the nearest germline candidate (assign_hap.c:634-648)."""
    cand = chunk.cand_vars
    cate = chunk.var_cate
    md = 1 << 30
    for i in range(var_i - 1, -1, -1):
        if (cate[i] & config.CAND_GERMLINE_VAR_CATE) == 0:
            continue
        md = min(md, int(cand.pos[var_i]) - int(cand.pos[i])
                 - int(cand.ref_len[i]))
        break
    for i in range(var_i + 1, len(cand)):
        if (cate[i] & config.CAND_GERMLINE_VAR_CATE) == 0:
            continue
        md = min(md, int(cand.pos[i]) - int(cand.pos[var_i])
                 - int(cand.ref_len[var_i]))
        break
    return md


def _get_read_win_low_qual(d, alt_qi: int) -> int:
    s = max(0, alt_qi - 3)
    e = min(alt_qi + 3, d.qlen - 1)
    return int(d.qual[s:e + 1].min()) if e >= s else 0


def _get_alt_qual(d, var_type: int, var_len: int, alt_qi: int) -> int:
    """get_alt_qual (assign_hap.c:1101-1106)."""
    def win_median(start: int, length: int) -> int:
        vals = []
        for i in range(length):
            p = start + i
            vals.append(int(d.qual[p]) if 0 <= p < d.qlen else 0)
        return median_int(vals)
    if var_type == CDIFF:
        return int(d.qual[alt_qi])
    if var_type == CINS:
        return win_median(alt_qi, var_len)
    return win_median(alt_qi - 1, 2)


def _digar_is_var(chunk: WindowChunk, var_i: int, pos: int, typ: int,
                  length: int) -> bool:
    """digar_is_var (assign_hap.c:696-718): the event corresponds to a
    germline/somatic candidate at this position."""
    cand = chunk.cand_vars
    cate = chunk.var_cate
    mask = config.CAND_GERMLINE_VAR_CATE | config.CAND_SOMATIC_VAR
    for i in range(var_i, len(cand)):
        if (cate[i] & mask) == 0:
            continue
        if (cand.type[i] == typ and pos == cand.pos[i]
                and (typ == CDIFF
                     or (typ == CINS and cand.alt_len[i] == length)
                     or (typ == CDEL and cand.ref_len[i] == length))):
            return True
        if cand.pos[i] > pos:
            break
    for i in range(var_i - 1, -1, -1):
        if (cate[i] & mask) == 0:
            continue
        if (cand.type[i] == typ and pos == cand.pos[i]
                and (typ == CDIFF
                     or (typ == CINS and cand.alt_len[i] == length)
                     or (typ == CDEL and cand.ref_len[i] == length))):
            return True
        if cand.pos[i] < pos:
            break
    return False


def _get_dis_to_seq_error(chunk: WindowChunk, var_i: int, d, alt_qi: int,
                          only_indel: bool) -> int:
    """get_dis_to_seq_error (assign_hap.c:722-736)."""
    dis = 10
    for k in range(len(d.pos)):
        t = int(d.type[k])
        if only_indel and t not in (CINS, CDEL):
            continue
        if not only_indel and t not in (CINS, CDEL, CDIFF):
            continue
        qi = int(d.qi[k])
        if alt_qi - qi > dis:
            continue
        if qi - alt_qi > dis:
            break
        if _digar_is_var(chunk, var_i, int(d.pos[k]), t, int(d.len[k])):
            continue
        dis = min(dis, abs(qi - alt_qi))
        if t == CINS:
            dis = min(dis, abs(qi + int(d.len[k]) - alt_qi))
    return dis


def _has_dense_diff(chunk: WindowChunk, var_i: int, d, alt_qi: int) -> bool:
    """has_dense_diff (assign_hap.c:1139-1176): >5 high-qual diffs within
    100 bp within 500 bp of the var."""
    win, max_diff, dis = 100, 5, 500
    cand = chunk.cand_vars
    var_pos = int(cand.pos[var_i])
    var_end = var_pos if cand.type[var_i] == CINS else \
        var_pos + int(cand.ref_len[var_i]) - 1
    m = d.var_mask() & ~d.low_qual
    pos = d.pos[m]
    pos = pos[(pos >= var_pos - win - dis) & (pos <= var_end + win + dis)]
    if len(pos) <= max_diff:
        return False
    return bool((pos[max_diff:] - pos[:-max_diff] <= win).any())


def _has_near_long_clipping(chunk: WindowChunk, var_i: int, d) -> bool:
    """has_near_long_clipping (assign_hap.c:1178-1198)."""
    dis, long_clip = 100, 100
    cand = chunk.cand_vars
    var_pos = int(cand.pos[var_i])
    var_end = var_pos if cand.type[var_i] == CINS else \
        var_pos + int(cand.ref_len[var_i]) - 1
    n = len(d.pos)
    for k, left in ((0, True), (n - 1, False)):
        if d.type[k] not in (CSOFT_CLIP, CHARD_CLIP):
            continue
        if d.len[k] < long_clip:
            continue
        if left and var_pos - int(d.pos[k]) <= dis:
            return True
        if not left and int(d.pos[k]) - var_end <= dis:
            return True
    return False


def _var_low_comp_reg(chunk: WindowChunk, var_i: int
                      ) -> Tuple[int, int, int]:
    """var_is_low_comp_reg (assign_hap.c:1112-1135): (flag, beg, end)."""
    cand = chunk.cand_vars
    if chunk.low_comp is None or len(chunk.low_comp) == 0:
        return 0, -1, -1
    pos = int(cand.pos[var_i])
    rl = int(cand.ref_len[var_i])
    idx = chunk.low_comp.overlap_indices(pos, pos + rl - 1)
    if len(idx):
        return (1, int(chunk.low_comp.starts[idx[0]]) + 1,
                int(chunk.low_comp.ends[idx[-1]]))
    flank = 5
    idx = chunk.low_comp.overlap_indices(pos - flank, pos + rl + flank - 1)
    if len(idx):
        return (2, int(chunk.low_comp.starts[idx[0]]) + 1 - flank,
                int(chunk.low_comp.ends[idx[-1]]) + flank)
    return 0, -1, -1


# ---------- homopolymer-error reconstruction ----------

def _is_1mer_hp(seq: np.ndarray, i: int) -> int:
    if i >= len(seq):
        return 0
    b0 = seq[i]
    n = 1
    for j in range(i + 1, len(seq)):
        if seq[j] != b0:
            break
        n += 1
    return n if n >= 3 else 0


def _is_2mer_hp(seq: np.ndarray, i: int) -> int:
    if i >= len(seq) - 1:
        return 0
    b0, b1 = seq[i], seq[i + 1]
    if b0 == b1:
        return 0
    n = 2
    j = i + 2
    while j + 1 < len(seq) + 1:
        if j >= len(seq) or seq[j] != b0:
            break
        if j + 1 >= len(seq) or seq[j + 1] != b1:
            break
        n += 2
        j += 2
    return n if n >= 6 else 0


def _hp_compress(seq: np.ndarray) -> Tuple[List[int], List[int]]:
    """get_hp_compressed_seq (assign_hap.c:903-926): 1-mer and 2-mer run
    compression; lengths negative-marked for 2-mers like the C."""
    out: List[int] = []
    lens: List[int] = []
    i = 0
    n = len(seq)
    while i < n:
        l2 = _is_2mer_hp(seq, i)
        if l2 > 0:
            out.append(int(seq[i]))
            out.append(int(seq[i + 1]))
            lens.append(-1)
            lens.append(l2)
            i += l2
            continue
        l1 = _is_1mer_hp(seq, i)
        if l1 > 0:
            out.append(int(seq[i]))
            lens.append(l1)
            i += l1
        else:
            out.append(int(seq[i]))
            lens.append(1)
            i += 1
    return out, lens


def _is_hp_compressed_match(s1: np.ndarray, s2: np.ndarray) -> bool:
    h1, l1 = _hp_compress(s1)
    h2, l2 = _hp_compress(s2)
    if len(h1) != len(h2) or len(h1) == 0:
        return False
    for a, b, la, lb in zip(h1, h2, l1, l2):
        if a != b or (la > 0 > lb) or (la < 0 < lb):
            return False
    return True


def _read_region_seq(opt: CallOpts, chunk: WindowChunk, read_i: int,
                     reg_beg: int, reg_end: int
                     ) -> Tuple[Optional[np.ndarray], bool]:
    """collect_noisy_read_info1 subset: the read bases spanning
    [reg_beg, reg_end] and whether it fully covers."""
    from longcalld_torch.core.consensus import collect_noisy_read_info
    from longcalld_torch.core.msa import BOTH_COVER
    info = collect_noisy_read_info(opt, chunk, reg_beg, reg_end, [read_i])
    full = (int(info.covers[0]) & BOTH_COVER) == BOTH_COVER
    return info.seqs[0], full


def _hap_seq(chunk: WindowChunk, hap: int, beg: int, end: int) -> np.ndarray:
    """Reference sequence with the hap's germline alt alleles spliced in
    (var_is_homopolymer_error body, assign_hap.c:1038-1062)."""
    cand = chunk.cand_vars
    cate = chunk.var_cate
    parts: List[np.ndarray] = []
    last = beg
    for i in range(len(cand)):
        if (cate[i] & config.CAND_GERMLINE_VAR_CATE) == 0:
            continue
        vp = int(cand.pos[i])
        ve = vp + int(cand.ref_len[i]) - 1
        if vp < beg:
            continue
        if ve > end:
            break
        if cand.hap_cons_alle is None or cand.hap_cons_alle[i, hap] != 1:
            continue
        if ve + 1 > last:
            parts.append(chunk.ref4_slice(last, vp - last))
            parts.append(np.frombuffer(cand.alt_seqs[i], dtype=np.uint8))
            last = ve + 1
    parts.append(chunk.ref4_slice(last, end - last + 1))
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)


def var_is_homopolymer_error(opt: CallOpts, chunk: WindowChunk, hap: int,
                             read_i: int, low_beg: int, low_end: int,
                             var_pos: int) -> bool:
    """var_is_homopolymer_error (assign_hap.c:1012-1084)."""
    reg_beg = low_beg - opt.noisy_reg_flank_len
    reg_end = low_end + opt.noisy_reg_flank_len
    read_seq, full = _read_region_seq(opt, chunk, read_i, reg_beg, reg_end)
    if not full:
        return True
    hap_seq = _hap_seq(chunk, hap, reg_beg, reg_end)
    if _is_hp_compressed_match(read_seq, hap_seq):
        return True
    # alignment agreement test: does the read align the var position the
    # same way against the haplotype sequence and the raw reference?
    ref_seq = chunk.ref4_slice(reg_beg, reg_end - reg_beg + 1)
    alt_ref_pos = var_pos - reg_beg
    hap_res = align_affine2p(hap_seq, read_seq, opt.mismatch, opt.gap_open1,
                             opt.gap_ext1, opt.gap_open2, opt.gap_ext2,
                             left_align=(opt.gap_aln == 1))
    ref_res = align_affine2p(ref_seq, read_seq, opt.mismatch, opt.gap_open1,
                             opt.gap_ext1, opt.gap_open2, opt.gap_ext2,
                             left_align=(opt.gap_aln == 1))
    ref_aln, read_ref_aln = ref_res.pattern_alg, ref_res.text_alg
    hap_aln, read_hap_aln = hap_res.pattern_alg, hap_res.text_alg
    ref_i = -1
    alt_read_pos = -1
    for i in range(len(ref_aln)):
        if ref_aln[i] != 5:
            ref_i += 1
        if ref_i == alt_ref_pos:
            alt_read_pos = i
            break
    hap_i = -1
    read_i2 = -1
    for i in range(len(hap_aln)):
        if read_hap_aln[i] != 5:
            read_i2 += 1
        if read_i2 == alt_read_pos:
            hap_i = i
            break
    if hap_i < 0 or ref_i < 0:
        return True
    return bool(hap_aln[hap_i] != ref_aln[alt_read_pos])


def _var_low_comp_reg_has_error(chunk: WindowChunk, var_i: int, d,
                                low_beg: int, low_end: int) -> bool:
    """var_low_comp_reg_has_error (assign_hap.c:956-970)."""
    m = d.var_mask()
    for k in np.nonzero(m)[0]:
        end = int(d.pos[k])
        if d.type[k] == CDEL:
            end += int(d.len[k]) - 1
        if end < low_beg:
            continue
        if d.pos[k] > low_end:
            break
        if _digar_is_var(chunk, var_i, int(d.pos[k]), int(d.type[k]),
                         int(d.len[k])):
            continue
        return True
    return False


def collect_somatic_aux(opt: CallOpts, chunk: WindowChunk, ps: int,
                        alt_hap: int, var_i: int,
                        cover_reads: List[int]) -> SomaticAux:
    """collect_somatic_var_aux_info (assign_hap.c:1201-1250)."""
    cand = chunk.cand_vars
    aux = SomaticAux()
    flag, low_beg, low_end = _var_low_comp_reg(chunk, var_i)
    aux.is_low_comp = flag
    aux.min_dis_to_var = get_min_dis_to_var(chunk, var_i)
    var_pos = int(cand.pos[var_i])
    var_type = int(cand.type[var_i])
    for read_i in cover_reads:
        aux.total_dp += 1
        hap = int(chunk.haps[read_i])
        read_ps = int(chunk.phase_sets[read_i])
        if ps != -1 and alt_hap != 0:
            if hap != alt_hap or read_ps != ps:
                continue
        allele = int(chunk.alleles[read_i, var_i])
        alt_qi = int(chunk.alt_qi[read_i, var_i])
        d = chunk.digars[read_i]
        aux.hap_total_dp += 1
        if allele == 1 and alt_qi != -1:
            if d.is_rev:
                aux.hap_alt_rev_cov += 1
            else:
                aux.hap_alt_for_cov += 1
            aux.alt_read_ids.append(read_i)
            aux.hap_alt_dp += 1
            aux.alt_quals.append(_get_alt_qual(d, var_type,
                                               int(cand.alt_len[var_i]),
                                               alt_qi))
            aux.win_low_qual.append(_get_read_win_low_qual(d, alt_qi))
            aux.dis_to_indel_error.append(
                _get_dis_to_seq_error(chunk, var_i, d, alt_qi, True))
            aux.no_dense_diff.append(
                0 if _has_dense_diff(chunk, var_i, d, alt_qi) else 1)
            aux.no_near_long_clipping.append(
                0 if _has_near_long_clipping(chunk, var_i, d) else 1)
            if var_type == CDIFF:
                if flag > 0:
                    lb, le = low_beg, low_end
                    if low_end - low_beg + 1 > 50:
                        lb = max(low_beg, var_pos - 25)
                        le = min(low_end,
                                 var_pos + int(cand.ref_len[var_i]) - 1 + 25)
                    hp_err = var_is_homopolymer_error(opt, chunk, hap, read_i,
                                                      lb, le, var_pos)
                else:
                    hp_err = var_is_homopolymer_error(
                        opt, chunk, hap, read_i, var_pos,
                        var_pos + int(cand.ref_len[var_i]) - 1, var_pos)
                aux.is_not_homopolymer_error.append(0 if hp_err else 1)
            else:
                aux.is_not_homopolymer_error.append(1)
            if flag == 1:
                aux.low_comp_reg_has_no_error.append(
                    0 if _var_low_comp_reg_has_error(chunk, var_i, d,
                                                     low_beg, low_end) else 1)
            else:
                aux.low_comp_reg_has_no_error.append(1)
        else:
            if d.is_rev:
                aux.hap_ref_rev_cov += 1
            else:
                aux.hap_ref_for_cov += 1
    return aux


# ---------- germline dedup / TE / low-complexity tests ----------

def _vntr_fuzzy_comp_var(opt: CallOpts, chunk: WindowChunk, i: int,
                         j: int) -> int:
    cand = chunk.cand_vars
    t1, t2 = int(cand.type[i]), int(cand.type[j])
    if t1 == CDEL and t2 == CDEL:
        l1, l2 = int(cand.ref_len[i]), int(cand.ref_len[j])
        if min(l1, l2) < max(l1, l2) * 0.8:
            return 1
        s1 = chunk.ref4_slice(int(cand.pos[i]), l1)
        s2 = chunk.ref4_slice(int(cand.pos[j]), l2)
        return vntr_fuzzy_comp_seq(s1, s2)
    if t1 == CINS and t2 == CINS:
        l1, l2 = int(cand.alt_len[i]), int(cand.alt_len[j])
        if min(l1, l2) < max(l1, l2) * 0.8:
            return 1
        return vntr_fuzzy_comp_seq(
            np.frombuffer(cand.alt_seqs[i], dtype=np.uint8),
            np.frombuffer(cand.alt_seqs[j], dtype=np.uint8))
    return 1


def _diff_ins_seq(opt: CallOpts, large: np.ndarray,
                  small: np.ndarray) -> np.ndarray:
    """wfa_collect_diff_ins_seq (align.c:463-492): the largest inserted
    block of large vs small."""
    res = align_affine2p(large, small, opt.mismatch, opt.gap_open1,
                         opt.gap_ext1, opt.gap_open2, opt.gap_ext2,
                         left_align=(opt.gap_aln == 1))
    la, sa = res.pattern_alg, res.text_alg
    best_len, best_at = 0, -1
    i = 0
    L = len(la)
    while i < L:
        if sa[i] == 5 and la[i] != 5:
            j = i
            while j < L and sa[j] == 5 and la[j] != 5:
                j += 1
            if j - i > best_len:
                best_len, best_at = j - i, i
            i = j
        else:
            i += 1
    if best_len == 0:
        return np.zeros(0, dtype=np.uint8)
    return la[best_at:best_at + best_len].copy()


def _low_comp_ins_comp(opt: CallOpts, chunk: WindowChunk, large_i: int,
                       small_j: int) -> bool:
    cand = chunk.cand_vars
    if cand.type[large_i] != CINS or cand.type[small_j] != CINS:
        return False
    if cand.alt_len[large_i] < cand.alt_len[small_j]:
        return False
    diff = _diff_ins_seq(opt,
                         np.frombuffer(cand.alt_seqs[large_i], np.uint8),
                         np.frombuffer(cand.alt_seqs[small_j], np.uint8))
    if len(diff) == 0:
        return False
    low = sum(e - s for s, e in sdust_native(diff, config.SDUST_T,
                                             config.SDUST_W))
    return low > len(diff) * 0.8


def var_is_germline(opt: CallOpts, chunk: WindowChunk, var_i: int) -> bool:
    """var_is_germline (assign_hap.c:1297-1342)."""
    cand = chunk.cand_vars
    cate = chunk.var_cate
    t = int(cand.type[var_i])
    var_beg = int(cand.pos[var_i])
    if t == CDEL:
        var_len = int(cand.ref_len[var_i])
        var_end = var_beg + var_len - 1
    else:
        var_len = int(cand.alt_len[var_i])
        var_end = var_beg
    var_win = max(500, var_len)
    for i in range(var_i + 1, len(cand)):
        if (cate[i] & config.CAND_GERMLINE_VAR_CATE) == 0:
            continue
        if int(cand.pos[i]) - var_end > var_win:
            break
        if _vntr_fuzzy_comp_var(opt, chunk, var_i, i) == 0:
            return True
    for i in range(var_i - 1, -1, -1):
        if (cate[i] & config.CAND_GERMLINE_VAR_CATE) == 0:
            continue
        other_end = int(cand.pos[i])
        if t == CDEL:
            other_end += int(cand.ref_len[i]) - 1
        if var_beg - other_end > var_win:
            break
        if _vntr_fuzzy_comp_var(opt, chunk, var_i, i) == 0:
            return True
    var_win = 50
    for i in range(var_i + 1, len(cand)):
        if (cate[i] & config.CAND_GERMLINE_VAR_CATE) == 0:
            continue
        if int(cand.pos[i]) - var_end > var_win:
            break
        if _low_comp_ins_comp(opt, chunk, var_i, i):
            return True
    for i in range(var_i - 1, -1, -1):
        if (cate[i] & config.CAND_GERMLINE_VAR_CATE) == 0:
            continue
        other_end = int(cand.pos[i])
        if t == CDEL:
            other_end += int(cand.ref_len[i]) - 1
        if var_beg - other_end > var_win:
            break
        if _low_comp_ins_comp(opt, chunk, var_i, i):
            return True
    return False


def sv_is_te(chunk: WindowChunk, var_i: int) -> bool:
    """sv_is_te (assign_hap.c:1344-1353): >=2 of {TSD>=5, |polyA|>=20, TE
    family hit}."""
    te = _var_te(chunk, var_i)
    n = 0
    if te is not None:
        if te.tsd_len >= 5:
            n += 1
        if abs(te.polya_len) >= 20:
            n += 1
        if te.te_seq_i >= 0:
            n += 1
    return n >= 2


def _var_te(chunk: WindowChunk, var_i: int):
    te_list = getattr(chunk, "var_te_info", None)
    if te_list is not None and var_i < len(te_list):
        return te_list[var_i]
    return None


def _somatic_var_seq_is_low_comp(chunk: WindowChunk, var_i: int) -> bool:
    """somatic_var_seq_is_low_comp (assign_hap.c:1355-1379)."""
    cand = chunk.cand_vars
    t = int(cand.type[var_i])
    if t == CDIFF:
        return False
    if t == CINS:
        seq = np.frombuffer(cand.alt_seqs[var_i], dtype=np.uint8)
    else:
        seq = chunk.ref4_slice(int(cand.pos[var_i]), int(cand.ref_len[var_i]))
    te = _var_te(chunk, var_i)
    if te is not None and te.tsd_len > 0 and abs(te.polya_len) > 0:
        if te.tsd_len + abs(te.polya_len) > len(seq) * 0.8:
            return True
    low = sum(e - s for s, e in sdust_native(seq, config.SDUST_T,
                                             config.SDUST_W))
    return low > len(seq) * 0.8


# ---------- the gates ----------

def phased_sv_is_somatic(opt: CallOpts, chunk: WindowChunk, var_i: int,
                         aux: SomaticAux) -> bool:
    cand = chunk.cand_vars
    if int(cand.alle_covs[var_i, 1]) < opt.min_somatic_alt_dp:
        if (int(cand.alle_covs[var_i, 1]) < opt.min_somatic_te_dp
                or not sv_is_te(chunk, var_i)):
            return False
    if var_is_germline(opt, chunk, var_i):
        return False
    if (int(cand.alle_covs[var_i, 1]) == 1
            and _somatic_var_seq_is_low_comp(chunk, var_i)):
        return False
    if median_int(aux.no_dense_diff) == 0:
        return False
    if median_int(aux.no_near_long_clipping) == 0:
        return False
    return True


def _snv_gate(opt: CallOpts, chunk: WindowChunk, aux: SomaticAux,
              qual_thresh: int, win_thresh: int) -> bool:
    if aux.hap_alt_dp < opt.min_somatic_alt_dp:
        return False
    if opt.is_ont and (aux.hap_alt_for_cov == 0 or aux.hap_alt_rev_cov == 0):
        return False
    if aux.min_dis_to_var < opt.min_somatic_dis_to_var:
        return False
    if median_int(aux.alt_quals) < qual_thresh:
        return False
    if median_int(aux.win_low_qual) < win_thresh:
        return False
    if median_int(aux.dis_to_indel_error) < opt.min_somatic_dis_to_seq_error:
        return False
    if median_int(aux.no_dense_diff) == 0:
        return False
    if median_int(aux.no_near_long_clipping) == 0:
        return False
    if min_int(aux.low_comp_reg_has_no_error) == 0:
        return False
    if min_int(aux.is_not_homopolymer_error) == 0:
        return False
    return True


def phased_var_is_somatic(opt: CallOpts, chunk: WindowChunk, var_i: int,
                          aux: SomaticAux) -> bool:
    if chunk.cand_vars.type[var_i] == CDIFF:
        return _snv_gate(opt, chunk, aux, chunk.median_qual,
                         chunk.first_quar_qual)
    return phased_sv_is_somatic(opt, chunk, var_i, aux)


def no_phase_var_is_somatic(opt: CallOpts, chunk: WindowChunk, var_i: int,
                            aux: SomaticAux) -> bool:
    if chunk.cand_vars.type[var_i] == CDIFF:
        return _snv_gate(opt, chunk, aux, chunk.third_quar_qual,
                         chunk.median_qual)
    return phased_sv_is_somatic(opt, chunk, var_i, aux)


# ---------- phase-set election + driver ----------

def select_somatic_ps_hap(opt: CallOpts, chunk: WindowChunk, var_i: int
                          ) -> Tuple[int, int, Optional[SomaticAux]]:
    """select_somatic_phase_set_alt_hap (assign_hap.c:1583-1641):
    returns (phase_set, alt_hap, aux)."""
    cover_reads = _reads_covering_var(chunk, var_i)
    ps_list: List[int] = []
    prof: List[np.ndarray] = []
    for read_i in cover_reads:
        hap = int(chunk.haps[read_i])
        read_ps = int(chunk.phase_sets[read_i])
        if hap == 0 or read_ps == -1:
            continue
        allele = int(chunk.alleles[read_i, var_i])
        if allele != 1:
            allele = 0
        if read_ps in ps_list:
            pi = ps_list.index(read_ps)
        else:
            ps_list.append(read_ps)
            prof.append(np.zeros((3, 2), dtype=np.int64))
            pi = len(ps_list) - 1
        prof[pi][hap, allele] += 1
    # deepest-first; pick PS where alt sits on exactly one hap with
    # alt <= ref and hap depth >= min (select_somatic_phase_set0)
    order = sorted(range(len(ps_list)),
                   key=lambda i: -int(prof[i][1:].sum()))
    chosen = -1
    for pi in order:
        n_hap_alt = n_valid = 0
        for hap in (1, 2):
            n_alt = int(prof[pi][hap, 1])
            n_ref = int(prof[pi][hap, 0])
            if n_alt > 0:
                n_hap_alt += 1
                if n_alt <= n_ref and n_alt + n_ref >= opt.min_somatic_hap_dp:
                    n_valid += 1
        if n_hap_alt == 1 and n_valid == 1:
            chosen = pi
            break
    if chosen >= 0:
        ps = ps_list[chosen]
        alt_hap = 0
        for hap in (1, 2):
            if prof[chosen][hap, 1]:
                alt_hap = 0 if alt_hap != 0 else hap
        if alt_hap != 0:
            aux = collect_somatic_aux(opt, chunk, ps, alt_hap, var_i,
                                      cover_reads)
            if phased_var_is_somatic(opt, chunk, var_i, aux):
                return ps, alt_hap, aux
            return -1, 0, aux
        return -1, 0, None
    # no usable phase set: count-based, ignore phasing
    aux = collect_somatic_aux(opt, chunk, -1, -1, var_i, cover_reads)
    if no_phase_var_is_somatic(opt, chunk, var_i, aux):
        return 0, 0, aux
    return -1, 0, aux


def mark_invalid_somatic_reads(opt: CallOpts, chunk: WindowChunk) -> None:
    """mark_invalid_somatic_reads (collect_var.c:2803-2849): reads with >=2
    clean-SNP phase conflicts are tainted."""
    for ri in chunk.order:
        if chunk.digars[ri] is None:
            continue
        if chunk.n_clean_conflict_snps[ri] >= 2:
            chunk.is_skipped_for_somatic[ri] = 1


def collect_somatic_var(opt: CallOpts, chunk: WindowChunk) -> None:
    """collect_somatic_var (collect_var.c:2857-2895) + the phased-evidence
    assignment (assign_hap.c:1643-1668)."""
    from longcalld_torch.core.somatic import var_is_cand_somatic
    mark_invalid_somatic_reads(opt, chunk)
    cand = chunk.cand_vars
    cate = chunk.var_cate
    if cand is None or len(cand) == 0:
        return
    # refCall germline promotion
    for var_i in range(len(cand)):
        c = int(cate[var_i])
        if (c & config.CAND_GERMLINE_VAR_CATE) and cand.hap_cons_alle is not None:
            if (cand.hap_cons_alle[var_i, 1] == 0
                    and cand.hap_cons_alle[var_i, 2] == 0
                    and var_is_cand_somatic(chunk, opt, cand, var_i)):
                cate[var_i] = config.CAND_SOMATIC_VAR
    # per-candidate election + gates
    aux_store = {}
    if cand.hap_cons_alle is None:
        cand.hap_cons_alle = np.full((len(cand), 3), -1, dtype=np.int8)
        cand.hap_profile = np.zeros((len(cand), 3, 2), dtype=np.int32)
        cand.phase_set = np.zeros(len(cand), dtype=np.int64)
    for var_i in range(len(cand)):
        if cate[var_i] != config.CAND_SOMATIC_VAR:
            continue
        ps, alt_hap, aux = select_somatic_ps_hap(opt, chunk, var_i)
        if aux is not None:
            aux_store[var_i] = aux
        if ps > 0 and alt_hap != 0:
            cand.phase_set[var_i] = ps
            cand.hap_cons_alle[var_i, alt_hap] = 1
            cand.hap_cons_alle[var_i, 3 - alt_hap] = 0
        elif ps == 0:
            cand.phase_set[var_i] = 0
            cand.hap_cons_alle[var_i, 2] = 1
            cand.hap_cons_alle[var_i, 1] = 0
        else:
            cand.phase_set[var_i] = -1
            cand.hap_cons_alle[var_i, 1] = 0
            cand.hap_cons_alle[var_i, 2] = 0
    chunk.somatic_aux = aux_store
    _post_process(opt, chunk, aux_store)


def _post_process(opt: CallOpts, chunk: WindowChunk, aux_store) -> None:
    """post_process_somatic_vars (assign_hap.c:1501-1575): window-density
    taint + majority-invalid-read demotion."""
    cand = chunk.cand_vars
    cate = chunk.var_cate
    somatic = []
    for var_i in range(len(cand)):
        if cate[var_i] != config.CAND_SOMATIC_VAR:
            continue
        if (cand.hap_cons_alle[var_i, 1] == 0
                and cand.hap_cons_alle[var_i, 2] == 0):
            continue
        somatic.append(var_i)
    # density: >somatic_win_max_vars in somatic_win bp taints covering reads
    invalid = set()
    k = opt.somatic_win_max_vars
    for a in range(len(somatic) - k):
        b = a + k
        if (int(cand.pos[somatic[b]])
                - (int(cand.pos[somatic[a]])
                   + int(cand.ref_len[somatic[a]]) - 1)) < opt.somatic_win:
            invalid.update(somatic[a:b + 1])
    for var_i in invalid:
        for ri in _reads_covering_var(chunk, var_i):
            chunk.is_skipped_for_somatic[ri] = 1
    for var_i in somatic:
        aux = aux_store.get(var_i)
        if aux is None:
            continue
        n_bad = sum(1 for ri in aux.alt_read_ids
                    if chunk.is_skipped_for_somatic[ri])
        if n_bad * 2 >= max(aux.hap_alt_dp, 1):
            cand.phase_set[var_i] = -1
            cand.hap_cons_alle[var_i, 1] = 0
            cand.hap_cons_alle[var_i, 2] = 0
