"""Noisy-region re-assembly: consensus, re-alignment, variant extraction.

Re-implements collect_noisy_vars1 (reference/src/collect_var.c:
2648-2741) and collect_noisy_reg_aln_strs (reference/src/align.c:
1760-1813): per noisy region, gather covering reads with 4-state cover flags,
pick the densest phase set with both haplotypes supported, build per-hap (or
2-cluster) consensus via the star MSA, align ref<->cons, derive variants from
the alignment strings and merge them (with per-read allele profiles) into the
window state.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np

from longcalld_torch import config
from longcalld_torch.config import CallOpts
from longcalld_torch.core import msa as msa_mod
from longcalld_torch.core.alnstr import (AlnStr, cons_read_aln_from_msa,
                                       ref_read_aln_from_pair, trim_aln_str,
                                       wfa_aln_str)
from longcalld_torch.core.chunk import WindowChunk
from longcalld_torch.core.msa import (GAP, LEFT_COVER, LEFT_GAP,
                                    RIGHT_COVER, RIGHT_GAP, MsaResult,
                                    is_both_cover, star_msa)
from longcalld_torch.core.sites import CandVars
from longcalld_torch.core.te import NO_TE, TeInfo, te_info_for_gap
from longcalld_torch.io.bam import CDEL, CDIFF, CEQUAL, CHARD_CLIP, CINS, CSOFT_CLIP


@dataclasses.dataclass
class NoisyReadInfo:
    read_ids: List[int]
    lens: np.ndarray
    seqs: List[np.ndarray]
    quals: List[np.ndarray]
    strands: np.ndarray
    covers: np.ndarray
    haps: np.ndarray
    phase_sets: np.ndarray
    read_reg_beg: dict
    read_reg_end: dict


def _nri_cache(d, flank_len: int):
    """Per-digar arrays for collect_noisy_read_info, computed once (reads
    recur across noisy regions and waves).  Returns (dpos list, dend,
    not_clip, long_del, monotone, base_beg, base_end, strand)."""
    c = getattr(d, "_nri", None)
    if c is not None and c[0] == flank_len:
        return c[1]
    typ = d.type
    dpos = d.pos
    dlen = d.len
    nd = len(dpos)
    spans = (typ == CDIFF) | (typ == CEQUAL) | (typ == CDEL)
    dend = dpos + np.where(spans, dlen - 1, 0)
    not_clip = (typ != CSOFT_CLIP) & (typ != CHARD_CLIP)
    long_del = (typ == CDEL) & (dlen > flank_len)
    # the bisect walk below needs non-clip dend to be nondecreasing (true
    # for consistent digars: ref spans don't overlap); else mask fallback
    nc_end = dend[not_clip]
    monotone = bool(nc_end.size == 0 or np.all(nc_end[1:] >= nc_end[:-1]))
    # digar2qlen analog (src/bam_utils.h:122-134)
    last = nd - 1
    qlen = int(d.qi[last])
    if typ[last] in (CEQUAL, CDIFF, CINS, CSOFT_CLIP, CHARD_CLIP):
        qlen += int(dlen[last])
    base_beg = int(dlen[0]) if typ[0] == CHARD_CLIP else 0
    base_end = int(d.qi[last]) - 1 if typ[last] == CHARD_CLIP else qlen - 1
    info = (dpos.tolist(), dend.tolist(), not_clip.tolist(),
            long_del.tolist(), monotone, base_beg, base_end,
            1 if d.is_rev else 0)
    d._nri = (flank_len, info)
    return info


def _nri_boundary_hit(dpos: list, dend: list, not_clip: list,
                      long_del: list, hb: int, target: int):
    """Last non-clip event containing ``target`` among the prefix [0, hb)
    (all have pos <= target), plus the any-long-CDEL latch over the
    containing set (the reference's k loop never resets it,
    align.c:1399-1446)."""
    k = hb - 1
    hit = -1
    is_del = False
    while k >= 0:
        if not not_clip[k]:
            k -= 1
            continue
        if dend[k] < target:
            break
        if hit < 0:
            hit = k
        if long_del[k]:
            is_del = True
        k -= 1
    return hit, is_del


def collect_noisy_read_info(opt: CallOpts, chunk: WindowChunk, reg_beg: int,
                            reg_end: int, read_ids: List[int]) -> NoisyReadInfo:
    """Per-read region sub-sequence + cover flags
    (collect_noisy_read_info, align.c:1377-1461)."""
    import bisect
    n = len(read_ids)
    lens = np.zeros(n, dtype=np.int64)
    seqs: List[np.ndarray] = []
    quals: List[np.ndarray] = []
    strands = np.zeros(n, dtype=np.uint8)
    covers = np.zeros(n, dtype=np.int64)
    haps = np.zeros(n, dtype=np.int64)
    phase_sets = np.zeros(n, dtype=np.int64)
    rrb, rre = {}, {}
    for i, rid in enumerate(read_ids):
        d = chunk.digars[rid]
        (dpos_l, dend_l, nclip_l, ldel_l, monotone, base_beg, base_end,
         strand) = _nri_cache(d, opt.noisy_reg_flank_len)
        reg_read_beg = base_beg
        reg_read_end = base_end
        strands[i] = strand
        typ = d.type
        dqi = d.qi
        if monotone:
            hb = bisect.bisect_right(dpos_l, reg_beg)
            he = bisect.bisect_right(dpos_l, reg_end)
            kb, beg_is_del = _nri_boundary_hit(dpos_l, dend_l, nclip_l,
                                               ldel_l, hb, reg_beg)
            ke, end_is_del = _nri_boundary_hit(dpos_l, dend_l, nclip_l,
                                               ldel_l, he, reg_end)
        else:
            # mask fallback: the boundary hit uses the LAST matching
            # entry's coordinates, the long-deletion flag latches on ANY
            # matching CDEL
            dpos = d.pos
            dend_v = np.asarray(dend_l)
            ok = (np.asarray(nclip_l) & (dpos <= reg_end))
            hit_b = ok & (dpos <= reg_beg) & (reg_beg <= dend_v)
            hit_e = ok & (reg_end <= dend_v)
            long_del = np.asarray(ldel_l)
            beg_is_del = bool(np.any(hit_b & long_del))
            end_is_del = bool(np.any(hit_e & long_del))
            bidx = np.nonzero(hit_b)[0]
            eidx = np.nonzero(hit_e)[0]
            kb = int(bidx[-1]) if bidx.size else -1
            ke = int(eidx[-1]) if eidx.size else -1
        reg_digar_beg = reg_digar_end = -1
        if kb >= 0:
            reg_digar_beg = reg_beg
            reg_read_beg = (int(dqi[kb]) if typ[kb] == CDEL
                            else int(dqi[kb]) + (reg_beg - dpos_l[kb]))
        if ke >= 0:
            reg_digar_end = reg_end
            reg_read_end = (int(dqi[ke]) - 1 if typ[ke] == CDEL
                            else int(dqi[ke]) + (reg_end - dpos_l[ke]))
        if reg_digar_beg == reg_beg and reg_digar_end == reg_end:
            if not beg_is_del and not end_is_del:
                cover = LEFT_COVER | RIGHT_COVER
            elif not beg_is_del:
                cover = LEFT_COVER | RIGHT_GAP
            elif not end_is_del:
                cover = LEFT_GAP | RIGHT_COVER
            else:
                cover = LEFT_GAP | RIGHT_GAP
        elif reg_digar_beg == reg_beg:
            cover = LEFT_GAP if beg_is_del else LEFT_COVER
        elif reg_digar_end == reg_end:
            cover = RIGHT_GAP if end_is_del else RIGHT_COVER
        else:
            cover = 0
        seqs.append(d.seq[reg_read_beg:reg_read_end + 1].copy())
        quals.append(d.qual[reg_read_beg:reg_read_end + 1].copy())
        lens[i] = reg_read_end - reg_read_beg + 1
        haps[i] = int(chunk.haps[rid])
        phase_sets[i] = int(chunk.phase_sets[rid])
        covers[i] = cover
        rrb[rid] = reg_read_beg
        rre[rid] = reg_read_end
    return NoisyReadInfo(list(read_ids), lens, seqs, quals, strands, covers,
                         haps, phase_sets, rrb, rre)


def _full_cover_cmp(c1: int, c2: int) -> int:
    """full_cover_cmp (align.c:945-952)."""
    if c1 == c2:
        return 0
    if is_both_cover(c1):
        return 1
    if is_both_cover(c2):
        return -1
    if (c1 & LEFT_COVER) and (c2 & LEFT_COVER):
        return 0
    if (c1 & RIGHT_COVER) and (c2 & RIGHT_COVER):
        return 0
    return c1 - c2


def sort_noisy_reads(info: NoisyReadInfo, use_error_rate: bool) -> None:
    """sort_noisy_region_reads (align.c:955-987): best cover first, then
    lowest expected error rate (sampling mode), then longest."""
    if use_error_rate:
        err = [float(np.power(10.0, -q.astype(np.float64) / 10).mean())
               if len(q) else 0.0 for q in info.quals]
    else:
        err = [0.0] * len(info.lens)

    def cmp(a: int, b: int) -> int:
        c = _full_cover_cmp(int(info.covers[a]), int(info.covers[b]))
        if c != 0:
            return -c
        if use_error_rate and err[a] != err[b]:
            return -1 if err[a] < err[b] else 1
        if info.lens[a] != info.lens[b]:
            return -1 if info.lens[a] > info.lens[b] else 1
        return 0

    order = sorted(range(len(info.lens)), key=functools.cmp_to_key(cmp))
    info.read_ids = [info.read_ids[k] for k in order]
    info.lens = info.lens[order]
    info.seqs = [info.seqs[k] for k in order]
    info.quals = [info.quals[k] for k in order]
    info.strands = info.strands[order]
    info.covers = info.covers[order]
    info.haps = info.haps[order]
    info.phase_sets = info.phase_sets[order]


def phase_set_with_both_haps(info: NoisyReadInfo, min_full: int,
                             min_all: int) -> int:
    """collect_phase_set_with_both_haps (align.c:1225-1279)."""
    ps_list: List[int] = []
    full_cnt: List[List[int]] = []
    all_cnt: List[List[int]] = []
    min_full_len: List[List[int]] = []
    for i in range(len(info.lens)):
        if info.haps[i] == 0:
            continue
        ps = int(info.phase_sets[i])
        if ps in ps_list:
            pi = ps_list.index(ps)
        else:
            ps_list.append(ps)
            full_cnt.append([0, 0])
            all_cnt.append([0, 0])
            min_full_len.append([1 << 30, 1 << 30])
            pi = len(ps_list) - 1
        h = int(info.haps[i]) - 1
        if is_both_cover(int(info.covers[i])):
            full_cnt[pi][h] += 1
            all_cnt[pi][h] += 1
            min_full_len[pi][h] = min(min_full_len[pi][h], int(info.lens[i]))
        elif (info.covers[i] & LEFT_COVER) or (info.covers[i] & RIGHT_COVER):
            if info.lens[i] >= min_full_len[pi][h]:
                all_cnt[pi][h] += 1
    max_ps, max_i = -1, -1
    best1 = best2 = -1
    for pi, ps in enumerate(ps_list):
        c1 = min(full_cnt[pi])
        c2 = max(full_cnt[pi])
        if c1 > best1 or (c1 == best1 and c2 > best2):
            best1, best2 = c1, c2
            max_ps, max_i = ps, pi
    if best1 < min_full:
        return -1
    if max_i != -1 and (all_cnt[max_i][0] < min_all
                        or all_cnt[max_i][1] < min_all):
        return -1
    return max_ps


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


def _ref_is_homopolymer(ref_seq: np.ndarray, flank_len: int) -> bool:
    """is_homopolymer (align.c:1000-1021)."""
    n = len(ref_seq)
    if n < 2 * flank_len or n > 2 * flank_len + 50:
        return False
    hp_len = 0
    for i in range(flank_len - 1, n - flank_len + 1):
        if i >= 1 and ref_seq[i] == ref_seq[i - 1]:
            hp_len += 1
        else:
            if hp_len >= 5:
                return True
            hp_len = 0
    return hp_len >= 5


# ---------- variant extraction from ref<->cons alignment strings ----------

def make_cand_vars_from_aln(opt: CallOpts, chunk: WindowChunk, reg_beg: int,
                            ref_aln: np.ndarray, cons_aln: np.ndarray,
                            no_end_var: bool = False
                            ) -> Tuple[CandVars, List[TeInfo], np.ndarray]:
    """make_cand_vars_from_msa / _baln0 (collect_var.c:1784-1873),
    vectorized by gap-run segmentation (the sequential column walk below
    stays as the oracle; equality is checked on every production call of
    the -s / --refine-aln paths in tests/test_refine_vectorized.py).
    Returns (vars, te annotations, is_homopolymer_indel flags)."""
    keep = (ref_aln != GAP) | (cons_aln != GAP)
    r = ref_aln[keep]
    c = cons_aln[keep]
    L = len(r)
    pos_l, type_l, rlen_l, alen_l, alt_l = [], [], [], [], []
    te_l: List[TeInfo] = []
    hp_l: List[bool] = []
    if L:
        gr = r == GAP                       # INS columns (both-gap removed)
        gc = c == GAP                       # DEL columns
        both = ~gr & ~gc
        refpos = reg_beg + np.concatenate(
            [[0], np.cumsum(~gr, dtype=np.int64)[:-1]])
        # events in column order: X singles + INS/DEL run starts
        nxt_both = np.concatenate([both[1:], [True]])
        xm = both & (r != c) & nxt_both
        ev: List[Tuple[int, int, int]] = []   # (col, kind, run_len)
        for kind, m in ((CINS, gr), (CDEL, gc)):
            if not m.any():
                continue
            d = np.diff(m.astype(np.int8))
            starts = np.nonzero(np.concatenate([[m[0]], d == 1]))[0]
            ends = np.nonzero(np.concatenate([d == -1, [m[-1]]]))[0] + 1
            for s0, e0 in zip(starts, ends):
                ev.append((int(s0), kind, int(e0 - s0)))
        for i in np.nonzero(xm)[0]:
            ev.append((int(i), CDIFF, 1))
        ev.sort()
        for i, kind, g in ev:
            ref_pos = int(refpos[i])
            if kind == CDIFF:
                pos_l.append(ref_pos)
                type_l.append(CDIFF)
                rlen_l.append(1)
                alen_l.append(1)
                alt_l.append(bytes(c[i:i + 1]))
                te_l.append(NO_TE)
                hp_l.append(False)
                continue
            if no_end_var and (
                    i == 0 or i + g >= L
                    or gr[i - 1] or gc[i - 1] or gr[i + g] or gc[i + g]):
                continue
            te = NO_TE
            hp = False
            if kind == CINS:
                if g >= opt.min_sv_len:
                    te = te_info_for_gap(opt, chunk, CINS, ref_pos,
                                         c[i:i + g], g,
                                         getattr(opt, "_te_index", None))
                pos_l.append(ref_pos)
                type_l.append(CINS)
                rlen_l.append(0)
                alen_l.append(g)
                alt_l.append(bytes(c[i:i + g]))
            else:
                if g >= opt.min_sv_len:
                    te = te_info_for_gap(opt, chunk, CDEL, ref_pos, None, g,
                                         getattr(opt, "_te_index", None))
                else:
                    run = chunk.ref4_slice(ref_pos, 5)
                    del_run = chunk.ref4_slice(ref_pos, g)
                    hp = bool((del_run == run[0]).all()
                              and (run == run[0]).all())
                pos_l.append(ref_pos)
                type_l.append(CDEL)
                rlen_l.append(g)
                alen_l.append(0)
                alt_l.append(b"")
            te_l.append(te)
            hp_l.append(hp)
    n = len(pos_l)
    cand = CandVars(
        pos=np.array(pos_l, dtype=np.int64),
        type=np.array(type_l, dtype=np.uint8),
        ref_len=np.array(rlen_l, dtype=np.int32),
        alt_len=np.array(alen_l, dtype=np.int32),
        alt_seqs=alt_l,
        total_cov=np.zeros(n, dtype=np.int32),
        low_qual_cov=np.zeros(n, dtype=np.int32),
        alle_covs=np.zeros((n, 2), dtype=np.int32),
        strand_covs=np.zeros((n, 2, 2), dtype=np.int32),
        is_homopolymer_indel=np.array(hp_l, dtype=bool))
    return cand, te_l, np.array(hp_l, dtype=bool)


def _make_cand_vars_from_aln_ref(opt: CallOpts, chunk: WindowChunk,
                                 reg_beg: int, ref_aln: np.ndarray,
                                 cons_aln: np.ndarray,
                                 no_end_var: bool = False
                                 ) -> Tuple[CandVars, List[TeInfo],
                                            np.ndarray]:
    """The sequential column walk (collect_var.c:1784-1873) — the oracle
    for the vectorized extractor above."""
    keep = (ref_aln != GAP) | (cons_aln != GAP)
    r = ref_aln[keep]
    c = cons_aln[keep]
    L = len(r)
    pos_l, type_l, rlen_l, alen_l, alt_l = [], [], [], [], []
    te_l: List[TeInfo] = []
    hp_l: List[bool] = []
    ref_pos = reg_beg
    i = 0
    while i < L:
        if r[i] == c[i]:
            i += 1
            ref_pos += 1
            continue
        if r[i] != GAP and c[i] != GAP:
            nxt_ok = (i + 1 == L) or (r[i + 1] != GAP and c[i + 1] != GAP)
            if nxt_ok:
                pos_l.append(ref_pos)
                type_l.append(CDIFF)
                rlen_l.append(1)
                alen_l.append(1)
                alt_l.append(bytes(c[i:i + 1]))
                te_l.append(NO_TE)
                hp_l.append(False)
            i += 1
            ref_pos += 1
        elif r[i] == GAP:  # INS
            g = 1
            while i + g < L and r[i + g] == GAP and c[i + g] != GAP:
                g += 1
            skip = no_end_var and (
                i - 1 < 0 or i + g >= L or r[i - 1] == GAP
                or r[i + g] == GAP or c[i - 1] == GAP or c[i + g] == GAP)
            if not skip:
                te = NO_TE
                hp = False
                if g >= opt.min_sv_len:
                    te = te_info_for_gap(opt, chunk, CINS, ref_pos,
                                         c[i:i + g], g,
                                         getattr(opt, "_te_index", None))
                pos_l.append(ref_pos)
                type_l.append(CINS)
                rlen_l.append(0)
                alen_l.append(g)
                alt_l.append(bytes(c[i:i + g]))
                te_l.append(te)
                hp_l.append(hp)  # INS never HP (reference quirk,
                                 # var_is_homopolymer_indel char/nt4 compare)
            i += g
        else:  # DEL
            g = 1
            while i + g < L and r[i + g] != GAP and c[i + g] == GAP:
                g += 1
            skip = no_end_var and (
                i - 1 < 0 or i + g >= L or r[i - 1] == GAP
                or r[i + g] == GAP or c[i - 1] == GAP or c[i + g] == GAP)
            if not skip:
                te = NO_TE
                hp = False
                if g >= opt.min_sv_len:
                    te = te_info_for_gap(opt, chunk, CDEL, ref_pos, None, g,
                                         getattr(opt, "_te_index", None))
                else:
                    # DEL HP check: run of identical ref bases
                    run = chunk.ref4_slice(ref_pos, 5)
                    del_run = chunk.ref4_slice(ref_pos, g)
                    hp = bool((del_run == run[0]).all()
                              and (run == run[0]).all())
                pos_l.append(ref_pos)
                type_l.append(CDEL)
                rlen_l.append(g)
                alen_l.append(0)
                alt_l.append(b"")
                te_l.append(te)
                hp_l.append(hp)
            i += g
            ref_pos += g
    n = len(pos_l)
    cand = CandVars(
        pos=np.array(pos_l, dtype=np.int64),
        type=np.array(type_l, dtype=np.uint8),
        ref_len=np.array(rlen_l, dtype=np.int32),
        alt_len=np.array(alen_l, dtype=np.int32),
        alt_seqs=alt_l,
        total_cov=np.zeros(n, dtype=np.int32),
        low_qual_cov=np.zeros(n, dtype=np.int32),
        alle_covs=np.zeros((n, 2), dtype=np.int32),
        strand_covs=np.zeros((n, 2, 2), dtype=np.int32),
        is_homopolymer_indel=np.array(hp_l, dtype=bool))
    return cand, te_l, np.array(hp_l, dtype=bool)


# ---------- allele matching against cons<->read alignment strings ----------
#
# The reference walks the whole alignment string per variant
# (is_match_aln_str, collect_var.c:1960-1997).  With R reads x V vars per
# noisy region that is O(R*V*L); here every AlnStr gets a one-time O(L)
# prefix-sum index and each per-var query is O(log L) searchsorted lookups.
# The sequential walks these replace are kept as oracles in
# tests/test_alnstr_fast.py.

def _aln_index(s: AlnStr):
    """(cur, eq_ps, qng_ps): target coordinate after each column, prefix
    counts of q==t and q!=GAP.  Cached on the AlnStr."""
    idx = getattr(s, "_idx", None)
    if idx is not None and idx[0] is s.target_aln:
        return idx[1], idx[2], idx[3]
    t, q = s.target_aln, s.query_aln
    n = len(t)
    stk = np.zeros((3, n + 1), dtype=np.int64)
    np.cumsum(np.stack([t != GAP, q == t, q != GAP]), axis=1,
              dtype=np.int64, out=stk[:, 1:])
    cur = stk[0, 1:] - 1
    eq_ps = stk[1]
    qng_ps = stk[2]
    s._idx = (s.target_aln, cur, eq_ps, qng_ps)
    return cur, eq_ps, qng_ps


def _cur_in_range(cur: np.ndarray, lo: int, hi: int, v: int) -> bool:
    """True iff some column i in [lo, hi] has cur[i] == v."""
    if lo > hi:
        return False
    left = int(cur.searchsorted(v))
    right = int(cur.searchsorted(v + 1)) - 1
    return max(lo, left) <= min(hi, right)


def _first_eq(cur: np.ndarray, v: int) -> int:
    """First column where cur == v; len(cur) when the value is never
    attained (the loops break on *equality*, so a v below cur[0] or above
    cur[-1] never stops the walk)."""
    i = int(cur.searchsorted(v))
    if i < len(cur) and int(cur[i]) != v:
        return len(cur)
    return i


def _is_match_aln_str(s: AlnStr, target_pos: int, length: int,
                      sim: float) -> Tuple[int, int]:
    """is_match_aln_str (collect_var.c:1960-1997) -> (allele, full_cover)."""
    n = s.aln_len
    cur, eq_ps, _ = _aln_index(s)
    lo = max(s.query_beg, s.target_beg)
    hi = min(s.query_end, s.target_end, n - 1)
    i_stop = _first_eq(cur, target_pos + length)
    b = min(i_stop - 1, hi)
    start_pos = target_pos if target_pos >= 0 else 0
    end_pos = (target_pos + length - 1 if target_pos >= 0 else length - 1)
    cover_start = _cur_in_range(cur, lo, b, start_pos)
    cover_end = _cur_in_range(cur, lo, b, end_pos)
    a = max(lo, int(cur.searchsorted(target_pos)))
    if a <= b:
        n_eq = int(eq_ps[b + 1] - eq_ps[a])
        n_xid = (b - a + 1) - n_eq
    else:
        n_eq = n_xid = 0
    full = 1 if (cover_start and cover_end) else 0
    if length >= 10:
        if n_eq >= length * sim:
            return 1, full
        return (0, full) if full else (-1, full)
    if n_eq == length and n_xid == 0:
        return 1, full
    return (0, full) if full else (-1, full)


def _is_match_aln_str_del(s: AlnStr, left: int, right: int
                          ) -> Tuple[int, int]:
    """is_match_aln_str_del (collect_var.c:2000-2036)."""
    n = s.aln_len
    cur, _, qng_ps = _aln_index(s)
    lo = max(s.query_beg, s.target_beg)
    hi = min(s.query_end, s.target_end, n - 1)
    i_stop = _first_eq(cur, right + 1)
    b = min(i_stop - 1, hi)
    start_pos = left if left >= 0 else 0
    cover_start = _cur_in_range(cur, lo, b, start_pos)
    cover_end = _cur_in_range(cur, lo, b, right)
    # columns with left <= cur < right; the first one only sets `started`
    a2 = max(lo, int(cur.searchsorted(left)))
    b2 = min(b, int(cur.searchsorted(right)) - 1)
    n_non_del = int(qng_ps[b2 + 1] - qng_ps[a2 + 1]) if a2 < b2 else 0
    if cover_start and cover_end:
        return (1 if n_non_del == 0 else 0), 1
    return -1, 0


def _is_cover_aln_str(s: AlnStr, target_pos: int, length: int) -> int:
    n = s.aln_len
    cur, _, _ = _aln_index(s)
    lo = max(s.query_beg, s.target_beg)
    hi = min(s.query_end, s.target_end, n - 1)
    start_pos = target_pos if target_pos >= 0 else 0
    end_pos = (target_pos + length - 1 if target_pos >= 0 else length - 1)
    return 1 if (_cur_in_range(cur, lo, hi, start_pos)
                 and _cur_in_range(cur, lo, hi, end_pos)) else 0


def _del_span_in_cons(ref_cons: AlnStr, beg_in_ref: int,
                      end_in_ref: int) -> Tuple[int, int]:
    """Map a ref-space [beg, end] span through the ref<->cons alignment to
    cons space (the read-independent half of
    get_full_cover_from_ref_cons_aln_str, collect_var.c:2107-2129)."""
    n = ref_cons.aln_len
    cur_ref, _, qng_ps = _aln_index(ref_cons)
    lo = max(ref_cons.query_beg, ref_cons.target_beg)
    hi = min(ref_cons.query_end, ref_cons.target_end, n - 1)
    beg_in_cons = end_in_cons = -1
    if lo <= hi:
        # cur_cons at column i is qng_ps[i+1] - 1
        i1 = max(lo, int(cur_ref.searchsorted(beg_in_ref)))
        if i1 <= hi and int(cur_ref[i1]) == beg_in_ref:
            beg_in_cons = int(qng_ps[i1 + 1]) - 1
        i2 = max(lo, int(cur_ref.searchsorted(end_in_ref)))
        if i2 <= hi and int(cur_ref[i2]) == end_in_ref:
            # first column >= i2 with q != GAP (reach_end is set at i2 and
            # the q check runs in the same iteration)
            j = int(qng_ps[1:].searchsorted(int(qng_ps[i2]) + 1))
            if j <= hi:
                end_in_cons = int(qng_ps[j + 1]) - 1
    return beg_in_cons, end_in_cons


def _full_cover_del_via_ref(cons_read: AlnStr, ref_cons: AlnStr,
                            beg_in_ref: int, end_in_ref: int) -> int:
    """get_full_cover_from_ref_cons_aln_str (collect_var.c:2107-2129)."""
    beg_in_cons, end_in_cons = _del_span_in_cons(ref_cons, beg_in_ref,
                                                 end_in_ref)
    return _is_cover_aln_str(cons_read, beg_in_cons,
                             end_in_cons - beg_in_cons + 1)


def _allele_from_cons_aln(s: AlnStr, var_type: int, alt_pos: int,
                          alt_len: int) -> Tuple[int, int]:
    """get_var_allele_i_from_cons_aln_str (collect_var.c:2057-2068)."""
    if var_type == CDIFF:
        return _is_match_aln_str(s, alt_pos, 1, 0.9)
    if var_type == CINS:
        return _is_match_aln_str(s, alt_pos, alt_len, 0.9)
    return _is_match_aln_str_del(s, alt_pos - 1, alt_pos)


def _full_cover_from_cons_aln(s: AlnStr, var_type: int, alt_pos: int,
                              ref_len: int) -> int:
    if var_type == CDIFF:
        return _is_cover_aln_str(s, alt_pos, 1)
    if var_type == CINS:
        return _is_cover_aln_str(s, alt_pos, ref_len + 1)
    return _is_cover_aln_str(s, alt_pos - 1, ref_len + 1)


def _full_cover_del_via_ref_seq(cons_read: AlnStr, ref_cons: AlnStr,
                                beg_in_ref: int, end_in_ref: int) -> int:
    """Sequential oracle for _full_cover_del_via_ref (the vectorized
    version above is the production path; parity fuzzed in
    tests/test_alnstr_fast.py and on every real window of the HiFi e2e)."""
    cur_ref = cur_cons = -1
    beg_in_cons = end_in_cons = -1
    reach_end = 0
    t, q = ref_cons.target_aln, ref_cons.query_aln
    for i in range(ref_cons.aln_len):
        if t[i] != GAP:
            cur_ref += 1
        if q[i] != GAP:
            cur_cons += 1
        if i < ref_cons.query_beg or i < ref_cons.target_beg:
            continue
        if i > ref_cons.query_end or i > ref_cons.target_end:
            break
        if cur_ref == beg_in_ref and beg_in_cons == -1:
            beg_in_cons = cur_cons
        if cur_ref == end_in_ref:
            reach_end = 1
        if reach_end and q[i] != GAP:
            end_in_cons = cur_cons
            break
    return _is_cover_aln_str(cons_read, beg_in_cons,
                             end_in_cons - beg_in_cons + 1)


# ---------- per-read profile over noisy vars ----------

class NoisyProfile:
    """Dense read x noisy-var profile accumulated from cons<->read strings."""

    def __init__(self, n_reads: int, n_vars: int):
        self.alleles = np.full((n_reads, n_vars), -1, dtype=np.int8)
        self.alt_qi = np.full((n_reads, n_vars), -1, dtype=np.int32)
        self.start = np.full(n_reads, -1, dtype=np.int32)
        self.end = np.full(n_reads, -2, dtype=np.int32)

    def set(self, read_id: int, var_i: int, allele: int, qi: int) -> None:
        if self.start[read_id] == -1:
            self.start[read_id] = var_i
        self.end[read_id] = var_i
        self.alleles[read_id, var_i] = allele
        self.alt_qi[read_id, var_i] = qi


def _batch_first_eq(cur: np.ndarray, v: np.ndarray) -> np.ndarray:
    n = len(cur)
    i = cur.searchsorted(v)
    att = (i < n) & (cur[np.minimum(i, n - 1)] == v) if n else \
        np.zeros(len(v), dtype=bool)
    return np.where(att, i, n)


def _batch_in_range(cur: np.ndarray, lo: int, b, v) -> np.ndarray:
    left = cur.searchsorted(v)
    right = cur.searchsorted(v + 1) - 1
    return np.maximum(lo, left) <= np.minimum(b, right)


def _batch_is_match(s: AlnStr, tps: np.ndarray, lens: np.ndarray,
                    sim: float):
    """Vectorized _is_match_aln_str over per-var (target_pos, length)."""
    n = s.aln_len
    cur, eq_ps, _ = _aln_index(s)
    lo = max(s.query_beg, s.target_beg)
    hi = min(s.query_end, s.target_end, n - 1)
    i_stop = _batch_first_eq(cur, tps + lens)
    b = np.minimum(i_stop - 1, hi)
    start_pos = np.where(tps >= 0, tps, 0)
    end_pos = np.where(tps >= 0, tps + lens - 1, lens - 1)
    cover = (_batch_in_range(cur, lo, b, start_pos)
             & _batch_in_range(cur, lo, b, end_pos))
    a = np.maximum(lo, cur.searchsorted(tps))
    ok = a <= b
    n_eq = np.where(ok, eq_ps[b + 1] - eq_ps[np.minimum(a, n)], 0)
    n_xid = np.where(ok, (b - a + 1) - n_eq, 0)
    is_alt = np.where(lens >= 10, n_eq >= lens * sim,
                      (n_eq == lens) & (n_xid == 0))
    allele = np.where(is_alt, 1, np.where(cover, 0, -1))
    return allele, cover.astype(np.int64)


def _batch_is_match_del(s: AlnStr, lefts: np.ndarray, rights: np.ndarray):
    """Vectorized _is_match_aln_str_del."""
    n = s.aln_len
    cur, _, qng_ps = _aln_index(s)
    lo = max(s.query_beg, s.target_beg)
    hi = min(s.query_end, s.target_end, n - 1)
    i_stop = _batch_first_eq(cur, rights + 1)
    b = np.minimum(i_stop - 1, hi)
    start_pos = np.maximum(lefts, 0)
    cover = (_batch_in_range(cur, lo, b, start_pos)
             & _batch_in_range(cur, lo, b, rights))
    a2 = np.maximum(lo, cur.searchsorted(lefts))
    b2 = np.minimum(b, cur.searchsorted(rights) - 1)
    nnd = np.where(a2 < b2, qng_ps[np.minimum(b2 + 1, n)]
                   - qng_ps[np.minimum(a2 + 1, n)], 0)
    allele = np.where(cover, np.where(nnd == 0, 1, 0), -1)
    return allele, cover.astype(np.int64)


def _batch_is_cover(s: AlnStr, tps: np.ndarray, lens: np.ndarray):
    """Vectorized _is_cover_aln_str."""
    n = s.aln_len
    cur, _, _ = _aln_index(s)
    lo = max(s.query_beg, s.target_beg)
    hi = min(s.query_end, s.target_end, n - 1)
    start_pos = np.where(tps >= 0, tps, 0)
    end_pos = np.where(tps >= 0, tps + lens - 1, lens - 1)
    return (_batch_in_range(cur, lo, hi, start_pos)
            & _batch_in_range(cur, lo, hi, end_pos)).astype(np.int64)


def _batch_allele_full(s: AlnStr, types: np.ndarray, qpos: np.ndarray,
                       alt_lens: np.ndarray):
    """Vectorized _allele_from_cons_aln grouped by var type."""
    n = len(types)
    allele = np.full(n, -1, dtype=np.int64)
    full = np.zeros(n, dtype=np.int64)
    for mask, fn in ((types == CDIFF,
                      lambda m: _batch_is_match(
                          s, qpos[m], np.ones(int(m.sum()), np.int64), 0.9)),
                     (types == CINS,
                      lambda m: _batch_is_match(s, qpos[m], alt_lens[m],
                                                0.9)),
                     (types == CDEL,
                      lambda m: _batch_is_match_del(s, qpos[m] - 1,
                                                    qpos[m]))):
        if mask.any():
            allele[mask], full[mask] = fn(mask)
    return allele, full


class _AlnStrBatch:
    """Concatenated _aln_index over many AlnStrs.

    Segment r's target-coordinate array is offset by r*SEG so the
    concatenation stays globally sorted; one searchsorted then serves every
    (read, var) query at once, collapsing the per-read profile-update calls
    (collect_var.c:2134-2222 runs these walks per read per var)."""

    SEG = np.int64(1) << 40
    CLIP = np.int64(1) << 30

    def __init__(self, strs: List[AlnStr]):
        R = len(strs)
        ns = np.empty(R, dtype=np.int64)
        los = np.empty(R, dtype=np.int64)
        his = np.empty(R, dtype=np.int64)
        for r, s in enumerate(strs):
            ns[r] = s.aln_len
            los[r] = max(s.query_beg, s.target_beg)
            his[r] = min(s.query_end, s.target_end, s.aln_len - 1)
        self.n, self.lo, self.hi = ns, los, his
        off = np.concatenate([[0], np.cumsum(ns)])
        poff = np.concatenate([[0], np.cumsum(ns + 1)])
        self.off, self.poff = off, poff
        total = int(off[-1])
        if total == 0:
            self.cur = np.empty(0, np.int64)
            self.eq = np.empty(0, np.int64)
            self.qng = np.empty(0, np.int64)
            return
        # one concatenated pass: three global prefix sums, then per-segment
        # rebasing (instead of 3 cumsums per AlnStr)
        tall = np.concatenate([s.target_aln for s in strs])
        qall = np.concatenate([s.query_aln for s in strs])
        g = np.zeros((3, total + 1), dtype=np.int64)
        np.cumsum(np.stack([tall != GAP, qall == tall, qall != GAP]),
                  axis=1, dtype=np.int64, out=g[:, 1:])
        rr_n = np.repeat(np.arange(R, dtype=np.int64), ns)
        base = g[:, off[:-1]]
        self.cur = (g[0, 1:] - base[0][rr_n] - 1) + rr_n * self.SEG
        # prefix arrays carry a leading zero per segment: output slot k of
        # segment r (k in 0..n_r) reads global index off_r + k, and
        # poff_r = off_r + r makes that src = slot - r
        rr_p = np.repeat(np.arange(R, dtype=np.int64), ns + 1)
        src = np.arange(total + R, dtype=np.int64) - rr_p
        self.eq = g[1, src] - base[1][rr_p]
        self.qng = g[2, src] - base[2][rr_p]

    def _g(self, rr: np.ndarray, v: np.ndarray) -> np.ndarray:
        return np.clip(v, -self.CLIP, self.CLIP) + rr * self.SEG

    def _ps(self, arr: np.ndarray, idx: np.ndarray, mask: np.ndarray
            ) -> np.ndarray:
        """Fancy-index a concatenated prefix-sum array; out-of-segment
        indices only occur where `mask` is False, so clip keeps them legal
        without changing any selected value."""
        return arr[np.clip(idx, 0, len(arr) - 1)] * mask

    def first_eq(self, rr: np.ndarray, v: np.ndarray) -> np.ndarray:
        gv = self._g(rr, v)
        i = self.cur.searchsorted(gv)
        if len(self.cur) == 0:
            return self.n[rr]
        att = (i < self.off[rr + 1]) \
            & (self.cur[np.minimum(i, len(self.cur) - 1)] == gv)
        return np.where(att, i - self.off[rr], self.n[rr])

    def in_range(self, rr: np.ndarray, b: np.ndarray, v: np.ndarray
                 ) -> np.ndarray:
        off = self.off[rr]
        left = self.cur.searchsorted(self._g(rr, v)) - off
        right = self.cur.searchsorted(self._g(rr, v + 1)) - 1 - off
        return np.maximum(self.lo[rr], left) <= np.minimum(b, right)

    def is_match(self, rr: np.ndarray, tps: np.ndarray, lens: np.ndarray,
                 sim: float):
        """_is_match_aln_str over flattened (read, var) queries."""
        b = np.minimum(self.first_eq(rr, tps + lens) - 1, self.hi[rr])
        start_pos = np.where(tps >= 0, tps, 0)
        end_pos = np.where(tps >= 0, tps + lens - 1, lens - 1)
        cover = self.in_range(rr, b, start_pos) & self.in_range(rr, b,
                                                                end_pos)
        a = np.maximum(self.lo[rr],
                       self.cur.searchsorted(self._g(rr, tps)) - self.off[rr])
        ok = a <= b
        po = self.poff[rr]
        n_eq = self._ps(self.eq, po + b + 1, ok) \
            - self._ps(self.eq, po + np.minimum(a, self.n[rr]), ok)
        n_xid = np.where(ok, (b - a + 1) - n_eq, 0)
        is_alt = np.where(lens >= 10, n_eq >= lens * sim,
                          (n_eq == lens) & (n_xid == 0))
        allele = np.where(is_alt, 1, np.where(cover, 0, -1))
        return allele, cover.astype(np.int64)

    def is_match_del(self, rr: np.ndarray, lefts: np.ndarray,
                     rights: np.ndarray):
        """_is_match_aln_str_del over flattened (read, var) queries."""
        b = np.minimum(self.first_eq(rr, rights + 1) - 1, self.hi[rr])
        start_pos = np.maximum(lefts, 0)
        cover = self.in_range(rr, b, start_pos) & self.in_range(rr, b,
                                                                rights)
        off = self.off[rr]
        a2 = np.maximum(self.lo[rr],
                        self.cur.searchsorted(self._g(rr, lefts)) - off)
        b2 = np.minimum(b, self.cur.searchsorted(self._g(rr, rights)) - 1
                        - off)
        ok = a2 < b2
        po = self.poff[rr]
        nnd = self._ps(self.qng, po + np.minimum(b2 + 1, self.n[rr]), ok) \
            - self._ps(self.qng, po + np.minimum(a2 + 1, self.n[rr]), ok)
        allele = np.where(cover, np.where(nnd == 0, 1, 0), -1)
        return allele, cover.astype(np.int64)

    def is_cover(self, rr: np.ndarray, tps: np.ndarray, lens: np.ndarray
                 ) -> np.ndarray:
        hi = self.hi[rr]
        start_pos = np.where(tps >= 0, tps, 0)
        end_pos = np.where(tps >= 0, tps + lens - 1, lens - 1)
        return (self.in_range(rr, hi, start_pos)
                & self.in_range(rr, hi, end_pos)).astype(np.int64)

    def allele_full(self, rr: np.ndarray, types: np.ndarray,
                    qpos: np.ndarray, alt_lens: np.ndarray):
        """_batch_allele_full over flattened (read, var) queries."""
        m = len(types)
        allele = np.full(m, -1, dtype=np.int64)
        full = np.zeros(m, dtype=np.int64)
        for mask, fn in (
                (types == CDIFF,
                 lambda k: self.is_match(rr[k], qpos[k],
                                         np.ones(int(k.sum()), np.int64),
                                         0.9)),
                (types == CINS,
                 lambda k: self.is_match(rr[k], qpos[k], alt_lens[k], 0.9)),
                (types == CDEL,
                 lambda k: self.is_match_del(rr[k], qpos[k] - 1, qpos[k]))):
            if mask.any():
                allele[mask], full[mask] = fn(mask)
        return allele, full


def _update_profile_one_cons_batch(rows: List[Tuple[int, AlnStr]],
                                   reg_beg: int, cand: CandVars,
                                   p: NoisyProfile) -> None:
    """All reads of a single-consensus cluster at once (the per-read
    _update_profile_one_cons stays as the oracle)."""
    n = len(cand)
    if n == 0 or not rows:
        return
    types = cand.type.astype(np.int64)
    alt_lens = cand.alt_len.astype(np.int64)
    ref_lens = cand.ref_len.astype(np.int64)
    shift = np.where(types == CINS, -alt_lens,
                     np.where(types == CDEL, ref_lens, 0))
    delta = np.concatenate([[0], np.cumsum(shift)[:-1]])
    qpos = cand.pos.astype(np.int64) - reg_beg - delta
    R = len(rows)
    batch = _AlnStrBatch([s for _, s in rows])
    rr = np.repeat(np.arange(R, dtype=np.int64), n)
    allele, full = batch.allele_full(rr, np.tile(types, R),
                                     np.tile(qpos, R), np.tile(alt_lens, R))
    allele = allele.reshape(R, n)
    full = full.reshape(R, n)
    for k, (rid, _) in enumerate(rows):
        _apply_profile_hits(cand, p, rid, allele[k], full[k])


def _update_profile_two_cons_batch(clu_idx: int,
                                   rows: List[Tuple[int, AlnStr]],
                                   ref_cons: AlnStr, reg_beg: int,
                                   cand: CandVars, from_cons: np.ndarray,
                                   p: NoisyProfile) -> None:
    """All reads of one of two consensus clusters at once (the per-read
    _update_profile_two_cons stays as the oracle)."""
    n = len(cand)
    if n == 0 or not rows:
        return
    types = cand.type.astype(np.int64)
    alt_lens = cand.alt_len.astype(np.int64)
    ref_lens = cand.ref_len.astype(np.int64)
    on = (np.asarray(from_cons) & clu_idx) != 0
    shift = np.where(on & (types == CINS), -alt_lens,
                     np.where(on & (types == CDEL), ref_lens, 0))
    delta = np.concatenate([[0], np.cumsum(shift)[:-1]])
    beg_in_ref = cand.pos.astype(np.int64) - reg_beg
    qpos = beg_in_ref - delta
    # off-consensus DEL spans map through ref<->cons once (read-independent)
    off_del = np.nonzero(~on & (types == CDEL))[0]
    del_tps = np.empty(len(off_del), dtype=np.int64)
    del_lens = np.empty(len(off_del), dtype=np.int64)
    for k, i in enumerate(off_del):
        bc, ec = _del_span_in_cons(ref_cons, int(beg_in_ref[i]) - 1,
                                   int(beg_in_ref[i]) + int(ref_lens[i]))
        del_tps[k] = bc
        del_lens[k] = ec - bc + 1
    off_nd = np.nonzero(~on & (types != CDEL))[0]
    cov_lens = np.where(types[off_nd] == CDIFF, 1, ref_lens[off_nd] + 1)
    on_idx = np.nonzero(on)[0]

    R = len(rows)
    batch = _AlnStrBatch([s for _, s in rows])
    allele = np.zeros((R, n), dtype=np.int64)
    full = np.zeros((R, n), dtype=np.int64)
    if len(on_idx):
        rr = np.repeat(np.arange(R, dtype=np.int64), len(on_idx))
        a, f = batch.allele_full(rr, np.tile(types[on_idx], R),
                                 np.tile(qpos[on_idx], R),
                                 np.tile(alt_lens[on_idx], R))
        allele[:, on_idx] = a.reshape(R, len(on_idx))
        full[:, on_idx] = f.reshape(R, len(on_idx))
    if len(off_nd):
        rr = np.repeat(np.arange(R, dtype=np.int64), len(off_nd))
        full[:, off_nd] = batch.is_cover(
            rr, np.tile(qpos[off_nd], R),
            np.tile(cov_lens, R)).reshape(R, len(off_nd))
    if len(off_del):
        rr = np.repeat(np.arange(R, dtype=np.int64), len(off_del))
        full[:, off_del] = batch.is_cover(
            rr, np.tile(del_tps, R),
            np.tile(del_lens, R)).reshape(R, len(off_del))
    allele[:, ~on] = 0
    for k, (rid, _) in enumerate(rows):
        _apply_profile_hits(cand, p, rid, allele[k], full[k])


def _apply_profile_hits(cand: CandVars, p: NoisyProfile, read_id: int,
                        allele: np.ndarray, full: np.ndarray) -> None:
    """Write-back with p.set semantics (ascending var order)."""
    idx = np.nonzero(full)[0]
    if idx.size == 0:
        return
    cand.total_cov[idx] += 1
    a = allele[idx]
    cand.alle_covs[idx[a == 0], 0] += 1
    cand.alle_covs[idx[a == 1], 1] += 1
    p.alleles[read_id, idx] = a
    p.alt_qi[read_id, idx] = -1
    if p.start[read_id] == -1:
        p.start[read_id] = idx[0]
    p.end[read_id] = idx[-1]


def _update_profile_one_cons(cons_read: AlnStr, reg_beg: int,
                             cand: CandVars, p: NoisyProfile,
                             read_id: int) -> None:
    """update_cand_var_profile_from_cons_aln_str (collect_var.c:2134-2162):
    single-consensus case — every var is on the consensus.  One batched
    prefix-sum query per var type (parity with the sequential oracle in
    tests/test_profile_batch.py)."""
    n = len(cand)
    if n == 0:
        return
    types = cand.type.astype(np.int64)
    alt_lens = cand.alt_len.astype(np.int64)
    ref_lens = cand.ref_len.astype(np.int64)
    shift = np.where(types == CINS, -alt_lens,
                     np.where(types == CDEL, ref_lens, 0))
    delta = np.concatenate([[0], np.cumsum(shift)[:-1]])
    qpos = cand.pos.astype(np.int64) - reg_beg - delta
    allele, full = _batch_allele_full(cons_read, types, qpos, alt_lens)
    _apply_profile_hits(cand, p, read_id, allele, full)


def _update_profile_one_cons_seq(cons_read: AlnStr, reg_beg: int,
                                 cand: CandVars, p: NoisyProfile,
                                 read_id: int) -> None:
    """Sequential oracle for _update_profile_one_cons."""
    delta = 0
    for i in range(len(cand)):
        var_ref_pos = int(cand.pos[i]) - reg_beg
        allele, full = _allele_from_cons_aln(
            cons_read, int(cand.type[i]), var_ref_pos - delta,
            int(cand.alt_len[i]))
        if full:
            cand.total_cov[i] += 1
            if allele != -1:
                cand.alle_covs[i, allele] += 1
            p.set(read_id, i, allele, -1)
        if cand.type[i] == CINS:
            delta -= int(cand.alt_len[i])
        elif cand.type[i] == CDEL:
            delta += int(cand.ref_len[i])


def _update_profile_two_cons(clu_idx: int, cons_read: AlnStr,
                             ref_cons: AlnStr, reg_beg: int, cand: CandVars,
                             from_cons: np.ndarray, p: NoisyProfile,
                             read_id: int) -> None:
    """update_cand_var_profile_from_cons_aln_str21 (collect_var.c:
    2179-2222): vars from the read's own consensus are allele-checked; vars
    from the other haplotype only cover-checked (allele 0).  Batched like
    _update_profile_one_cons; the rare off-consensus DELs still walk the
    ref<->cons alignment individually."""
    n = len(cand)
    if n == 0:
        return
    types = cand.type.astype(np.int64)
    alt_lens = cand.alt_len.astype(np.int64)
    ref_lens = cand.ref_len.astype(np.int64)
    on = (np.asarray(from_cons) & clu_idx) != 0
    shift = np.where(on & (types == CINS), -alt_lens,
                     np.where(on & (types == CDEL), ref_lens, 0))
    delta = np.concatenate([[0], np.cumsum(shift)[:-1]])
    beg_in_ref = cand.pos.astype(np.int64) - reg_beg
    qpos = beg_in_ref - delta
    allele = np.zeros(n, dtype=np.int64)
    full = np.zeros(n, dtype=np.int64)
    if on.any():
        a, f = _batch_allele_full(cons_read, types[on], qpos[on],
                                  alt_lens[on])
        allele[on], full[on] = a, f
    off_nd = ~on & (types != CDEL)
    if off_nd.any():
        full[off_nd] = _batch_is_cover(
            cons_read, qpos[off_nd],
            np.where(types[off_nd] == CDIFF, 1, ref_lens[off_nd] + 1))
    for i in np.nonzero(~on & (types == CDEL))[0]:
        end_in_ref = int(beg_in_ref[i]) + int(ref_lens[i]) - 1
        full[i] = _full_cover_del_via_ref(cons_read, ref_cons,
                                          int(beg_in_ref[i]) - 1,
                                          end_in_ref + 1)
    allele[~on] = 0
    _apply_profile_hits(cand, p, read_id, allele, full)


def _update_profile_two_cons_seq(clu_idx: int, cons_read: AlnStr,
                                 ref_cons: AlnStr, reg_beg: int,
                                 cand: CandVars, from_cons: np.ndarray,
                                 p: NoisyProfile, read_id: int) -> None:
    """Sequential oracle for _update_profile_two_cons."""
    delta = 0
    for i in range(len(cand)):
        beg_in_ref = int(cand.pos[i]) - reg_beg
        t = int(cand.type[i])
        if t == CINS:
            end_in_ref = beg_in_ref
        else:
            end_in_ref = beg_in_ref + int(cand.ref_len[i]) - 1
        if from_cons[i] & clu_idx:
            allele, full = _allele_from_cons_aln(
                cons_read, t, beg_in_ref - delta, int(cand.alt_len[i]))
        else:
            if t != CDEL:
                full = _full_cover_from_cons_aln(
                    cons_read, t, beg_in_ref - delta, int(cand.ref_len[i]))
            else:
                full = _full_cover_del_via_ref(cons_read, ref_cons,
                                               beg_in_ref - 1, end_in_ref + 1)
            allele = 0
        if full:
            cand.total_cov[i] += 1
            if allele != -1:
                cand.alle_covs[i, allele] += 1
            p.set(read_id, i, allele, -1)
        if t == CINS and (from_cons[i] & clu_idx):
            delta -= int(cand.alt_len[i])
        elif t == CDEL and (from_cons[i] & clu_idx):
            delta += int(cand.ref_len[i])


def _merge_two_hap_vars(opt: CallOpts, v1: CandVars, te1, v2: CandVars, te2
                        ) -> Tuple[CandVars, List, np.ndarray, np.ndarray]:
    """Merge per-hap var lists into het/hom noisy vars
    (update_cand_var_profile_from_cons_aln_str2 head, collect_var.c:
    2232-2260).  Returns (vars, te, cate, from_cons bitmask)."""
    from longcalld_torch.core.sites import comp_sites_ins
    out_rows = []
    i1 = i2 = 0
    n1, n2 = len(v1), len(v2)
    while i1 < n1 and i2 < n2:
        ret = comp_sites_ins(opt.min_sv_len, v1.site_tuple(i1),
                             v2.site_tuple(i2))
        if ret < 0:
            out_rows.append((1, i1, config.NOISY_CAND_HET_VAR, 1))
            i1 += 1
        elif ret > 0:
            out_rows.append((2, i2, config.NOISY_CAND_HET_VAR, 2))
            i2 += 1
        else:
            out_rows.append((1, i1, config.NOISY_CAND_HOM_VAR, 3))
            i1 += 1
            i2 += 1
    while i1 < n1:
        out_rows.append((1, i1, config.NOISY_CAND_HET_VAR, 1))
        i1 += 1
    while i2 < n2:
        out_rows.append((2, i2, config.NOISY_CAND_HET_VAR, 2))
        i2 += 1
    n = len(out_rows)
    idx1 = [r[1] for r in out_rows if r[0] == 1]
    cand = CandVars(
        pos=np.array([(v1 if s == 1 else v2).pos[k] for s, k, _, _ in out_rows],
                     dtype=np.int64),
        type=np.array([(v1 if s == 1 else v2).type[k] for s, k, _, _ in out_rows],
                      dtype=np.uint8),
        ref_len=np.array([(v1 if s == 1 else v2).ref_len[k]
                          for s, k, _, _ in out_rows], dtype=np.int32),
        alt_len=np.array([(v1 if s == 1 else v2).alt_len[k]
                          for s, k, _, _ in out_rows], dtype=np.int32),
        alt_seqs=[(v1 if s == 1 else v2).alt_seqs[k] for s, k, _, _ in out_rows],
        total_cov=np.zeros(n, dtype=np.int32),
        low_qual_cov=np.zeros(n, dtype=np.int32),
        alle_covs=np.zeros((n, 2), dtype=np.int32),
        strand_covs=np.zeros((n, 2, 2), dtype=np.int32),
        is_homopolymer_indel=np.array(
            [(v1 if s == 1 else v2).is_homopolymer_indel[k]
             for s, k, _, _ in out_rows], dtype=bool))
    te = [(te1 if s == 1 else te2)[k] for s, k, _, _ in out_rows]
    cate = np.array([r[2] for r in out_rows], dtype=np.int32)
    from_cons = np.array([r[3] for r in out_rows], dtype=np.int32)
    return cand, te, cate, from_cons


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
        from longcalld_torch.core.refine import splice_read_digar
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


def _merge_join_rows(okb, nkb, comp, fast_ok: bool):
    """Sorted merge-join of two packed-key lists (old wins exact matches,
    matched new entries map to -1).  Returns (map_old, map_new, rows).

    When ``fast_ok`` (no fuzzy large-INS entries, no >16-byte alts — so
    the 48-byte keys fully discriminate and order exactly like ``comp``)
    and both key lists are strictly increasing, the merge vectorizes as
    two searchsorted passes.  'S48' comparisons equal byte-lexicographic
    order here: trailing-NUL stripping cannot reorder equal-width keys.
    Every other shape takes the comparator loop; equivalence is
    fuzz-locked by tests/test_merge_join.py."""
    n_old, n_new = len(okb), len(nkb)
    map_old = np.full(n_old, -1, dtype=np.int64)
    map_new = np.full(n_new, -1, dtype=np.int64)
    if fast_ok:
        ko = np.array(okb, dtype="S48")
        kn = np.array(nkb, dtype="S48")
        if ((n_old < 2 or (ko[1:] > ko[:-1]).all())
                and (n_new < 2 or (kn[1:] > kn[:-1]).all())):
            pos = np.searchsorted(ko, kn)
            dup = np.zeros(n_new, dtype=bool)
            if n_old:
                inb = pos < n_old
                dup[inb] = ko[pos[inb]] == kn[inb]
            kept = np.nonzero(~dup)[0]
            kn_keep = kn[kept]
            map_old[:] = (np.arange(n_old, dtype=np.int64)
                          + np.searchsorted(kn_keep, ko))
            map_new[kept] = (np.searchsorted(ko, kn_keep)
                             + np.arange(len(kept), dtype=np.int64))
            n_rows = n_old + len(kept)
            src_a = np.empty(n_rows, dtype=np.int64)
            idx_a = np.empty(n_rows, dtype=np.int64)
            src_a[map_old] = 0
            idx_a[map_old] = np.arange(n_old)
            src_a[map_new[kept]] = 1
            idx_a[map_new[kept]] = kept
            return map_old, map_new, list(zip(src_a.tolist(),
                                              idx_a.tolist()))
    rows = []  # (source, index)
    i = j = 0
    while i < n_old and j < n_new:
        ret = comp(i, j)
        if ret < 0:
            map_old[i] = len(rows)
            rows.append((0, i))
            i += 1
        elif ret > 0:
            map_new[j] = len(rows)
            rows.append((1, j))
            j += 1
        else:
            map_old[i] = len(rows)
            rows.append((0, i))
            i += 1
            j += 1
    while i < n_old:
        map_old[i] = len(rows)
        rows.append((0, i))
        i += 1
    while j < n_new:
        map_new[j] = len(rows)
        rows.append((1, j))
        j += 1
    return map_old, map_new, rows


def merge_var_profile(opt: CallOpts, chunk: WindowChunk, new_vars: CandVars,
                      new_te: List, new_cate: np.ndarray,
                      new_p: NoisyProfile) -> int:
    """merge_var_profile (collect_var.c:1298-1387): merge the new noisy vars
    + profiles into the window's candidate list (old wins on exact match)."""
    from longcalld_torch.core.sites import cand_packed_keys, comp_sites_ins
    old = chunk.cand_vars
    n_old = len(old) if old is not None else 0
    n_new = len(new_vars)
    if n_new == 0:
        return 0
    # packed-key byte compares == comp_sites_ins except (a) fuzzy large-INS
    # entries and (b) long-alt prefix ties, which take the slow comparator
    okb = cand_packed_keys(old) if n_old else []
    nkb = cand_packed_keys(new_vars)
    fuzzy_o = ((old.type == CINS) & (old.alt_len >= opt.min_sv_len)
               if n_old else np.zeros(0, dtype=bool))
    fuzzy_n = (new_vars.type == CINS) & (new_vars.alt_len >= opt.min_sv_len)

    def comp(i: int, j: int) -> int:
        ka, kb = okb[i], nkb[j]
        if not (fuzzy_o[i] or fuzzy_n[j]):
            if ka < kb:
                return -1
            if ka > kb:
                return 1
            sa, sb = old.alt_seqs[i], new_vars.alt_seqs[j]
            if len(sa) > 16 or len(sb) > 16:
                return -1 if sa < sb else (1 if sa > sb else 0)
            return 0
        return comp_sites_ins(opt.min_sv_len, old.site_tuple(i),
                              new_vars.site_tuple(j))

    fast_ok = (not fuzzy_o.any() and not fuzzy_n.any()
               and (n_old == 0 or int(old.alt_len.max(initial=0)) <= 16)
               and (n_new == 0 or int(new_vars.alt_len.max(initial=0))
                    <= 16))
    map_old, map_new, rows = _merge_join_rows(okb, nkb, comp, fast_ok)

    n_merged = len(rows)
    src_arr = np.fromiter((r[0] for r in rows), dtype=np.int64,
                          count=n_merged)
    idx_arr = np.fromiter((r[1] for r in rows), dtype=np.int64,
                          count=n_merged)
    is_old = src_arr == 0
    sel_o = np.nonzero(is_old)[0]
    sel_n = np.nonzero(~is_old)[0]

    def pick(field_old, field_new, dtype):
        fo = np.asarray(field_old)
        out = np.empty((n_merged,) + fo.shape[1:], dtype=dtype)
        if len(sel_o):
            out[sel_o] = fo[idx_arr[sel_o]]
        if len(sel_n):
            out[sel_n] = np.asarray(field_new)[idx_arr[sel_n]]
        return out

    old_hp = (old.is_homopolymer_indel if old.is_homopolymer_indel is not None
              else np.zeros(n_old, dtype=bool))
    new_hp = (new_vars.is_homopolymer_indel
              if new_vars.is_homopolymer_indel is not None
              else np.zeros(n_new, dtype=bool))
    merged = CandVars(
        pos=pick(old.pos, new_vars.pos, np.int64),
        type=pick(old.type, new_vars.type, np.uint8),
        ref_len=pick(old.ref_len, new_vars.ref_len, np.int32),
        alt_len=pick(old.alt_len, new_vars.alt_len, np.int32),
        alt_seqs=[(old.alt_seqs[idx] if src == 0 else new_vars.alt_seqs[idx])
                  for src, idx in rows],
        total_cov=pick(old.total_cov, new_vars.total_cov, np.int32),
        low_qual_cov=pick(old.low_qual_cov, new_vars.low_qual_cov, np.int32),
        alle_covs=pick(old.alle_covs, new_vars.alle_covs, np.int32),
        strand_covs=pick(old.strand_covs, new_vars.strand_covs, np.int32),
        is_homopolymer_indel=pick(old_hp, new_hp, bool))
    # carry the packed keys forward (identity fields are immutable) so the
    # next wave's merge doesn't recompute them over the grown list
    merged._pk = [okb[idx] if src == 0 else nkb[idx] for src, idx in rows]
    # hap/phase state: old vars keep theirs; new vars start fresh
    merged.hap_cons_alle = np.full((n_merged, 3), -1, dtype=np.int8)
    merged.hap_profile = np.zeros((n_merged, 3, 2), dtype=np.int32)
    merged.phase_set = np.zeros(n_merged, dtype=np.int64)
    if old.hap_cons_alle is not None:
        src_mask = np.array([src == 0 for src, _ in rows])
        old_idx = np.array([idx for src, idx in rows if src == 0],
                           dtype=np.int64)
        merged.hap_cons_alle[src_mask] = old.hap_cons_alle[old_idx]
        merged.hap_profile[src_mask] = old.hap_profile[old_idx]
        merged.phase_set[src_mask] = old.phase_set[old_idx]
    # TE annotations
    old_te = getattr(chunk, "var_te_info", None) or [NO_TE] * n_old
    if len(old_te) != n_old:   # defensive: never let a stale cache misalign
        old_te = [NO_TE] * n_old
    merged_te = [(old_te[idx] if src == 0 else new_te[idx])
                 for src, idx in rows]
    chunk.var_te_info = merged_te

    merged_cate = pick(chunk.var_cate if chunk.var_cate is not None
                       else np.zeros(0, dtype=np.int32), new_cate, np.int32)

    # dense profile merge
    n_reads = chunk.n_reads
    al = np.full((n_reads, n_merged), -1, dtype=np.int8)
    aq = np.full((n_reads, n_merged), -1, dtype=np.int32)
    if n_old and chunk.alleles is not None:
        al[:, map_old] = chunk.alleles
        aq[:, map_old] = chunk.alt_qi
    new_keep = map_new >= 0
    if new_keep.any():
        al[:, map_new[new_keep]] = new_p.alleles[:, new_keep]
        aq[:, map_new[new_keep]] = new_p.alt_qi[:, new_keep]
    # per-read merged spans: map_old is total-monotone, so an old span maps
    # end-to-end; map_new is monotone over its kept (>= 0) entries, so a new
    # span maps via next/prev-kept lookups
    BIGV = np.iinfo(np.int32).max
    start = np.full(n_reads, BIGV, dtype=np.int64)
    end = np.full(n_reads, -2, dtype=np.int64)
    if chunk.read_start_var is not None:
        om = chunk.read_start_var >= 0
        start[om] = map_old[chunk.read_start_var[om]]
        end[om] = map_old[chunk.read_end_var[om]]
    if n_new:
        kept = map_new >= 0
        nxt = np.full(n_new + 1, n_new, dtype=np.int64)
        for jj in range(n_new - 1, -1, -1):
            nxt[jj] = jj if kept[jj] else nxt[jj + 1]
        prv = np.full(n_new, -1, dtype=np.int64)
        run = -1
        for jj in range(n_new):
            if kept[jj]:
                run = jj
            prv[jj] = run
        nm = new_p.start >= 0
        if nm.any():
            j1 = nxt[new_p.start[nm]]
            j2 = prv[new_p.end[nm]]
            ok = (j1 <= j2) & (j1 < n_new)
            lo = np.where(ok, map_new[np.minimum(j1, n_new - 1)], BIGV)
            hi = np.where(ok, map_new[np.maximum(j2, 0)], -2)
            start[nm] = np.minimum(start[nm], lo)
            end[nm] = np.maximum(end[nm], hi)
    none = end < start
    start[none] = -1
    end[none] = -2
    start = start.astype(np.int32)
    end = end.astype(np.int32)
    chunk.cand_vars = merged
    chunk.var_cate = merged_cate
    chunk.alleles = al
    chunk.alt_qi = aq
    chunk.read_start_var = start
    chunk.read_end_var = end
    return int((map_new >= 0).sum())


# ---------- noisy-region somatic SV mining ----------

def _mine_read_somatic_vars(opt: CallOpts, chunk: WindowChunk, reg_beg: int,
                            region_vars: CandVars,
                            clusters,
                            ref_read_cache=None) -> Tuple[Optional[CandVars],
                                               Optional[List],
                                               Optional[np.ndarray],
                                               Optional["NoisyProfile"]]:
    """make_somatic_vars_from_aln_str (collect_var.c:2446-2586): per-read
    ref<->read alignment strings are mined for >= min_sv_len private indels;
    fuzzy-deduped against the region's germline vars, cross-read merged
    (each fuzzy match moves one alt count), then gated by
    var_is_cand_somatic and re-profiled against all cluster reads."""
    from longcalld_torch.core.profile import _fuzzy_comp_sites
    from longcalld_torch.core.somatic import var_is_cand_somatic

    read_sets = []   # (read_id, CandVars, te, cate)
    for ref_cons, rows in clusters:
        for rid, cons_read in rows:
            ref_read = (ref_read_cache.get(rid) if ref_read_cache is not None
                        else None)
            if ref_read is None:
                ref_read = ref_read_aln_from_pair(opt, ref_cons, cons_read)
            vars_r, te_r, _ = make_cand_vars_from_aln(
                opt, chunk, reg_beg, ref_read.target_aln, ref_read.query_aln,
                no_end_var=True)
            cate_r = np.full(len(vars_r), config.CAND_SOMATIC_VAR,
                             dtype=np.int32)
            alt_cov = np.ones(len(vars_r), dtype=np.int32)
            for k in range(len(vars_r)):
                if ((vars_r.type[k] == CINS
                     and vars_r.alt_len[k] < opt.min_sv_len)
                        or (vars_r.type[k] == CDEL
                            and vars_r.ref_len[k] < opt.min_sv_len)
                        or vars_r.type[k] == CDIFF):
                    cate_r[k] = config.NON_VAR
                    continue
                # fuzzy dedup vs the region's germline vars
                vlen = int(vars_r.alt_len[k]) if vars_r.type[k] == CINS \
                    else int(vars_r.ref_len[k])
                win = max(500, vlen)
                for jj in range(len(region_vars)):
                    if region_vars.type[jj] != vars_r.type[k]:
                        continue
                    if region_vars.pos[jj] < vars_r.pos[k] - win:
                        continue
                    if region_vars.pos[jj] > vars_r.pos[k] + win:
                        break
                    if _fuzzy_comp_sites(opt, vars_r.site_tuple(k),
                                         region_vars.site_tuple(jj)) == 0:
                        cate_r[k] = config.NON_VAR
                        break
            vars_r.alle_covs[:, 1] = np.where(cate_r == config.NON_VAR, 0,
                                              alt_cov)
            read_sets.append((rid, vars_r, te_r, cate_r))

    # cross-read merge: matching vars concentrate alt counts on the first
    n_sets = len(read_sets)
    # live var indices per read (snapshot): rows start NON_VAR or 0-count
    # and can never gain counts (matches only move alt mass into
    # already-live v1 rows), so the two-pointer walks only the snapshot
    # lists, re-checking per row for mid-merge deaths
    live = [np.nonzero((c != config.NON_VAR) & (v.alle_covs[:, 1] > 0))[0]
            for _, v, _, c in read_sets]
    for a in range(n_sets - 1):
        if not len(live[a]):
            continue
        for b in range(a + 1, n_sets):
            if not len(live[b]):
                continue
            _, v1, _, c1 = read_sets[a]
            _, v2, _, c2 = read_sets[b]
            la, lb = live[a], live[b]
            ia = ib = 0
            na, nb = len(la), len(lb)
            while ia < na and ib < nb:
                i = int(la[ia])
                j = int(lb[ib])
                if v1.alle_covs[i, 1] <= 0:
                    ia += 1
                    continue
                if v2.alle_covs[j, 1] <= 0:
                    ib += 1
                    continue
                ret = _fuzzy_comp_sites(opt, v1.site_tuple(i),
                                        v2.site_tuple(j))
                if ret == 0:
                    v1.alle_covs[i, 1] += 1
                    v2.alle_covs[j, 1] -= 1
                    ia += 1
                    ib += 1
                elif ret < 0:
                    ia += 1
                else:
                    ib += 1

    keep_rows = []
    for rid, v, te_r, c in read_sets:
        for k in range(len(v)):
            if c[k] == config.NON_VAR or v.alle_covs[k, 1] <= 0:
                continue
            if var_is_cand_somatic(chunk, opt, v, k):
                keep_rows.append((v, te_r, k))
    if not keep_rows:
        return None, None, None, None
    keep_rows.sort(key=lambda r: (int(r[0].pos[r[2]])
                                  if r[0].type[r[2]] == CDIFF
                                  else int(r[0].pos[r[2]]) - 1))
    n = len(keep_rows)
    som = CandVars(
        pos=np.array([r[0].pos[r[2]] for r in keep_rows], dtype=np.int64),
        type=np.array([r[0].type[r[2]] for r in keep_rows], dtype=np.uint8),
        ref_len=np.array([r[0].ref_len[r[2]] for r in keep_rows],
                         dtype=np.int32),
        alt_len=np.array([r[0].alt_len[r[2]] for r in keep_rows],
                         dtype=np.int32),
        alt_seqs=[r[0].alt_seqs[r[2]] for r in keep_rows],
        total_cov=np.zeros(n, dtype=np.int32),
        low_qual_cov=np.zeros(n, dtype=np.int32),
        alle_covs=np.zeros((n, 2), dtype=np.int32),
        strand_covs=np.zeros((n, 2, 2), dtype=np.int32),
        is_homopolymer_indel=np.array(
            [bool(r[0].is_homopolymer_indel[r[2]]) for r in keep_rows]))
    som_te = [r[1][r[2]] for r in keep_rows]
    som_cate = np.full(n, config.CAND_SOMATIC_VAR, dtype=np.int32)
    # re-profile against the cluster reads' digars with the fuzzy somatic
    # join (update_read_vs_somatic_var_profile_from_digar)
    from longcalld_torch.core.profile import update_read_profile
    prof = NoisyProfile(chunk.n_reads, n)

    class _TmpChunk:
        pass

    tmp = _TmpChunk()
    tmp.cand_vars = som
    tmp.var_cate = som_cate
    tmp.alleles = prof.alleles
    tmp.alt_qi = prof.alt_qi
    tmp.read_start_var = prof.start
    tmp.read_end_var = prof.end
    seen = set()
    for _, rows in clusters:
        for rid, _cr in rows:
            if rid in seen:
                continue
            seen.add(rid)
            update_read_profile(opt, tmp, rid, chunk.digars[rid])
    som.alle_covs[:, :] = 0
    som.total_cov[:] = 0
    for rid in seen:
        s, e = int(prof.start[rid]), int(prof.end[rid])
        if s < 0:
            continue
        for k in range(s, e + 1):
            a = int(prof.alleles[rid, k])
            if a >= 0:
                som.alle_covs[k, a] += 1
                som.total_cov[k] += 1
    return som, som_te, som_cate, prof
