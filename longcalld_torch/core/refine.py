"""--refine-aln support: splice noisy-region realignments back into read
digars and rewrite BAM records (pos/CIGAR/NM/MD/cs) from the refined digar.

Re-implements update_digars_from_msa1 + the left/right digar choppers
(reference/src/align.c:1463-1756) and refine_bam1 / update_bam1_tags
(reference/src/bam_utils.c:1726-1942).  Like the reference, adjacent
=/I/D events merge into runs (push_digar0, bam_utils.c:557-614) while X stays
per-base, and a spliced digar that fails the query-index continuity check
(double_check_digar, bam_utils.h:102-120) is discarded in favour of the
original alignment.
"""

from __future__ import annotations

import struct
import sys
from typing import List, Optional, Tuple

import numpy as np

from longcalld_torch.config import CallOpts
from longcalld_torch.core.digar import ReadDigar
from longcalld_torch.core.msa import (LEFT_GAP,                                     RIGHT_GAP, is_both_cover, is_left_cover,
                                    is_right_cover)
from longcalld_torch.io.bam import (CDEL, CDIFF, CEQUAL, CHARD_CLIP, CINS,
                                  CSOFT_CLIP, FSUPPLEMENTARY, BamRecord)

GAP = 5
_NT4 = "ACGTN"
_NT4_LOW = "acgtn"

# (pos, type, len, qi, low_qual)
Event = Tuple[int, int, int, int, bool]


def _digar_events(d: ReadDigar) -> List[Event]:
    return [(int(d.pos[i]), int(d.type[i]), int(d.len[i]), int(d.qi[i]),
             bool(d.low_qual[i])) for i in range(len(d.pos))]


def _qi_end(ev: Event) -> int:
    return ev[3] + ev[2] - 1 if ev[1] in (CDIFF, CEQUAL, CINS) else ev[3]


def _ref_end(ev: Event) -> int:
    return ev[0] + ev[2] - 1 if ev[1] in (CDIFF, CEQUAL, CDEL) else ev[0]


def _left_events(evs: List[Event], read_beg: int, ref_beg: int) -> List[Event]:
    """collect_left_digars (align.c:1463-1498)."""
    out: List[Event] = []
    for i, ev in enumerate(evs):
        pos, op, ln, qi, lq = ev
        if i == 0 and op in (CSOFT_CLIP, CHARD_CLIP):
            out.append(ev)
            continue
        if qi >= read_beg and pos >= ref_beg:
            break
        if _qi_end(ev) < read_beg and _ref_end(ev) < ref_beg:
            out.append(ev)
        else:  # partial: chop X=I by query index, D by ref position
            if op in (CINS, CEQUAL, CDIFF):
                out.append((pos, op, read_beg - qi, qi, lq))
            elif op == CDEL:
                out.append((pos, op, ref_beg - pos, qi, lq))
            break
    return out


def _right_events(evs: List[Event], read_end: int, ref_end: int) -> List[Event]:
    """collect_right_digars (align.c:1500-1541)."""
    out: List[Event] = []
    n = len(evs)
    for i, ev in enumerate(evs):
        pos, op, ln, qi, lq = ev
        if i == n - 1 and op in (CSOFT_CLIP, CHARD_CLIP):
            out.append(ev)
            continue
        if _qi_end(ev) <= read_end and _ref_end(ev) <= ref_end:
            continue
        if qi > read_end and pos > ref_end:
            out.append(ev)
        else:  # partial
            if op in (CINS, CEQUAL, CDIFF):
                new_len = _qi_end(ev) - read_end
                new_pos = pos if op == CINS else ref_end + 1
                out.append((new_pos, op, new_len, read_end + 1, lq))
            elif op == CDEL:
                out.append((ref_end + 1, op, _ref_end(ev) - ref_end, qi, lq))
    return out


def _msa_events(t_aln: np.ndarray, q_aln: np.ndarray, read_pos: int,
                ref_pos: int, lo: int, hi: int) -> List[Event]:
    """Per-column ref<->read events over msa columns [lo, hi]
    (collect_full_msa_digars core loop, align.c:1543-1581)."""
    out: List[Event] = []
    for i in range(len(t_aln)):
        t, q = int(t_aln[i]), int(q_aln[i])
        if t == GAP and q == GAP:
            continue
        if t != GAP and q != GAP:
            if lo <= i <= hi:
                out.append((ref_pos, CEQUAL if t == q else CDIFF, 1,
                            read_pos, False))
            read_pos += 1
            ref_pos += 1
        elif q != GAP:  # INS
            if lo <= i <= hi:
                out.append((ref_pos, CINS, 1, read_pos, False))
            read_pos += 1
        else:  # DEL
            if lo <= i <= hi:
                out.append((ref_pos, CDEL, 1, read_pos, False))
            ref_pos += 1
    return out


def _merge_runs(evs: List[Event]) -> List[Event]:
    """push_digar0-style merging: adjacent =/I/D with equal low-qual flags
    fuse; X and clips never do (same_digar1, bam_utils.c:557-562).  Zero and
    negative lengths are dropped like push_digar0's len<=0 guard."""
    out: List[Event] = []
    for ev in evs:
        if ev[2] <= 0:
            continue
        if (out and ev[1] in (CEQUAL, CINS, CDEL)
                and out[-1][1] == ev[1] and out[-1][4] == ev[4]):
            p = out[-1]
            out[-1] = (p[0], p[1], p[2] + ev[2], p[3], p[4])
        else:
            out.append(ev)
    return out


def _events_valid(evs: List[Event]) -> bool:
    """double_check_digar (bam_utils.h:102-120): query-index continuity.
    H is treated as query-consuming (palindromic S->H events keep their
    original query span)."""
    if not evs:
        return False
    for i in range(1, len(evs)):
        prev = evs[i - 1]
        qi = prev[3] + (prev[2] if prev[1] in (CEQUAL, CDIFF, CINS,
                                               CSOFT_CLIP, CHARD_CLIP) else 0)
        if qi != evs[i][3]:
            return False
    return True


def events_qlen(evs: List[Event]) -> int:
    """digar2qlen (bam_utils.h:122-134)."""
    if not evs:
        return 0
    last = evs[-1]
    q = last[3]
    if last[1] in (CEQUAL, CDIFF, CINS, CSOFT_CLIP, CHARD_CLIP):
        q += last[2]
    return q


# ---------- vectorized splice (production path) ----------
#
# The tuple-list implementation below (_splice_read_digar_ref) is the
# direct transcription of the reference choppers and stays as the oracle;
# the array path here is its vectorization (equality fuzz-checked in
# tests/test_refine_vectorized.py), collapsing the per-event Python work
# that dominated the -s / --refine-aln profile.

_Q_SET = (CEQUAL, CDIFF, CINS)
_R_SET = (CEQUAL, CDIFF, CDEL)


def _ev_cols(d: ReadDigar):
    """(pos, typ, len, qi, lq, qi_end, ref_end) int64 columns, cached."""
    c = getattr(d, "_splice_cols", None)
    if c is not None:
        return c
    typ = d.type
    ln = d.len.astype(np.int64)
    qi = d.qi.astype(np.int64)
    pos = d.pos.astype(np.int64)
    qspan = (typ == CEQUAL) | (typ == CDIFF) | (typ == CINS)
    rspan = (typ == CEQUAL) | (typ == CDIFF) | (typ == CDEL)
    qe = qi + np.where(qspan, ln - 1, 0)
    re_ = pos + np.where(rspan, ln - 1, 0)
    c = (pos, typ.astype(np.int64), ln, qi, d.low_qual.astype(bool), qe, re_)
    d._splice_cols = c
    return c


def _left_arrays(d: ReadDigar, read_beg: int, ref_beg: int):
    """collect_left_digars as (column arrays): [clip0?] + whole prefix +
    optional chopped boundary event."""
    pos, typ, ln, qi, lq, qe, re_ = _ev_cols(d)
    n = len(pos)
    segs = []
    start = 0
    if n and typ[0] in (CSOFT_CLIP, CHARD_CLIP):
        segs.append(tuple(a[0:1] for a in (pos, typ, ln, qi, lq)))
        start = 1
    whole = (qe < read_beg) & (re_ < ref_beg)
    sub = whole[start:]
    k = start + (int(np.argmin(sub)) if not sub.all() else len(sub))
    if k > start:
        segs.append(tuple(a[start:k] for a in (pos, typ, ln, qi, lq)))
    if k < n and not (qi[k] >= read_beg and pos[k] >= ref_beg):
        t = int(typ[k])
        if t in _Q_SET:
            segs.append((pos[k:k + 1], typ[k:k + 1],
                         np.array([read_beg - qi[k]]), qi[k:k + 1],
                         lq[k:k + 1]))
        elif t == CDEL:
            segs.append((pos[k:k + 1], typ[k:k + 1],
                         np.array([ref_beg - pos[k]]), qi[k:k + 1],
                         lq[k:k + 1]))
    return segs


def _right_arrays(d: ReadDigar, read_end: int, ref_end: int):
    """collect_right_digars as column arrays: per-event skip / keep /
    chop, with the trailing-clip special."""
    pos, typ, ln, qi, lq, qe, re_ = _ev_cols(d)
    n = len(pos)
    last_clip = n > 0 and typ[n - 1] in (CSOFT_CLIP, CHARD_CLIP)
    m = n - 1 if last_clip else n
    p, t, l, q, z, e, r = (a[:m] for a in (pos, typ, ln, qi, lq, qe, re_))
    skip = (e <= read_end) & (r <= ref_end)
    whole = (q > read_end) & (p > ref_end)
    chop = ~skip & ~whole
    is_q = (t == CEQUAL) | (t == CDIFF) | (t == CINS)
    is_d = t == CDEL
    keep = ~skip & ~(chop & ~(is_q | is_d))
    np_ = np.where(chop & is_q & (t != CINS), ref_end + 1,
                   np.where(chop & is_d, ref_end + 1, p))
    nl = np.where(chop & is_q, e - read_end,
                  np.where(chop & is_d, r - ref_end, l))
    nq = np.where(chop & is_q, read_end + 1, q)
    segs = [(np_[keep], t[keep], nl[keep], nq[keep], z[keep])]
    if last_clip:
        segs.append(tuple(a[n - 1:n] for a in (pos, typ, ln, qi, lq)))
    return segs


def _msa_arrays(t_aln: np.ndarray, q_aln: np.ndarray, read_pos: int,
                ref_pos: int, lo: int, hi: int):
    """collect_full_msa_digars core loop as column arrays (per-column
    events; the shared merge pass fuses the runs)."""
    tg = t_aln != GAP
    qg = q_aln != GAP
    rd = np.cumsum(qg)
    rf = np.cumsum(tg)
    sel = (tg | qg).copy()
    if lo > 0:
        sel[:lo] = False
    if hi < len(sel) - 1:
        sel[hi + 1:] = False
    idx = np.nonzero(sel)[0]
    tgi = tg[idx]
    qgi = qg[idx]
    both = tgi & qgi
    typ = np.where(both,
                   np.where(t_aln[idx] == q_aln[idx], CEQUAL, CDIFF),
                   np.where(qgi, CINS, CDEL)).astype(np.int64)
    pos = ref_pos + rf[idx] - tgi
    qpos = read_pos + rd[idx] - qgi
    ones = np.ones(len(idx), dtype=np.int64)
    return [(pos, typ, ones, qpos, np.zeros(len(idx), dtype=bool))]


def _merge_valid_build(d: ReadDigar, segs) -> Optional[ReadDigar]:
    """Concatenate segments, merge runs, validate, build the new digar."""
    if not segs:
        return None
    pos = np.concatenate([s[0] for s in segs]).astype(np.int64)
    typ = np.concatenate([s[1] for s in segs]).astype(np.int64)
    ln = np.concatenate([s[2] for s in segs]).astype(np.int64)
    qi = np.concatenate([s[3] for s in segs]).astype(np.int64)
    lq = np.concatenate([s[4] for s in segs]).astype(bool)
    keep = ln > 0
    pos, typ, ln, qi, lq = (a[keep] for a in (pos, typ, ln, qi, lq))
    if not len(pos):
        return None
    mg = (typ == CEQUAL) | (typ == CINS) | (typ == CDEL)
    same = mg[1:] & (typ[1:] == typ[:-1]) & (lq[1:] == lq[:-1])
    starts = np.concatenate([[0], np.nonzero(~same)[0] + 1])
    pos = pos[starts]
    typ = typ[starts]
    ln = np.add.reduceat(ln, starts)
    qi = qi[starts]
    lq = lq[starts]
    # double_check_digar: query-index continuity
    qcons = ((typ == CEQUAL) | (typ == CDIFF) | (typ == CINS)
             | (typ == CSOFT_CLIP) | (typ == CHARD_CLIP))
    nxt = qi + np.where(qcons, ln, 0)
    if len(pos) == 0 or not bool(np.all(nxt[:-1] == qi[1:])):
        return None
    nonclip = (typ != CSOFT_CLIP) & (typ != CHARD_CLIP)
    if not nonclip.any():
        return None
    rcons = (typ == CEQUAL) | (typ == CDIFF) | (typ == CDEL)
    beg = int(pos[nonclip][0])
    end = int((pos + np.where(rcons, ln, 1) - 1)[rcons].max()) \
        if rcons.any() else beg
    return ReadDigar(beg=beg, end=end, is_rev=d.is_rev, pos=pos,
                     type=typ.astype(np.uint8), len=ln.astype(np.int32),
                     qi=qi.astype(np.int32), low_qual=lq, seq=d.seq,
                     qual=d.qual, noisy_regs=d.noisy_regs, qlen=d.qlen)


def splice_read_digar(opt: CallOpts, d: ReadDigar, cover: int, reg_beg: int,
                      reg_end: int, read_beg: int, read_end: int,
                      t_aln: np.ndarray, q_aln: np.ndarray
                      ) -> Optional[ReadDigar]:
    """update_digars_from_msa1 (align.c:1701-1743), vectorized.  Returns
    the new ReadDigar, or None when no update applies (not covering, or
    the spliced event list fails validation)."""
    if cover == 0:
        return None
    L = len(t_aln)
    segs = []
    if (is_both_cover(cover)
            or (is_left_cover(cover) and (cover & RIGHT_GAP))
            or (is_right_cover(cover) and (cover & LEFT_GAP))):
        segs += _left_arrays(d, read_beg, reg_beg)
        segs += _msa_arrays(t_aln, q_aln, read_beg, reg_beg, 0, L - 1)
        segs += _right_arrays(d, read_end, reg_end)
    elif is_left_cover(cover):
        # (collect_left_msa_digars, align.c:1583-1640)
        tg = t_aln != GAP
        qg = q_aln != GAP
        sfx = np.logical_or.accumulate(tg[::-1])[::-1]
        cand = np.nonzero(qg & sfx)[0]
        hi = int(cand[-1]) if len(cand) else L - 1
        right_skipped = int((qg & ~sfx).sum())
        n_read = int(qg.sum())
        read_end_pos = read_beg - 1 + n_read
        segs += _left_arrays(d, read_beg, reg_beg)
        segs += _msa_arrays(t_aln, q_aln, read_beg, reg_beg, 0, hi)
        ref_pos = reg_beg + int(tg[:hi + 1].sum())
        if read_end_pos < d.qlen - 1 or right_skipped > 0:
            segs.append((np.array([ref_pos]), np.array([CSOFT_CLIP]),
                         np.array([d.qlen - 1 - read_end_pos
                                   + right_skipped]),
                         np.array([read_end_pos + 1]),
                         np.zeros(1, dtype=bool)))
    elif is_right_cover(cover):
        # (collect_right_msa_digars, align.c:1642-1698)
        tg = t_aln != GAP
        qg = q_aln != GAP
        pre = np.logical_or.accumulate(tg)
        cand = np.nonzero(qg & pre)[0]
        lo = int(cand[0]) if len(cand) else 0
        left_skipped = int((qg & ~pre).sum())
        n_read = int(qg.sum())
        read_pos = read_end + 1 - n_read
        qidx = np.nonzero(qg)[0]
        ref_pos = (reg_end + 1 - int(tg[int(qidx[0]):].sum())
                   if len(qidx) else reg_beg)
        if read_pos > 0 or left_skipped > 0:
            segs.append((np.array([ref_pos]), np.array([CSOFT_CLIP]),
                         np.array([read_pos + left_skipped]),
                         np.array([0]), np.zeros(1, dtype=bool)))
        segs += _msa_arrays(t_aln, q_aln, read_pos, reg_beg, lo, L - 1)
        segs += _right_arrays(d, read_end, reg_end)
    else:
        return None
    return _merge_valid_build(d, segs)


def _splice_read_digar_ref(opt: CallOpts, d: ReadDigar, cover: int,
                           reg_beg: int, reg_end: int, read_beg: int,
                           read_end: int, t_aln: np.ndarray,
                           q_aln: np.ndarray) -> Optional[ReadDigar]:
    """The direct tuple-list transcription of update_digars_from_msa1
    (align.c:1701-1743) — kept as the oracle for the vectorized path."""
    if cover == 0:
        return None
    evs = _digar_events(d)
    L = len(t_aln)
    new: List[Event] = []
    if (is_both_cover(cover)
            or (is_left_cover(cover) and (cover & RIGHT_GAP))
            or (is_right_cover(cover) and (cover & LEFT_GAP))):
        new += _left_events(evs, read_beg, reg_beg)
        new += _msa_events(t_aln, q_aln, read_beg, reg_beg, 0, L - 1)
        new += _right_events(evs, read_end, reg_end)
    elif is_left_cover(cover):
        # read's right end lies inside the region: keep the left chop, then
        # msa columns up to the last read base that still has ref coverage;
        # trailing read bases become a soft clip
        # (collect_left_msa_digars, align.c:1583-1640)
        hi = L - 1
        right_skipped = 0
        covered = False
        for i in range(L - 1, -1, -1):
            if t_aln[i] != GAP:
                covered = True
            if q_aln[i] != GAP:
                if covered:
                    hi = i
                    break
                right_skipped += 1
        n_read = int((q_aln != GAP).sum())
        read_end_pos = read_beg - 1 + n_read
        new += _left_events(evs, read_beg, reg_beg)
        new += _msa_events(t_aln, q_aln, read_beg, reg_beg, 0, hi)
        # ref position after the emitted span (the reference's loop stops at
        # right_read_end, so only ref columns up to ``hi`` advance it)
        ref_pos = reg_beg + int((t_aln[:hi + 1] != GAP).sum())
        if read_end_pos < d.qlen - 1 or right_skipped > 0:
            new.append((ref_pos, CSOFT_CLIP,
                        d.qlen - 1 - read_end_pos + right_skipped,
                        read_end_pos + 1, False))
    elif is_right_cover(cover):
        # read starts inside the region (collect_right_msa_digars,
        # align.c:1642-1698): leading uncovered read bases + the read prefix
        # before the region become a soft clip
        lo = 0
        left_skipped = 0
        covered = False
        for i in range(L):
            if t_aln[i] != GAP:
                covered = True
            if q_aln[i] != GAP:
                if covered:
                    lo = i
                    break
                left_skipped += 1
        n_read = int((q_aln != GAP).sum())
        read_pos = read_end + 1 - n_read
        # first ref position aligned to a read base
        ref_pos = reg_beg
        _rp = reg_end + 1
        for i in range(L - 1, -1, -1):
            if t_aln[i] != GAP:
                _rp -= 1
            if q_aln[i] != GAP:
                ref_pos = _rp
        if read_pos > 0 or left_skipped > 0:
            new.append((ref_pos, CSOFT_CLIP, read_pos + left_skipped, 0,
                        False))
        new += _msa_events(t_aln, q_aln, read_pos, reg_beg, lo, L - 1)
        new += _right_events(evs, read_end, reg_end)
    else:
        return None
    new = _merge_runs(new)
    if not _events_valid(new):
        return None
    pos = np.array([e[0] for e in new], dtype=np.int64)
    typ = np.array([e[1] for e in new], dtype=np.uint8)
    lens = np.array([e[2] for e in new], dtype=np.int32)
    qi = np.array([e[3] for e in new], dtype=np.int32)
    lq = np.array([e[4] for e in new], dtype=bool)
    nonclip = ~np.isin(typ, (CSOFT_CLIP, CHARD_CLIP))
    if not nonclip.any():
        return None
    ref_consume = np.isin(typ, (CEQUAL, CDIFF, CDEL))
    beg = int(pos[nonclip][0])
    end = int((pos + np.where(ref_consume, lens, 1) - 1)[ref_consume].max()) \
        if ref_consume.any() else beg
    return ReadDigar(beg=beg, end=end, is_rev=d.is_rev, pos=pos, type=typ,
                     len=lens, qi=qi, low_qual=lq, seq=d.seq, qual=d.qual,
                     noisy_regs=d.noisy_regs, qlen=d.qlen)


# ---------- BAM record rewriting ----------

def digar_to_cigar(d: ReadDigar, is_supplementary: bool) -> List[Tuple[int, int]]:
    """CIGAR from digar events, merging adjacent ops; hard clips on primary
    alignments revert to soft clips (refine_bam1, bam_utils.c:1895-1901 —
    palindromic clips were S in the input record, so the bases are present)."""
    out: List[Tuple[int, int]] = []
    for i in range(len(d.pos)):
        op, ln = int(d.type[i]), int(d.len[i])
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + ln)
        else:
            out.append((op, ln))
    if out and not is_supplementary:
        if out[0][0] == CHARD_CLIP:
            out[0] = (CSOFT_CLIP, out[0][1])
        if out[-1][0] == CHARD_CLIP:
            out[-1] = (CSOFT_CLIP, out[-1][1])
        # re-merge S runs the conversion may have created
        merged: List[Tuple[int, int]] = []
        for op, ln in out:
            if merged and merged[-1][0] == op:
                merged[-1] = (op, merged[-1][1] + ln)
            else:
                merged.append((op, ln))
        out = merged
    return out


def nm_from_digar(d: ReadDigar) -> int:
    """get_nm_from_digar (bam_utils.c:1726-1737)."""
    m = np.isin(d.type, (CDIFF, CINS, CDEL))
    return int(d.len[m].sum())


def md_from_digar(d: ReadDigar, ref4: np.ndarray, ref_beg: int,
                  ref_end: int) -> str:
    """get_md_from_digar (bam_utils.c:1739-1771); positions outside the
    loaded window render as 'N'."""
    parts: List[str] = []
    eq = 0
    for i in range(len(d.pos)):
        op, ln, pos = int(d.type[i]), int(d.len[i]), int(d.pos[i])
        if op == CEQUAL:
            eq += ln
        elif op == CDIFF:
            parts.append(str(eq))
            for j in range(ln):
                p = pos + j
                parts.append(_NT4[ref4[p - ref_beg]]
                             if ref_beg <= p < ref_end else "N")
            eq = 0
        elif op == CDEL:
            parts.append(str(eq))
            parts.append("^")
            for j in range(ln):
                p = pos + j
                parts.append(_NT4[ref4[p - ref_beg]]
                             if ref_beg <= p < ref_end else "N")
            eq = 0
    if eq > 0:
        parts.append(str(eq))
    return "".join(parts)


def cs_from_digar(d: ReadDigar, ref4: np.ndarray, ref_beg: int,
                  ref_end: int) -> str:
    """get_cs_from_digar (bam_utils.c:1773-1805)."""
    parts: List[str] = []
    for i in range(len(d.pos)):
        op, ln, pos = int(d.type[i]), int(d.len[i]), int(d.pos[i])
        if op == CEQUAL:
            parts.append(":%d" % ln)
        elif op == CDIFF:
            alt = d.alt_seq(i)
            for j in range(ln):
                p = pos + j
                rb = (_NT4_LOW[ref4[p - ref_beg]]
                      if ref_beg <= p < ref_end else "n")
                parts.append("*" + rb + _NT4_LOW[alt[j]])
        elif op == CINS:
            alt = d.alt_seq(i)
            parts.append("+" + "".join(_NT4_LOW[b] for b in alt))
        elif op == CDEL:
            seg = []
            for j in range(ln):
                p = pos + j
                seg.append(_NT4_LOW[ref4[p - ref_beg]]
                           if ref_beg <= p < ref_end else "n")
            parts.append("-" + "".join(seg))
    return "".join(parts)


def _reg2bin(beg: int, end: int) -> int:
    """BAI bin for [beg, end) (SAM spec reg2bin)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _replace_z_tag(raw: bytearray, rec: BamRecord, name: bytes,
                   value: str) -> bytearray:
    """Delete tag ``name`` (Z) and append the new value at the end, mirroring
    bam_aux_del + bam_aux_append ordering."""
    return _replace_tag(raw, rec, name,
                        name + b"Z" + value.encode() + b"\x00")


def _replace_tag(raw: bytearray, rec: BamRecord, name: bytes,
                 encoded: bytes) -> bytearray:
    out = bytearray(raw[:rec._tag_off])
    n = len(raw)
    off = rec._tag_off
    while off + 3 <= n:
        start = off
        tag = bytes(raw[off:off + 2])
        typ = chr(raw[off + 2])
        off += 3
        if typ in "cCA":
            off += 1
        elif typ in "sS":
            off += 2
        elif typ in "iIf":
            off += 4
        elif typ in "ZH":
            off = raw.index(b"\x00", off) + 1
        elif typ == "B":
            st = chr(raw[off])
            cnt = struct.unpack_from("<i", raw, off + 1)[0]
            sz = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[st]
            off += 5 + cnt * sz
        else:
            break
        if tag != name:
            out += raw[start:off]
    out += encoded
    return out


def refine_record_bytes(opt: CallOpts, rec: BamRecord, d: ReadDigar,
                        ref4: np.ndarray, ref_beg: int,
                        ref_end: int) -> Optional[bytes]:
    """refine_bam1 + update_bam1_tags (bam_utils.c:1840-1942): rebuild the
    raw record with the refined pos/CIGAR and recomputed NM/MD/cs tags.
    Returns None (record written unchanged) when the digar's query length
    no longer matches the record (write_processed_read_to_bam's guard)."""
    if events_qlen(_digar_events(d)) != rec.l_seq:
        print(f"[refine] qlen mismatch for {rec.qname}; writing original",
              file=sys.stderr)
        return None
    new_pos = int(d.pos[0]) - 1
    if new_pos < 0:
        return None
    cigar = digar_to_cigar(d, bool(rec.flag & FSUPPLEMENTARY))
    consume_q = sum(ln for op, ln in cigar
                    if op in (CEQUAL, CDIFF, CINS, CSOFT_CLIP))
    if consume_q != rec.l_seq:  # genuine hard clips: cannot rewrite safely
        return None
    old_cig = rec.cigar_array()
    if (new_pos == rec.pos and len(old_cig) == len(cigar)
            and all(int(old_cig[i, 0]) == cigar[i][0]
                    and int(old_cig[i, 1]) == cigar[i][1]
                    for i in range(len(cigar)))):
        return None  # cigar_is_idential early-out (bam_utils.c:1903)
    raw = rec._raw
    ref_span = sum(ln for op, ln in cigar if op in (CEQUAL, CDIFF, CDEL))
    cig_bytes = b"".join(struct.pack("<I", (ln << 4) | op)
                         for op, ln in cigar)
    (tid, _pos, l_read_name, mapq, _bin, _n_cigar, flag, l_seq,
     ntid, npos, tlen) = struct.unpack_from("<iiBBHHHiiii", raw, 0)
    head = struct.pack("<iiBBHHHiiii", tid, new_pos, l_read_name, mapq,
                       _reg2bin(new_pos, new_pos + max(ref_span, 1)),
                       len(cigar), flag, l_seq, ntid, npos, tlen)
    body = bytearray(head)
    body += raw[32:rec._cigar_off]          # qname
    body += cig_bytes                        # new cigar
    body += raw[rec._seq_off:rec._tag_off]   # seq + qual
    body += raw[rec._tag_off:]               # aux
    new = BamRecord(bytes(body))
    out = bytearray(new._raw)
    # tags move to the end only when their value actually changed, matching
    # bam_aux_del + bam_aux_append in update_bam1_tags
    old_nm = rec.get_tag("NM")
    if old_nm is not None:
        nm = nm_from_digar(d)
        if nm != old_nm:
            out = _replace_tag(out, new, b"NM",
                               b"NMi" + struct.pack("<i", nm))
            new = BamRecord(bytes(out))
    old_md = rec.get_tag("MD")
    if old_md is not None:
        md = md_from_digar(d, ref4, ref_beg, ref_end)
        if md != old_md:
            out = _replace_z_tag(out, new, b"MD", md)
            new = BamRecord(bytes(out))
    old_cs = rec.get_tag("cs")
    if old_cs is not None:
        cs = cs_from_digar(d, ref4, ref_beg, ref_end)
        if cs != old_cs:
            out = _replace_z_tag(out, new, b"cs", cs)
    return bytes(out)
