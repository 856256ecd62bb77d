"""Detailed-CIGAR ("digar") extraction and per-read noisy-region detection.

Re-implements the reference's digar collectors
(collect_digar_from_eqx_cigar, reference/src/bam_utils.c:701-841, and
the ref-compare fallback :1176-1327) as vectorized numpy passes: a read's
CIGAR is expanded into an event table (pos/type/len/qi/low-qual), the
X/gap-density sliding window (xid_queue_t, src/bam_utils.c:123-200) becomes a
two-pointer prefix-sum sweep, and clip/skip policies follow the reference
constants.

Events use BAM op codes: 7 '=', 8 'X', 1 'I', 2 'D', 4 'S', 5 'H'.
``pos`` is the 1-based reference position; ``qi`` the 0-based query index
(for DEL: the first read base after the deletion).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from longcalld_torch.config import CallOpts
from longcalld_torch.io.bam import (CDEL, CDIFF, CEQUAL, CHARD_CLIP, CINS,
                                  CMATCH, CREF_SKIP, CSOFT_CLIP, BamRecord)
from longcalld_torch.utils.intervals import IntervalSet


@dataclasses.dataclass
class ReadDigar:
    """Per-read event table + copies of seq/qual (digar_t analog)."""
    beg: int            # 1-based ref start
    end: int            # 1-based ref end (inclusive)
    is_rev: bool
    pos: np.ndarray     # int64 (n_events,)
    type: np.ndarray    # uint8
    len: np.ndarray     # int32
    qi: np.ndarray      # int32
    low_qual: np.ndarray  # bool
    seq: np.ndarray     # nt4 codes, full read
    qual: np.ndarray    # uint8, full read
    noisy_regs: IntervalSet
    qlen: int

    def alt_seq(self, i: int) -> np.ndarray:
        """Alt bases of event i (X/I only)."""
        return self.seq[self.qi[i]:self.qi[i] + self.len[i]]

    def var_mask(self) -> np.ndarray:
        t = self.type
        return (t == CDIFF) | (t == CINS) | (t == CDEL)


# op -> consumes-ref / consumes-query (BAM op codes 0..8)
_OP_CONSUMES_R = np.zeros(16, dtype=np.int64)
_OP_CONSUMES_R[[CMATCH, CEQUAL, CDIFF, CDEL, CREF_SKIP]] = 1
_OP_CONSUMES_Q = np.zeros(16, dtype=np.int64)
_OP_CONSUMES_Q[[CMATCH, CEQUAL, CDIFF, CINS, CSOFT_CLIP]] = 1


def _expand_cigar_events(cig: np.ndarray, pos0: int) -> Tuple[np.ndarray, ...]:
    """Expand (op,len) rows into per-event rows with per-base X expansion.

    Returns (pos, type, length, qi, op_index) arrays; op_index maps each event
    back to its originating CIGAR row (clips keep their row).
    """
    ops = cig[:, 0]
    lens = cig[:, 1]
    consume_r = _OP_CONSUMES_R[ops] * lens
    consume_q = _OP_CONSUMES_Q[ops] * lens
    pos_start = pos0 + 1 + np.concatenate([[0], np.cumsum(consume_r)[:-1]])
    qi_start = np.concatenate([[0], np.cumsum(consume_q)[:-1]])

    is_x = ops == CDIFF
    reps = np.where(is_x, lens, 1)
    ev_op = np.repeat(ops, reps)
    ev_row = np.repeat(np.arange(len(ops)), reps)
    ev_pos = np.repeat(pos_start, reps)
    ev_qi = np.repeat(qi_start, reps)
    ev_len = np.repeat(np.where(is_x, 1, lens), reps)
    # within-X offsets
    if is_x.any():
        offs = np.arange(len(ev_op)) - np.repeat(
            np.concatenate([[0], np.cumsum(reps)[:-1]]), reps)
        xmask = ev_op == CDIFF
        ev_pos = ev_pos + np.where(xmask, offs, 0)
        ev_qi = ev_qi + np.where(xmask, offs, 0)
    return ev_pos.astype(np.int64), ev_op.astype(np.uint8), \
        ev_len.astype(np.int32), ev_qi.astype(np.int32), ev_row


def _detect_noisy_regions(push_pos: np.ndarray, push_len: np.ndarray,
                          push_cnt: np.ndarray, win: int, max_s: int
                          ) -> List[Tuple[int, int, int]]:
    """Sliding-window X/gap density detector.

    Mirrors push_xid_size_queue_win (src/bam_utils.c:161-200): an event at
    ``pos`` keeps queue entries with entry_pos+entry_len-1 > pos-win; if the
    queued count exceeds ``max_s`` the whole queued span becomes a dense
    region, chained regions merge, and the label is
    max(sum of queued counts, span length).

    Returns [(start0, end, label)] with start0 = 1-based start - 1 (the
    reference's cr_add convention).
    """
    n = len(push_pos)
    if n == 0:
        return []
    ends = push_pos + push_len - 1
    # front_i = first j with ends[j] > pos_i - win  (ends is nondecreasing
    # because within-read events don't overlap on the reference)
    fronts = np.searchsorted(ends, push_pos - win, side="right")
    csum = np.concatenate([[0], np.cumsum(push_cnt)])
    wcount = csum[np.arange(n) + 1] - csum[fronts]
    dense = wcount > max_s
    out: List[Tuple[int, int, int]] = []
    cur = None  # (start, end, q_start, q_end)
    for i in np.nonzero(dense)[0]:
        ns = int(push_pos[fronts[i]])
        ne = int(push_pos[i] + push_len[i])
        if cur is None:
            cur = [ns, ne, int(fronts[i]), int(i)]
        elif ns <= cur[1]:
            cur[1] = ne
            cur[3] = int(i)
        else:
            var_size = int(csum[cur[3] + 1] - csum[cur[2]])
            var_size = max(var_size, cur[1] - cur[0] + 1)
            out.append((cur[0] - 1, cur[1], var_size))
            cur = [ns, ne, int(fronts[i]), int(i)]
    if cur is not None:
        var_size = int(csum[cur[3] + 1] - csum[cur[2]])
        var_size = max(var_size, cur[1] - cur[0] + 1)
        out.append((cur[0] - 1, cur[1], var_size))
    return out


def check_ont_palindrome(primary_pos: int, primary_end: int,
                         sa_pos: int, sa_end: int) -> bool:
    """SA-entry overlap >=90% of primary span (src/bam_utils.c:642-654)."""
    primary_len = primary_end - primary_pos + 1
    overlap = 0
    if sa_pos <= primary_pos:
        if sa_end >= primary_end:
            overlap = primary_len
        elif sa_end >= primary_pos:
            overlap = sa_end - primary_pos + 1
    elif sa_pos <= primary_end:
        overlap = (primary_end - sa_pos + 1 if sa_end >= primary_end
                   else sa_end - sa_pos + 1)
    return overlap >= primary_len * 0.9


def is_ont_palindrome_clip(opt: CallOpts, read: BamRecord) -> bool:
    """Inverted-duplicate (palindrome) artifact detection via the SA tag
    (src/bam_utils.c:659-698); ONT only."""
    if not opt.is_ont:
        return False
    sa = read.get_tag("SA")
    if not sa:
        return False
    primary_pos, primary_end = read.pos + 1, read.endpos
    for entry in sa.rstrip(";").split(";"):
        fields = entry.split(",")
        if len(fields) < 6:
            continue
        sa_pos = int(fields[1])
        sa_end = sa_pos
        for m in __import__("re").finditer(r"(\d+)([MIDNSHP=X])", fields[3]):
            if m.group(2) in "MD=X":
                sa_end += int(m.group(1))
        if check_ont_palindrome(primary_pos, primary_end, sa_pos, sa_end):
            return True
    return False


def collect_digar_eqx(read: BamRecord, opt: CallOpts, reg_beg: int,
                      reg_end: int, whole_ref_len: int,
                      ref_nt4_window: Optional[np.ndarray] = None,
                      ref_window_beg: int = 0
                      ) -> Tuple[Optional[ReadDigar],
                                 List[Tuple[int, int, int]], bool]:
    """digar + noisy regions from an =/X CIGAR read.

    Returns (digar | None-if-skipped, chunk-level noisy regions to add,
    is_palindrome).  Skip policy: total noisy length > 50% of the mapped span
    or #var events > 5% of the span (src/bam_utils.c:807-813).
    """
    cig = read.cigar_array()
    seq = read.seq_nt4()
    qual = read.qual()
    min_bq = opt.min_bq
    pos0 = read.pos
    beg, end = pos0 + 1, read.endpos

    palindrome = is_ont_palindrome_clip(opt, read)
    left_clip_pal = palindrome and read.is_rev
    right_clip_pal = palindrome and not read.is_rev

    ev_pos, ev_op, ev_len, ev_qi, ev_row = _expand_cigar_events(cig, pos0)

    if (ev_op == CMATCH).any():
        raise ValueError("'M' op in presumed EQX CIGAR")
    keep = ev_op != CREF_SKIP
    ev_pos, ev_op, ev_len, ev_qi, ev_row = (
        ev_pos[keep], ev_op[keep], ev_len[keep], ev_qi[keep], ev_row[keep])

    # low-qual flags (src/bam_utils.c:728-770)
    good_q = qual >= min_bq
    cum_good = np.empty(len(good_q) + 1, dtype=np.int64)
    cum_good[0] = 0
    np.cumsum(good_q, out=cum_good[1:])
    low = np.zeros(len(ev_op), dtype=bool)
    xm = ev_op == CDIFF
    low[xm] = ~good_q[ev_qi[xm]]
    dm = ev_op == CDEL
    if dm.any():
        qi_d = ev_qi[dm]
        prev_ok = (qi_d == 0) | good_q[np.maximum(qi_d - 1, 0)]
        cur_ok = good_q[np.minimum(qi_d, len(qual) - 1)]
        low[dm] = ~(prev_ok & cur_ok)
    im = ev_op == CINS
    if im.any():
        qi_i = ev_qi[im]
        n_good = cum_good[np.minimum(qi_i + ev_len[im], len(qual))] - cum_good[qi_i]
        low[im] = n_good == 0

    # hard-clip palindromic clips (src/bam_utils.c:773-774)
    clip_m = (ev_op == CSOFT_CLIP) | (ev_op == CHARD_CLIP)
    if palindrome and clip_m.any():
        if left_clip_pal:
            ev_op = np.where(clip_m & (ev_row == 0), CHARD_CLIP, ev_op)
        if right_clip_pal:
            ev_op = np.where(clip_m & (ev_row != 0), CHARD_CLIP, ev_op)

    # noisy-region pushes: non-low-qual X (pos,1,1), DEL (pos,len,len),
    # INS (pos,0,len)
    push_m = ((xm | dm | im) & ~low)
    p_pos = ev_pos[push_m]
    p_type = ev_op[push_m]
    p_len = np.where(p_type == CDEL, ev_len[push_m],
                     np.where(p_type == CDIFF, 1, 0)).astype(np.int64)
    p_cnt = np.where(p_type == CDIFF, 1, ev_len[push_m]).astype(np.int64)
    regions = _detect_noisy_regions(p_pos, p_len, p_cnt,
                                    opt.noisy_reg_slide_win,
                                    opt.noisy_reg_max_xgaps)

    n_total_cand_vars = int(xm.sum() + dm.sum() + im.sum())

    # long end-clips add noisy flanks (src/bam_utils.c:777-788); "left" = the
    # first CIGAR op, any other clip is treated as a right clip like the C.
    for i in np.nonzero(clip_m)[0]:
        at_left = ev_row[i] == 0
        cpos = int(ev_pos[i])
        if (at_left and cpos > 10) or (not at_left and cpos < whole_ref_len - 10):
            if ev_len[i] > opt.end_clip_reg:
                if at_left and not left_clip_pal:
                    if cpos > 1:
                        regions.append((cpos - 1,
                                        cpos + opt.end_clip_reg_flank_win, 0))
                    n_total_cand_vars += 1
                elif not at_left and not right_clip_pal:
                    if cpos < whole_ref_len:
                        regions.append((cpos - 1 - opt.end_clip_reg_flank_win,
                                        cpos, 0))
                    n_total_cand_vars += 1

    noisy = IntervalSet.from_arrays([r[0] for r in regions],
                                    [r[1] for r in regions],
                                    [r[2] for r in regions])
    digar = ReadDigar(beg=beg, end=end, is_rev=read.is_rev, pos=ev_pos,
                      type=ev_op, len=ev_len, qi=ev_qi, low_qual=low,
                      seq=seq, qual=qual, noisy_regs=noisy, qlen=read.l_seq)

    mapped_len = end - beg + 1
    total_noisy = noisy.total_length()
    skip = (total_noisy > mapped_len * opt.max_noisy_frac_per_read
            or n_total_cand_vars > mapped_len * opt.max_var_ratio_per_read)

    chunk_regions: List[Tuple[int, int, int]] = []
    if not skip:
        for s, e, lab in noisy:
            if not (s + 1 > reg_end or e < reg_beg):
                chunk_regions.append((s, e, lab))
    return (None if skip else digar), chunk_regions, palindrome


def _rewritten(read: BamRecord, ops: List[Tuple[int, int]]):
    """Shim exposing the BamRecord surface collect_digar_eqx needs, with the
    CIGAR replaced by a rewritten =/X/I/D op list."""

    class _Rewritten:
        pass

    rw = _Rewritten()
    rw.cigar_array = lambda: np.array(ops, dtype=np.int64)
    rw.seq_nt4 = read.seq_nt4
    rw.qual = read.qual
    rw.pos = read.pos
    rw.endpos = read.endpos
    rw.is_rev = read.is_rev
    rw.l_seq = read.l_seq
    rw.get_tag = read.get_tag
    return rw


def collect_digar_from_md(read: BamRecord, opt: CallOpts, reg_beg: int,
                          reg_end: int, whole_ref_len: int
                          ) -> Tuple[Optional[ReadDigar],
                                     List[Tuple[int, int, int]], bool]:
    """digar from the MD tag + an M-op CIGAR
    (collect_digar_from_MD_tag, reference/src/bam_utils.c:1003-1174).

    The MD tag is authoritative for the =/X split of every M run — the
    loaded FASTA is NOT consulted, so a read whose aligner saw a different
    reference than the one on disk keeps the aligner's view (this is where
    the MD path deliberately diverges from the ref-compare fallback).
    Mismatch alt bases come from the read sequence; the MD ref bases are
    only consumed to advance the cursor.  Like the reference, an eq run in
    MD may span CIGAR M ops separated by I/S ops (``last_eq_len`` carry,
    bam_utils.c:1041-1055), and deletions consume a ``^<bases>`` group.
    """
    md = read.get_tag("MD")
    if not md:
        raise ValueError("no MD tag")
    cig = read.cigar_array()
    if ((cig[:, 0] == CEQUAL) | (cig[:, 0] == CDIFF)).any():
        raise ValueError("'=/X' CIGAR op unexpected in MD digar source")
    ops: List[Tuple[int, int]] = []
    mi, n = 0, len(md)
    last_eq = 0  # eq run carried over an I/S CIGAR boundary

    def _read_int() -> int:
        nonlocal mi
        j = mi
        while j < n and md[j].isdigit():
            j += 1
        v = int(md[mi:j])
        mi = j
        return v

    for op, ln in cig:
        op, ln = int(op), int(ln)
        if op == CMATCH:
            m = ln
            while m > 0:
                if last_eq > 0:
                    take = min(last_eq, m)
                    ops.append((CEQUAL, take))
                    last_eq -= take
                    m -= take
                elif mi < n and md[mi].isdigit():
                    e = _read_int()
                    if e == 0:
                        continue
                    take = min(e, m)
                    ops.append((CEQUAL, take))
                    last_eq = e - take
                    m -= take
                elif mi < n and md[mi].isalpha():
                    ops.append((CDIFF, 1))
                    mi += 1
                    m -= 1
                else:
                    raise ValueError(
                        f"MD and CIGAR do not match: {md!r} at {mi}")
        elif op == CDEL:
            ops.append((CDEL, ln))
            if mi < n and md[mi] == "^":
                mi += 1
            while mi < n and md[mi].isalpha():
                mi += 1
        else:
            ops.append((op, ln))
    return collect_digar_eqx(_rewritten(read, ops), opt, reg_beg, reg_end,
                             whole_ref_len)


def collect_digar_from_ref(read: BamRecord, opt: CallOpts, reg_beg: int,
                           reg_end: int, whole_ref_len: int,
                           ref_nt4: np.ndarray, ref_beg: int
                           ) -> Tuple[Optional[ReadDigar],
                                      List[Tuple[int, int, int]], bool]:
    """Fallback digar source: direct base-vs-reference comparison for reads
    whose CIGAR uses 'M' and that carry no cs/MD tag
    (collect_digar_from_ref_seq, src/bam_utils.c:1176-1327).

    Implemented by rewriting M runs into =/X against the fetched reference
    window, then deferring to the EQX path.
    """
    cig = read.cigar_array()
    if not (cig[:, 0] == CMATCH).any():
        return collect_digar_eqx(read, opt, reg_beg, reg_end, whole_ref_len)
    seq = read.seq_nt4()
    new_ops: List[Tuple[int, int]] = []
    pos = read.pos + 1
    qi = 0
    for op, ln in cig:
        if op == CMATCH:
            ref_off = pos - ref_beg
            ref_run = ref_nt4[ref_off:ref_off + ln]
            read_run = seq[qi:qi + ln]
            eq = ref_run == read_run
            # run-length encode the eq mask into =/X ops
            if ln > 0:
                change = np.nonzero(np.diff(eq))[0] + 1
                bounds = np.concatenate([[0], change, [ln]])
                for b0, b1 in zip(bounds[:-1], bounds[1:]):
                    new_ops.append((CEQUAL if eq[b0] else CDIFF, int(b1 - b0)))
            pos += ln
            qi += ln
        else:
            new_ops.append((int(op), int(ln)))
            if op in (CEQUAL, CDIFF):
                pos += ln
                qi += ln
            elif op == CINS or op == CSOFT_CLIP:
                qi += ln
            elif op in (CDEL, CREF_SKIP):
                pos += ln

    return collect_digar_eqx(_rewritten(read, new_ops), opt, reg_beg,
                             reg_end, whole_ref_len)


def _cigar_clips(cig: np.ndarray):
    """(left_op_len, right_op_len) of soft/hard clips."""
    left = right = None
    if len(cig) and cig[0, 0] in (CSOFT_CLIP, CHARD_CLIP):
        left = (int(cig[0, 0]), int(cig[0, 1]))
    if len(cig) > 1 and cig[-1, 0] in (CSOFT_CLIP, CHARD_CLIP):
        right = (int(cig[-1, 0]), int(cig[-1, 1]))
    return left, right


def collect_digar_from_cs(read: BamRecord, opt: CallOpts, reg_beg: int,
                          reg_end: int, whole_ref_len: int
                          ) -> Tuple[Optional[ReadDigar],
                                     List[Tuple[int, int, int]], bool]:
    """digar from the minimap2 ``cs`` short-form tag
    (collect_digar_from_cs_tag, reference/src/bam_utils.c:844-1001).

    The cs string is rewritten into an =/X/I/D op list (clips re-attached
    from the CIGAR) and fed through the shared EQX path so the noisy-region
    and low-qual policies stay in one place.
    """
    cs = read.get_tag("cs")
    if not cs:
        raise ValueError("no cs tag")
    cig = read.cigar_array()
    left, right = _cigar_clips(cig)
    ops: List[Tuple[int, int]] = []
    if left is not None:
        ops.append(left)
    i = 0
    n = len(cs)
    while i < n:
        c = cs[i]
        if c == ":":
            j = i + 1
            while j < n and cs[j].isdigit():
                j += 1
            ops.append((CEQUAL, int(cs[i + 1:j])))
            i = j
        elif c == "*":
            # *<ref><qry>; consecutive substitutions each get their own *
            ops.append((CDIFF, 1))
            i += 3
        elif c == "+":
            j = i + 1
            while j < n and cs[j] in "acgtnACGTN":
                j += 1
            ops.append((CINS, j - i - 1))
            i = j
        elif c == "-":
            j = i + 1
            while j < n and cs[j] in "acgtnACGTN":
                j += 1
            ops.append((CDEL, j - i - 1))
            i = j
        elif c == "=":  # long form match run
            j = i + 1
            while j < n and cs[j] in "acgtnACGTN":
                j += 1
            ops.append((CEQUAL, j - i - 1))
            i = j
        else:
            i += 1
    if right is not None:
        ops.append(right)
    return collect_digar_eqx(_rewritten(read, ops), opt, reg_beg, reg_end,
                             whole_ref_len)
