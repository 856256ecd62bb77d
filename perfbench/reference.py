"""The plain references the benchmark judges the program by.  Plain NumPy
and PyTorch on the CPU; nothing here imports the program.

* ``align_cost``: the least cost of a global alignment under the
  two-piece gap-affine scoring (match 0, mismatch x, a gap of length l
  costs min(o1 + e1 l, o2 + e2 l)), by dynamic programming over the
  diagonals that any alignment as cheap as a known one can reach.
  ``cigar_cost`` checks an alignment against its two sequences and
  prices it.
* ``phase_fixpoint``: the phasing EM (the fixpoint of read-to-haplotype
  assignment and consensus), a frozen copy of the port's plain version
  (``ops/phase_kernel.py:phase_fixpoint_plain`` on one device) in torch
  on the CPU, with its outputs in the EM kernel's packed int32 layout.
* ``score_records``: VCF records against the planted variants, the
  copy of ``tests/torch_helpers.py:evaluate_f1`` (exact SNVs, indels at
  their left-normalised anchors, SVs by position and length within a
  tolerance), with the zygosity of every matched SNV and indel.
* ``score_tr_loci``: the records at planted tandem repeat loci, judged
  by the two haplotype sequences they make of each locus, whatever
  records represent them; ``outside`` leaves those windows out of what
  ``score_records`` scores."""

from __future__ import annotations

import bisect
import itertools
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

INF = np.int64(1) << 40
# BAM CIGAR op codes of the aligner's results: I consumes the text (the
# second sequence), D the pattern (the first)
OP_M, OP_I, OP_D, OP_EQ, OP_X = 0, 1, 2, 7, 8


def gap_cost(length: int, o1: int, e1: int, o2: int, e2: int) -> int:
    return min(o1 + e1 * length, o2 + e2 * length) if length else 0


def cigar_cost(p: np.ndarray, t: np.ndarray, cigar: np.ndarray, x: int,
               o1: int, e1: int, o2: int, e2: int):
    """The cost of the alignment ``cigar`` ((k, 2) of (op, len)) of
    pattern ``p`` to text ``t``, or None where it does not consume both
    exactly or an = / X op disagrees with the bases."""
    i = j = 0
    cost = 0
    for op, ln in np.asarray(cigar, dtype=np.int64).reshape(-1, 2):
        op, ln = int(op), int(ln)
        if ln <= 0:
            return None
        if op in (OP_M, OP_EQ, OP_X):
            if i + ln > len(p) or j + ln > len(t):
                return None
            ne = int(np.count_nonzero(p[i:i + ln] != t[j:j + ln]))
            if (op == OP_EQ and ne) or (op == OP_X and ne != ln):
                return None
            cost += x * ne
            i += ln
            j += ln
        elif op == OP_I:
            cost += gap_cost(ln, o1, e1, o2, e2)
            j += ln
        elif op == OP_D:
            cost += gap_cost(ln, o1, e1, o2, e2)
            i += ln
        else:
            return None
    if i != len(p) or j != len(t):
        return None
    return cost


def align_cost(p: np.ndarray, t: np.ndarray, x: int, o1: int, e1: int,
               o2: int, e2: int, bound=None, half_band=None) -> int:
    """The least alignment cost of ``p`` against ``t``.  ``bound``, the
    cost of some alignment of the two, limits the diagonals searched to
    those a path of that cost can reach: every diagonal step beyond the
    span between 0 and len(t) - len(p) needs an insertion and a deletion,
    each of at least min(e1, e2).  ``half_band`` instead fixes how far
    beyond that span the search goes, and then the result is only the
    least cost inside the band (the control's narrow band)."""
    n, m = len(p), len(t)
    pi = np.asarray(p, dtype=np.int16)
    ti = np.asarray(t, dtype=np.int16)
    if half_band is None:
        half_band = (max(n, m) if bound is None
                     else int(bound) // (2 * min(e1, e2)) + 1)
    dlo = min(0, m - n) - half_band
    dhi = max(0, m - n) + half_band
    W = dhi - dlo + 1
    ks = np.arange(dlo, dhi + 1, dtype=np.int64)
    gaps = ((o1, e1), (o2, e2))
    # row 0: H[0][j] = gap(j), the E states as open gaps, no F
    j0 = ks
    ok0 = (j0 >= 0) & (j0 <= m)
    H = np.where(ok0, np.minimum(o1 + e1 * j0, o2 + e2 * j0), INF)
    H = np.where(j0 == 0, 0, H)
    F = [np.full(W, INF), np.full(W, INF)]
    for i in range(1, n + 1):
        j = i + ks
        ok = (j >= 0) & (j <= m)
        # diagonal step: H[i-1][j-1] sits on the same diagonal
        tj = ti[np.clip(j - 1, 0, max(m - 1, 0))] if m else np.zeros(W, int)
        sub = np.where(tj == pi[i - 1], 0, x)
        diag = np.where(ok & (j >= 1), H + sub, INF)
        # vertical step (consumes the pattern): from diagonal k + 1 of the
        # row above
        Hup = np.concatenate([H[1:], [INF]])
        nF = []
        for (o, e), Fk in zip(gaps, F):
            Fup = np.concatenate([Fk[1:], [INF]])
            nF.append(np.where(ok, np.minimum(Hup + o + e, Fup + e), INF))
        F = nF
        Hp = np.minimum(diag, np.minimum(F[0], F[1]))
        # horizontal steps (consume the text), from the same row's cells
        # to the left: E[d] = o + e d + min_{d' < d} (Hp[d'] - e d')
        Hn = Hp
        for o, e in gaps:
            run = np.minimum.accumulate(Hp - e * np.arange(W))
            E = np.concatenate([[INF], run[:-1]]) + o + e * np.arange(W)
            Hn = np.minimum(Hn, np.where(ok, E, INF))
        H = np.minimum(Hn, INF)
    k_end = (m - n) - dlo
    return int(H[k_end])


# ---------------- the phasing EM ----------------

def _complement_fill(c1, c2, mask):
    f1 = torch.where(mask & (c1 == -1) & (c2 != -1), 1 - c2, c1)
    f2 = torch.where(mask & (c2 == -1) & (c1 != -1), 1 - c1, c2)
    return f1, f2


def _cons_update(p0, p1, hp_ont):
    max_i = torch.where(p1 > p0, 1, torch.where(p0 > 0, 0, -1))
    max_cov = torch.where(max_i == 1, p1, torch.where(max_i == 0, p0, 0))
    weak = hp_ont & (max_cov.to(torch.float32)
                     < (p0 + p1).to(torch.float32) * 0.67)
    return torch.where(weak, -1, max_i).to(torch.int32)


def _scan_phase_sets(valid, het, n_agree, n_conflict):
    V = valid.shape[0]
    iota = torch.arange(V, dtype=torch.int32)
    is_first = torch.zeros_like(valid)
    if bool(valid.any()):
        is_first[int(torch.argmax(valid.to(torch.int32)))] = True
    new_seg = het & (n_agree < 2) & (n_conflict < 2)
    do_flip = het & ~new_seg & (n_conflict > n_agree)
    seg = valid & (is_first | new_seg)
    start = torch.cummax(torch.where(seg, iota, -1), dim=0).values
    flips = torch.cumsum((valid & ~is_first & do_flip).to(torch.int32),
                         dim=0, dtype=torch.int32)
    flip_here = valid & ~is_first & het & ((flips & 1) == 1)
    return torch.where(valid, start, -1).to(torch.int32), flip_here


def phase_fixpoint(alleles, starts, ends, cons0, haps0, scoreable, w_score,
                   clean_snp, valid, hp_het, hp_ont, max_iter: int = 10
                   ) -> np.ndarray:
    """The EM on numpy inputs (the EM kernel's eleven arguments); returns
    its outputs packed as the kernel packs them: cons (2, V), haps (R,),
    ps_start (V,), agree (R,), conflict (R,), profile (2, V, 2), n_iter.
    Every masked dot is a count below 2^24, exact in float32."""
    f32, i32 = torch.float32, torch.int32
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         (alleles, starts, ends, cons0, haps0, scoreable, w_score,
          clean_snp, valid, hp_het, hp_ont)]
    (alleles, starts, ends, cons0, haps0, scoreable, w_score, clean_snp,
     valid, hp_het, hp_ont) = t
    V = valid.shape[0]
    A = alleles.to(i32)
    A0, A1 = A == 0, A == 1
    Af0, Af1 = A0.to(f32), A1.to(f32)
    A01 = (A0 | A1).to(f32)
    Df = Af0 - Af1
    read_valid = starts >= 0
    scored = ((A0 | A1) & read_valid[:, None]).any(dim=0)
    tgt = valid.to(f32)[None, :]
    Af0t, Af1t = Af0 * tgt, Af1 * tgt
    haps = haps0.to(i32)
    agree = torch.zeros_like(starts, dtype=i32)
    conflict = torch.zeros_like(starts, dtype=i32)
    iota_v = torch.arange(V, dtype=i32)
    scored_any = scoreable & scored
    w = w_score.to(i32)
    c1, c2 = cons0[0].to(i32), cons0[1].to(i32)
    prof = torch.zeros((2, V, 2), dtype=i32)
    ps_start = torch.full((V,), -1, dtype=i32)
    n_iter = 0
    for _ in range(max_iter):
        het = valid & (c1 != -1) & (c2 != -1) & (c1 != c2) & ~hp_het
        prev_incl = torch.cummax(torch.where(het, iota_v, -1), dim=0).values
        prev_het = torch.cat([prev_incl.new_full((1,), -1), prev_incl[:-1]])
        h1 = (haps == 1)[:, None]
        own_c = torch.where(h1, c1[None, :], c2[None, :])
        oth_c = torch.where(h1, c2[None, :], c1[None, :])
        own_m = (A == own_c) & (A >= 0)
        oth_m = (A == oth_c) & (A >= 0)
        prev_own = own_m.index_select(1, prev_het.clamp_min(0))
        cover = ((starts[:, None] <= prev_het[None, :])
                 & (ends[:, None] >= iota_v[None, :]))
        act = (haps != 0)[:, None] & cover & (prev_het >= 0)[None, :]
        n_agree = (act & prev_own & own_m).sum(dim=0, dtype=i32)
        n_conflict = (act & prev_own & ~own_m & oth_m).sum(dim=0, dtype=i32)
        ps_start, flip = _scan_phase_sets(valid, het, n_agree, n_conflict)
        c1, c2 = torch.where(flip, c2, c1), torch.where(flip, c1, c2)

        f1, f2 = _complement_fill(c1, c2, scored_any)
        cons_set = scoreable & (f1 != -1)
        wf = torch.where(cons_set, w, 0).to(f32)
        cs = clean_snp & cons_set
        sv1, sv2 = wf * (1 - 2 * f1).to(f32), wf * (1 - 2 * f2).to(f32)
        used = (cons_set & (w > 0)).to(f32)
        e10, e11, e20, e21 = ((cs & (f == a)).to(f32)
                              for f in (f1, f2) for a in (0, 1))
        s1, s2 = Df @ sv1, Df @ sv2
        n_used = A01 @ used
        max_s, min_s = torch.maximum(s1, s2), torch.minimum(s1, s2)
        max_hap = torch.where(s1 >= s2, 1, 2)
        min_hap = torch.where(s1 <= s2, 1, 2)
        hap = torch.where(max_s > 0, max_hap,
                          torch.where(min_s < 0, 3 - min_hap, 0))
        hap = torch.where(n_used == 0, 0, hap)
        hap = torch.where(read_valid, hap, 0).to(i32)

        def cnt(a0v, a1v):
            return Af0 @ a0v + Af1 @ a1v
        pos = (max_s > 0) & read_valid
        first = max_hap == 1
        agree = torch.where(pos, torch.where(
            first, cnt(e10, e11), cnt(e20, e21)), 0).to(i32)
        conflict = torch.where(pos, torch.where(
            first, cnt(e11, e10), cnt(e21, e20)), 0).to(i32)
        haps = hap
        g1 = (((hap == 1) | (hap == 0)) & read_valid).to(f32)
        g2 = (((hap == 2) | (hap == 0)) & read_valid).to(f32)
        p10, p11, p20, p21 = ((g @ mm).to(i32) for g in (g1, g2)
                              for mm in (Af0t, Af1t))
        nc1 = torch.where(valid, _cons_update(p10, p11, hp_ont), f1)
        nc2 = torch.where(valid, _cons_update(p20, p21, hp_ont), f2)
        prof = torch.stack([torch.stack([p10, p11], dim=-1),
                            torch.stack([p20, p21], dim=-1)])
        changed = flip.any() | (((nc1 != c1) | (nc2 != c2)) & valid).any()
        c1, c2 = nc1, nc2
        n_iter += 1
        if not bool(changed):
            break
    return torch.cat([torch.stack([c1, c2]).to(i32).flatten(), haps, ps_start,
                      agree, conflict, prof.flatten(),
                      torch.tensor([n_iter], dtype=i32)]).numpy()


def em_fields(buf: np.ndarray, R: int, V: int) -> Dict[str, np.ndarray]:
    """The named parts of a packed EM output."""
    cuts = list(itertools.accumulate((0, 2 * V, R, V, R, R, 4 * V, 1)))
    names = ("cons", "haps", "ps_start", "agree", "conflict", "profile",
             "n_iter")
    return {n: buf[a:b] for n, a, b in zip(names, cuts[:-1], cuts[1:])}


# ---------------- records against the planted variants ----------------

NT4 = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}


def _left_norm_del(ref4: np.ndarray, anchor: int, ln: int) -> int:
    s = anchor + 1
    while s > 1 and ref4[s - 1] == ref4[s + ln - 1]:
        s -= 1
    return s - 1


def _left_norm_ins(ref4: np.ndarray, anchor: int, seq) -> int:
    seq = list(np.asarray(seq))
    a = anchor
    k = 0
    while a > 0 and ref4[a] == seq[(len(seq) - 1 - k) % len(seq)]:
        a -= 1
        k += 1
    return a


def score_records(body: Sequence[str], truth: List[tuple], beg: int,
                  end: int, ref4: np.ndarray, sv_pos_tol: int = 60,
                  sv_len_tol: float = 0.25) -> Dict[str, int]:
    """Counts of one contig's records against its planted variants, both
    taken in [beg, end): ``truth`` planted, ``tp``/``fp``/``fn`` by the
    rules of evaluate_f1, and ``zygosity``: matched SNVs and indels whose
    call is homozygous where the plant is heterozygous, or the other
    way."""
    def is_hom(sample: str) -> bool:
        gt = sample.split(":", 1)[0].replace("|", "/").split("/")
        return len(gt) == 2 and gt[0] == gt[1] and gt[0] not in ("0", ".")

    t_snv, t_ind, t_sv = {}, {}, []
    for p, k, pl, gt in truth:
        if not beg <= p < end:
            continue
        if k == "snv":
            t_snv[(p, int(pl))] = gt == "hom"
            continue
        ln = pl if isinstance(pl, (int, np.integer)) else len(pl)
        if ln >= 50:
            t_sv.append((p, k, int(ln)))
            continue
        a = (_left_norm_ins(ref4, p, pl) if k == "ins"
             else _left_norm_del(ref4, p, int(pl)))
        t_ind[(a, k, int(ln))] = gt == "hom"
    c_snv, c_ind, c_sv = {}, {}, []
    for line in body:
        f = line.split("\t")
        pos1 = int(f[1])
        if not beg <= pos1 - 1 < end:
            continue
        ref_s, alt_s = f[3], f[4].split(",")[0]
        hom = is_hom(f[9]) if len(f) > 9 else False
        if len(ref_s) == 1 and len(alt_s) == 1:
            c_snv[(pos1 - 1, NT4.get(alt_s.upper(), 4))] = hom
            continue
        if len(alt_s) > len(ref_s):
            kind, ln = "ins", len(alt_s) - len(ref_s)
            a = _left_norm_ins(ref4, pos1 - 1,
                               [NT4.get(c, 4) for c in alt_s[1:].upper()])
        else:
            kind, ln = "del", len(ref_s) - len(alt_s)
            a = _left_norm_del(ref4, pos1 - 1, ln)
        if ln >= 50:
            c_sv.append((a, kind, ln))
        else:
            c_ind[(a, kind, ln)] = hom
    out = {"truth": len(t_snv) + len(t_ind) + len(t_sv), "tp": 0, "fp": 0,
           "fn": 0, "zygosity": 0}
    for t_set, c_set in ((t_snv, c_snv), (t_ind, c_ind)):
        hit = t_set.keys() & c_set.keys()
        out["tp"] += len(hit)
        out["fp"] += len(c_set) - len(hit)
        out["fn"] += len(t_set) - len(hit)
        out["zygosity"] += sum(t_set[k] != c_set[k] for k in hit)
    used = [False] * len(t_sv)
    for cp, ck, cl in c_sv:
        for i, (p, k, ln) in enumerate(t_sv):
            if not used[i] and k == ck and abs(cp - p) <= sv_pos_tol and \
                    abs(cl - ln) <= sv_len_tol * max(cl, ln):
                used[i] = True
                out["tp"] += 1
                break
        else:
            out["fp"] += 1
    out["fn"] += used.count(False)
    return out


# ---------------- repeat loci by haplotype sequence ----------------

# a locus is judged over itself and this many bases on either side
TR_FLANK = 50
# a window whose records fall into more phase groups (a phase set, or an
# unphased heterozygous record, each) than this is not enumerated and
# reads wrong
TR_MAX_GROUPS = 16
_ACGTN = np.frombuffer(b"ACGTN", dtype=np.uint8)


def _bases(a) -> str:
    return _ACGTN[np.asarray(a, dtype=np.uint8)].tobytes().decode()


def _parse(line: str, k: int):
    """(0-based start, REF, ALTs, the two GT alleles, phase group or None
    where the record is homozygous) of VCF record ``k``."""
    f = line.rstrip("\n").split("\t")
    sample = dict(zip(f[8].split(":"), f[9].split(":"))) if len(f) > 9 \
        else {}
    gt = sample.get("GT", ".")
    al = [int(a) if a.isdigit() else 0 for a in re.split(r"[|/]", gt)]
    al = (al * 2)[:2]
    group = None
    if al[0] != al[1]:
        group = (("ps", sample["PS"]) if "|" in gt and "PS" in sample
                 else ("rec", k))
    return int(f[1]) - 1, f[3].upper(), f[4].upper().split(","), al, group


def _plant_span(t) -> Tuple[int, int]:
    p, kind, pl, _ = t
    return p, p + 1 + (int(pl) if kind == "del" else 0)


def _plant_edit(t, ref_s: str, ws: int):
    p, kind, pl, _ = t
    anchor = ref_s[p - ws]
    if kind == "snv":
        return p, 1, "ACGT"[int(pl)]
    if kind == "ins":
        return p, 1, anchor + _bases(pl)
    return p, 1 + int(pl), anchor


def _apply(ref_s: str, ws: int, edits):
    """The window's reference (from ``ws``) with ``edits`` (start, length
    in the reference, replacement) made, or None where two overlap."""
    out, cur = [], 0
    for p, rl, alt in sorted(edits, key=lambda e: e[0]):
        a = p - ws
        if a < cur:
            return None
        out += [ref_s[cur:a], alt]
        cur = a + rl
    out.append(ref_s[cur:])
    return "".join(out)


def _windows(loci, spans, beg: int, end: int) -> List[List[int]]:
    """Each locus near [beg, end) and TR_FLANK on either side, grown over
    every span (a record's or a plant's) that reaches into it, windows
    that touch merged."""
    wins = sorted([lb - TR_FLANK, le + TR_FLANK] for lb, le, _, _ in loci
                  if lb - TR_FLANK < end and le + TR_FLANK > beg)
    changed = True
    while changed:
        merged: List[List[int]] = []
        for w in wins:
            if merged and w[0] <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], w[1])
            else:
                merged.append(list(w))
        wins = merged
        starts = [w[0] for w in wins]
        changed = False
        for a, b in spans:
            k = bisect.bisect_right(starts, b - 1) - 1
            if k < 0 or wins[k][1] <= a:
                continue
            if a < wins[k][0] or b > wins[k][1]:
                wins[k] = [min(a, wins[k][0]), max(b, wins[k][1])]
                changed = True
    return wins


def _called_pairs(ref_s: str, ws: int, recs):
    """Every unordered pair of haplotype sequences the records make of
    the window: a phase set, or an unphased heterozygous record, may face
    either way."""
    groups = sorted({r[4] for r in recs if r[4] is not None}, key=str)
    if len(groups) > TR_MAX_GROUPS:
        return
    for flips in itertools.product((0, 1), repeat=max(0, len(groups) - 1)):
        flip = dict(zip(groups[1:], flips))
        haps = ([], [])
        for p, ref, alts, al, group in recs:
            f = flip.get(group, 0)
            for h in (0, 1):
                x = al[h ^ f]
                if x > len(alts):
                    return
                if x:
                    haps[h].append((p, len(ref), alts[x - 1]))
        yield _apply(ref_s, ws, haps[0]), _apply(ref_s, ws, haps[1])


def score_tr_loci(body: Sequence[str], loci, ref4: np.ndarray, beg: int,
                  end: int, plants: Sequence[tuple] = ()) -> Dict:
    """The records at planted tandem repeat loci against the truth, by
    haplotype sequence.  ``loci``: (begin, end, haplotype 1's sequence,
    haplotype 2's) of each locus, as nt4 codes; ``plants``: the other
    planted variants (``score_records``' truth), of which a window holds
    those that a record grows it over.

    Each locus is taken with TR_FLANK bases on either side, grown over
    every record and plant reaching into it, windows that touch merged.
    A window whose two called sequences, as an unordered pair, equal the
    truth's base for base is right; every record overlapping it, every
    ALT, counts, and a phase set or an unphased heterozygous record may
    face either way.  Returns ``tr_loci`` (loci in windows that lie in
    [beg, end)), ``tr_bad`` (those of them in wrong windows) and
    ``windows``: every window, those at the ends too, which ``outside``
    leaves out of ``score_records``' input."""
    recs = [_parse(ln, k) for k, ln in enumerate(body)]
    spans = [(r[0], r[0] + len(r[1])) for r in recs] + \
        [_plant_span(t) for t in plants]
    wins = _windows(loci, spans, beg, end)
    out = {"tr_loci": 0, "tr_bad": 0, "windows": [tuple(w) for w in wins]}
    starts = [w[0] for w in wins]
    in_win: List[Dict[str, list]] = [{"loci": [], "recs": [], "plants": []}
                                     for _ in wins]

    def place(key, item, a, b):
        k = bisect.bisect_right(starts, b - 1) - 1
        if k >= 0 and wins[k][1] > a:
            in_win[k][key].append(item)

    for lc in loci:
        place("loci", lc, lc[0], lc[1])
    for r, (a, b) in zip(recs, spans):
        place("recs", r, a, b)
    for t in plants:
        place("plants", t, *_plant_span(t))
    for (ws, we), got in zip(wins, in_win):
        if ws < beg or we > end:
            continue
        ref_s = _bases(ref4[ws:we])
        truth = ([], [])
        for lb, le, s1, s2 in got["loci"]:
            for h, seq in enumerate((s1, s2)):
                truth[h].append((lb, le - lb, _bases(seq)))
        for t in got["plants"]:
            e = _plant_edit(t, ref_s, ws)
            for h in (0, 1):
                if t[3] == "hom" or (t[3] == "het1") == (h == 0):
                    truth[h].append(e)
        want = sorted(_apply(ref_s, ws, e) for e in truth)
        ok = any(None not in pair and sorted(pair) == want
                 for pair in _called_pairs(ref_s, ws, got["recs"]))
        out["tr_loci"] += len(got["loci"])
        out["tr_bad"] += 0 if ok else len(got["loci"])
    return out


def outside(body: Sequence[str], plants: Sequence[tuple], windows
            ) -> Tuple[List[str], List[tuple]]:
    """The records and plants that overlap none of ``windows``."""
    starts = [w[0] for w in windows]

    def free(a, b):
        k = bisect.bisect_right(starts, b - 1) - 1
        return k < 0 or windows[k][1] <= a

    kept = []
    for ln in body:
        f = ln.split("\t", 4)
        p = int(f[1]) - 1
        if free(p, p + len(f[3])):
            kept.append(ln)
    return kept, [t for t in plants if free(*_plant_span(t))]
