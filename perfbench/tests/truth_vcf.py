"""VCF records written from a contig's planted variants, for the scorer's
and the judge's tests: every plant as the caller writes it, and every
tandem repeat locus in one of several representations.

* ``left``: each haplotype's change as one record, the sequence the two
  share kept from the right end first, so the change sits at the left;
* ``right``: the same, the shared sequence kept from the left first;
* ``split``: each haplotype's allele over two records, the locus cut in
  the middle;
* ``whole``: one record over the whole locus and its anchor, both
  alleles as its ALTs, ``1|2`` at a compound heterozygous locus.

``phased`` gives every heterozygous record a ``|`` and one phase set,
else ``/`` and no phase set."""

from __future__ import annotations

from typing import List

import numpy as np

ACGT = "ACGT"


def _s(a) -> str:
    return "".join(ACGT[int(x)] for x in a)


def _line(pos0: int, ref: str, alts: List[str], gt: str) -> str:
    fmt, sample = ("GT:PS", gt + ":1") if "|" in gt and gt[0] != gt[-1] \
        else ("GT", gt)
    return "\t".join(["chr1", str(pos0 + 1), ".", ref, ",".join(alts),
                      "60", "PASS", ".", fmt, sample])


def _gt(h1: int, h2: int, phased: bool) -> str:
    if phased or h1 == h2:
        return f"{h1}|{h2}"
    return f"{min(h1, h2)}/{max(h1, h2)}"


def plant_lines(truth, ref4: np.ndarray, phased: bool = True) -> List[str]:
    """One record a planted SNV, indel or SV."""
    out = []
    for p, kind, pl, gt in truth:
        if kind == "tr":
            continue
        h = (1, 1) if gt == "hom" else ((1, 0) if gt == "het1" else (0, 1))
        a = ACGT[int(ref4[p])]
        if kind == "snv":
            rec = (p, a, ACGT[int(pl)])
        elif kind == "ins":
            rec = (p, a, a + _s(pl))
        else:
            rec = (p, _s(ref4[p:p + 1 + int(pl)]), a)
        out.append(_line(rec[0], rec[1], [rec[2]], _gt(*h, phased)))
    return out


def _trim(ref: str, alt: str, right_first: bool):
    """(bases kept at the left, bases kept at the right) of ref -> alt:
    the most shared from one end, then from the other."""
    def lcp(a, b):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        return n

    if right_first:
        q = lcp(ref[::-1], alt[::-1])
        p = lcp(ref[:len(ref) - q], alt[:len(alt) - q])
    else:
        p = lcp(ref, alt)
        q = lcp(ref[p:][::-1], alt[p:][::-1])
    return p, q


def _edit_records(ref4, beg, end, allele: str, rep: str):
    """(start, REF, ALT) records that turn [beg, end) into ``allele``."""
    ref = _s(ref4[beg:end])
    if allele == ref:
        return []
    if rep == "split":
        # [beg, mid) with its anchor, then [mid, end), each part kept
        # non-empty on both sides
        mid = len(ref) // 2
        x = max(0, min(mid + len(allele) - len(ref), len(allele) - 1))
        a = ACGT[int(ref4[beg - 1])]
        recs = [(beg - 1, a + ref[:mid], a + allele[:x]),
                (beg + mid, ref[mid:], allele[x:])]
        return [r for r in recs if r[1] != r[2]]
    if rep == "whole":
        a = ACGT[int(ref4[beg - 1])]
        return [(beg - 1, a + ref, a + allele)]
    p, q = _trim(ref, allele, right_first=rep == "left")
    r_mid, a_mid = ref[p:len(ref) - q], allele[p:len(allele) - q]
    if len(r_mid) == len(a_mid) == 1:
        return [(beg + p, r_mid, a_mid)]
    a = ACGT[int(ref4[beg + p - 1])]
    return [(beg + p - 1, a + r_mid, a + a_mid)]


def locus_lines(locus, ref4: np.ndarray, rep: str = "left",
                phased: bool = True) -> List[str]:
    """The records of one planted locus (perfbench/gen.py's Locus)."""
    al = [_s(locus.allele(ref4, h)) for h in (1, 2)]
    if rep == "whole":
        ref = _s(ref4[locus.beg:locus.end])
        if al[0] == al[1] == ref:
            return []
        alts = [a for k, a in enumerate(al) if a != ref and a not in al[:k]]
        h = [0 if a == ref else alts.index(a) + 1 for a in al]
        pad = ACGT[int(ref4[locus.beg - 1])]
        return [_line(locus.beg - 1, pad + ref, [pad + a for a in alts],
                      _gt(*h, phased))]
    # a record both haplotypes carry is written once, homozygous
    per_hap = [_edit_records(ref4, locus.beg, locus.end, a, rep) for a in al]
    out = []
    for rec in sorted(set(per_hap[0]) | set(per_hap[1])):
        h = [int(rec in recs) for recs in per_hap]
        out.append(_line(rec[0], rec[1], [rec[2]], _gt(*h, phased)))
    return out


def truth_lines(truth, ref4: np.ndarray, rep: str = "left",
                phased: bool = True) -> List[str]:
    """Every plant and locus, sorted by position."""
    lines = plant_lines(truth, ref4, phased)
    for t in truth:
        if t[1] == "tr":
            lines += locus_lines(t[2], ref4, rep, phased)
    return sorted(lines, key=lambda ln: int(ln.split("\t")[1]))
