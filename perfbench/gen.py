"""The frozen input generator: a seeded diploid contig with planted
variants, its FASTA (+.fai), and a sorted, indexed BAM of reads drawn
from its two haplotypes.

A copy of the contig builder of ``tests/torch_helpers.py`` (contig_truth,
build_truth, HapMap, apply_ont_errors, make_record, write_synth_bam,
write_synth_fasta), drawing the same random numbers in the same order, so
that one seed gives the same FASTA and the same BAM records
(``perfbench/tests/test_bench_gen.py`` holds them equal).  It writes its
BGZF and index with ``perfbench/bgzf.py`` and imports nothing of the
program.
``make_contigs`` builds many contigs on a pool of processes and records
each one's read bases, the amount of work the benchmark's rate counts.

A configuration whose ``genome`` holds a ``tandem_repeats`` block also
gets tandem repeats (``plant_repeats``), written into the reference after
it is drawn and drawn from a generator of their own, so that without the
block every random number is drawn as before and one seed gives the same
bytes."""

from __future__ import annotations

import bisect
import dataclasses
import multiprocessing
import os
import struct
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from perfbench import bgzf

CMATCH, CINS, CDEL, CSOFT = 0, 1, 2, 4
_NT16_LUT = np.array([1, 2, 4, 8, 15], dtype=np.uint8)   # A C G T N


def contig_truth(seed, length, margin=2_000, snv_per_kb=1.0,
                 indel_per_kb=0.125, sv_per_mb=25.0, tandem_repeats=None,
                 read_len=None):
    """(reference as nt4 codes, planted variants) of the contig of this
    seed and length; with ``tandem_repeats`` (and the reads' length) the
    variants include the repeat loci, as ``(beg, "tr", Locus, "tr")``."""
    rng = np.random.default_rng(seed)
    ref4 = rng.integers(0, 4, length).astype(np.uint8)
    truth = build_truth(rng, ref4, margin, length - margin,
                        snv_per_kb=snv_per_kb, indel_per_kb=indel_per_kb,
                        sv_per_mb=sv_per_mb)
    if tandem_repeats:
        if read_len is None:
            raise ValueError("tandem repeats need the reads' length")
        truth = plant_repeats(seed, ref4, margin, length - margin, truth,
                              tandem_repeats, read_len)
    return ref4, truth


def genome_truth(seed: int, length: int, model: Dict, genome: Dict):
    """contig_truth of a configuration: its read model and genome model."""
    return contig_truth(seed, length, int(model.get("margin", 2_000)),
                        read_len=int(model["read_len"]), **genome)


def build_truth(rng: np.random.Generator, ref4: np.ndarray, beg: int,
                end: int, snv_per_kb: float = 1.0,
                indel_per_kb: float = 0.125, sv_per_mb: float = 5.0,
                min_gap: int = 150) -> List[tuple]:
    """Plant variants over [beg, end): sorted [(pos, kind, payload, gt)]
    with payload = alt base (snv), base list (ins) or deletion length
    (del); SVs are insertions or deletions of 50-400 bp, small indels
    1-12 bp; gt is het1, het2 or hom."""
    span = end - beg
    n_snv = rng.poisson(snv_per_kb * span / 1000)
    n_ind = rng.poisson(indel_per_kb * span / 1000)
    n_sv = rng.poisson(sv_per_mb * span / 1e6)
    events = [("snv", None)] * n_snv
    for _ in range(n_ind):
        events.append(("ins" if rng.random() < 0.5 else "del",
                       int(rng.integers(1, 13))))
    for _ in range(n_sv):
        events.append(("ins" if rng.random() < 0.5 else "del",
                       int(rng.integers(50, 401))))
    rng.shuffle(events)
    pos_pool = np.sort(rng.choice(
        np.arange(beg + 200, end - 600, dtype=np.int64),
        size=min(len(events), max(0, (end - beg - 800) // min_gap)),
        replace=False))
    keep = np.ones(len(pos_pool), dtype=bool)
    last = -10**18
    for i, p in enumerate(pos_pool):
        if p - last < min_gap:
            keep[i] = False
        else:
            last = p
    truth = []
    for pos, (kind, ln) in zip(pos_pool[keep], events):
        pos = int(pos)
        gt = ("hom" if rng.random() < 0.35
              else ("het1" if rng.random() < 0.5 else "het2"))
        if kind == "snv":
            payload = (int(ref4[pos]) + 1 + int(rng.integers(3))) % 4
        elif kind == "ins":
            payload = rng.integers(0, 4, ln).astype(np.uint8)
        else:
            ln = min(ln, 120) if ln < 50 else ln
            if ln >= min_gap - 30:
                ln = min_gap - 30
            payload = int(ln)
        truth.append((pos, kind, payload, gt))
    return truth


# ---------------- tandem repeats ----------------

# the repeat model's stream: SeedSequence([seed, TR_TAG])
TR_TAG = 0x7472
TR_KEYS = {"loci_per_mb", "classes", "impure_copy_share", "polymorphic",
           "gain_share", "zygosity"}
TR_CLASS_KEYS = {"share", "motif", "ref_len", "change_bp"}
TR_ZYGOSITY = ("hom", "het", "compound")
# an allele is kept this much shorter than a read, so that reads at full
# depth span it
TR_READ_SLACK = 2_000


@dataclasses.dataclass
class Locus:
    """A tandem repeat written into the reference over [beg, end): whole
    copies of ``motif``, each copy listed in ``impure`` with one
    substitution.  ``edits`` holds each haplotype's allele: None where it
    keeps the reference's, else (gained bases, bp lost), the change made
    at the locus's left end, so the allele is the gained bases followed
    by ``ref4[beg + lost:end]``."""
    beg: int
    end: int
    motif: np.ndarray
    impure: Tuple[int, ...]
    edits: Tuple[Optional[Tuple[np.ndarray, int]], ...]

    def allele(self, ref4: np.ndarray, hap: int) -> np.ndarray:
        """Haplotype ``hap``'s (1 or 2) sequence over [beg, end)."""
        e = self.edits[hap - 1]
        if e is None:
            return ref4[self.beg:self.end]
        gain, lost = e
        return np.concatenate([gain, ref4[self.beg + lost:self.end]])


def _log_uniform(rng: np.random.Generator, lo: float, hi: float) -> float:
    return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))


def _motif(rng: np.random.Generator, m: int) -> np.ndarray:
    """m random bases that are no repeat of a shorter unit."""
    while True:
        mot = rng.integers(0, 4, m).astype(np.uint8)
        if not any(m % p == 0 and np.array_equal(mot, np.tile(mot[:p],
                                                              m // p))
                   for p in range(1, m)):
            return mot


def _copies(rng: np.random.Generator, motif: np.ndarray, n: int,
            impure_share: float) -> Tuple[np.ndarray, List[int]]:
    """n copies of ``motif``, each carrying one substitution with
    probability ``impure_share``; (bases, the copies that carry one)."""
    m = len(motif)
    seq = np.tile(motif, n)
    impure = np.flatnonzero(rng.random(n) < impure_share)
    offs = rng.integers(0, m, len(impure))
    subs = rng.integers(1, 4, len(impure))
    at = impure * m + offs
    seq[at] = (seq[at] + subs) % 4
    return seq, [int(k) for k in impure]


def _edit(rng: np.random.Generator, cls: Dict, motif: np.ndarray,
          copies: int, impure_share: float, gain_share: float,
          max_len: int) -> Tuple[np.ndarray, int]:
    """One allele: whole copies gained or lost at the locus's left end,
    the length change log-uniform over the class's ``change_bp``."""
    m = len(motif)
    gain = rng.random() < gain_share
    k = max(1, int(round(_log_uniform(rng, *cls["change_bp"]) / m)))
    room = (max_len - copies * m) // m
    if gain and room < 1:
        gain = False
    if gain:
        bases, _ = _copies(rng, motif, min(k, room), impure_share)
        return bases, 0
    return np.zeros(0, np.uint8), min(k, copies - 1) * m


def plant_repeats(seed: int, ref4: np.ndarray, beg: int, end: int,
                  truth: List[tuple], tr: Dict, read_len: int,
                  min_gap: int = 150) -> List[tuple]:
    """Write tandem repeat loci into ``ref4`` over [beg, end) and return
    ``truth`` without the plants within ``min_gap`` of a locus, with the
    loci added as ``(beg, "tr", Locus, "tr")``, sorted by position.

    ``tr`` (a configuration's ``genome.tandem_repeats``) gives the loci a
    Mb, ``classes`` (each a ``share`` of the loci with its ``motif``
    length range, its ``ref_len`` range in the reference and its
    ``change_bp`` range of allele length changes, both log-uniform, all
    ranges inclusive), ``impure_copy_share`` (the share of copies that
    carry a substitution), ``polymorphic`` (the share of loci whose
    haplotypes differ from the reference), ``gain_share`` (of alleles
    that gain copies rather than lose them) and ``zygosity`` (shares of
    ``hom``, ``het`` on either haplotype, and ``compound``: two different
    alleles).  Loci lie at least ``min_gap`` apart, and every allele is
    shorter than ``read_len`` less TR_READ_SLACK."""
    if set(tr) != TR_KEYS or any(set(c) != TR_CLASS_KEYS
                                 for c in tr["classes"]) \
            or set(tr["zygosity"]) != set(TR_ZYGOSITY):
        raise ValueError(f"tandem_repeats needs exactly {sorted(TR_KEYS)}, "
                         f"each class {sorted(TR_CLASS_KEYS)} and zygosity "
                         f"shares of {TR_ZYGOSITY}")
    rng = np.random.default_rng([int(seed), TR_TAG])
    max_len = read_len - TR_READ_SLACK - 1
    classes = tr["classes"]
    cls_p = np.array([c["share"] for c in classes], dtype=float)
    zyg_p = np.array([tr["zygosity"][z] for z in TR_ZYGOSITY], dtype=float)
    imp = float(tr["impure_copy_share"])
    lo, hi = beg + 200, end - 600
    n = int(rng.poisson(tr["loci_per_mb"] * max(0, hi - lo) / 1e6))
    starts = np.sort(rng.integers(lo, hi, n)) if hi > lo else []
    loci: List[Locus] = []
    last_end = -10**18
    for s in starts:
        s = int(s)
        cls = classes[int(rng.choice(len(classes), p=cls_p / cls_p.sum()))]
        m = int(rng.integers(cls["motif"][0], cls["motif"][1] + 1))
        motif = _motif(rng, m)
        copies = max(2, int(round(_log_uniform(rng, *cls["ref_len"]) / m)))
        copies = min(copies, max_len // m)
        seq, impure = _copies(rng, motif, copies, imp)
        edits: Tuple = (None, None)
        if rng.random() < tr["polymorphic"]:
            z = TR_ZYGOSITY[int(rng.choice(3, p=zyg_p / zyg_p.sum()))]
            args = (rng, cls, motif, copies, imp, tr["gain_share"], max_len)
            a = _edit(*args)
            if z == "hom":
                edits = (a, a)
            elif z == "het":
                edits = (a, None) if rng.random() < 0.5 else (None, a)
            else:
                b = _edit(*args)
                for _ in range(16):
                    if len(b[0]) - b[1] != len(a[0]) - a[1]:
                        break
                    b = _edit(*args)
                else:
                    # one copy lost, or one gained where ``a`` lost one
                    b = ((np.zeros(0, np.uint8), m)
                         if len(a[0]) or a[1] > m else (motif.copy(), 0))
                edits = (a, b)
        e = s + copies * m
        if s - last_end < min_gap or e > hi:
            continue
        ref4[s:e] = seq
        loci.append(Locus(s, e, motif, tuple(impure), edits))
        last_end = e
    begs = [lc.beg for lc in loci]

    def near(p: int, q: int) -> bool:
        """[p, q) lies within ``min_gap`` of a locus."""
        k = bisect.bisect_right(begs, q + min_gap - 1) - 1
        return k >= 0 and loci[k].end + min_gap > p

    kept = [t for t in truth
            if not near(t[0], t[0] + 1 + (int(t[2]) if t[1] == "del"
                                          else 0))]
    out = kept + [(lc.beg, "tr", lc, "tr") for lc in loci]
    out.sort(key=lambda t: t[0])
    return out


class HapMap:
    """One haplotype: its sequence and a run-length map to the reference."""

    def __init__(self, ref4: np.ndarray, beg: int, end: int,
                 truth: List[tuple], hap: int):
        segs: List[np.ndarray] = []
        ops: List[int] = []
        lens: List[int] = []
        cur = beg

        def push(op, ln):
            if ln <= 0:
                return
            if ops and ops[-1] == op:
                lens[-1] += ln
            else:
                ops.append(op)
                lens.append(ln)

        for pos, kind, payload, gt in truth:
            if kind == "tr":
                # the locus's change at its left end: gained copies as an
                # insertion, or lost copies as a deletion, then the rest
                edit = payload.edits[hap - 1]
                if edit is None or pos < cur:
                    continue
                gain, lost = edit
                segs.append(ref4[cur:pos])
                push(CMATCH, pos - cur)
                segs.append(np.asarray(gain, dtype=np.uint8))
                push(CINS, len(gain))
                push(CDEL, lost)
                segs.append(ref4[pos + lost:payload.end])
                push(CMATCH, payload.end - pos - lost)
                cur = payload.end
                continue
            on = gt == "hom" or (gt == "het1") == (hap == 1)
            if not on or pos < cur:
                continue
            segs.append(ref4[cur:pos])
            push(CMATCH, pos - cur)
            if kind == "snv":
                segs.append(np.array([payload], dtype=np.uint8))
                push(CMATCH, 1)
                cur = pos + 1
            elif kind == "ins":
                segs.append(ref4[pos:pos + 1])
                push(CMATCH, 1)
                segs.append(np.asarray(payload, dtype=np.uint8))
                push(CINS, len(payload))
                cur = pos + 1
            else:
                segs.append(ref4[pos:pos + 1])
                push(CMATCH, 1)
                push(CDEL, int(payload))
                cur = pos + 1 + int(payload)
        segs.append(ref4[cur:end])
        push(CMATCH, end - cur)
        self.seq = np.concatenate(segs) if segs else np.zeros(0, np.uint8)
        self.ops = np.asarray(ops, dtype=np.int64)
        self.lens = np.asarray(lens, dtype=np.int64)
        hap_consumed = np.where(self.ops == CDEL, 0, self.lens)
        ref_consumed = np.where(self.ops == CINS, 0, self.lens)
        self.cum_hap = np.concatenate([[0], np.cumsum(hap_consumed)])
        self.cum_ref = np.concatenate([[0], np.cumsum(ref_consumed)])
        self.beg = beg

    def read_cigar(self, s: int, e: int) -> Tuple[int, list]:
        """(0-based reference start, CIGAR as [(op, len)]) of the read
        over haplotype positions [s, e)."""
        i = int(np.searchsorted(self.cum_hap, s, side="right")) - 1
        j = int(np.searchsorted(self.cum_hap, e, side="left"))
        cig = []
        ref_pos = None
        for k in range(i, j):
            op = int(self.ops[k])
            ln = int(self.lens[k])
            h0 = int(self.cum_hap[k])
            if op != CDEL:
                lo = max(s, h0)
                hi = min(e, h0 + ln)
                if hi <= lo:
                    continue
                if ref_pos is None:
                    off = lo - h0
                    ref_pos = (self.beg + int(self.cum_ref[k])
                               + (off if op == CMATCH else 0))
                    if op == CINS:
                        cig.append([CSOFT, hi - lo])
                        continue
                cig.append([op, hi - lo])
            else:
                if ref_pos is None or s >= e:
                    continue
                if cig and s < e:
                    cig.append([CDEL, ln])
        out = []
        for op, ln in cig:
            if out and out[-1][0] == op:
                out[-1][1] += ln
            else:
                out.append([op, ln])
        while out and out[-1][0] == CDEL:
            out.pop()
        while out and out[0][0] == CDEL:
            ref_pos += out[0][1]
            out.pop(0)
        return ref_pos, [(op, ln) for op, ln in out]


def apply_ont_errors(seq: np.ndarray, cig: List[tuple],
                     rng: np.random.Generator, indel_rate: float
                     ) -> Tuple[np.ndarray, List[tuple]]:
    """ONT-style 1-2 bp indel errors, biased into homopolymers:
    insertions that duplicate the local base, or deletions inside M
    runs."""
    n_err = rng.poisson(indel_rate * len(seq))
    if n_err == 0:
        return seq, cig
    spans = []
    r = 0
    for op, ln in cig:
        if op == CMATCH:
            spans.append((r, r + ln))
            r += ln
        elif op in (CINS, CSOFT):
            r += ln
    if not spans:
        return seq, cig
    lo = np.array([s for s, _ in spans])
    hi = np.array([e for _, e in spans])
    pool = rng.integers(0, len(seq), 4 * n_err)
    in_m = pool[((pool[:, None] >= lo[None, :])
                 & (pool[:, None] < hi[None, :])).any(axis=1)]
    if len(in_m) == 0:
        return seq, cig
    # the site loop of the original, drawing the same random numbers:
    # each candidate takes one draw and is kept with p = 0.9 where its
    # 3-neighbourhood is one base, else 0.25, until n_err are kept
    cand = in_m[:2 * n_err].astype(np.int64)
    L = len(seq)
    lo_ = np.maximum(0, cand - 1)
    n_nb = np.minimum(L, cand + 2) - lo_
    a = seq[lo_]
    hp = ((n_nb >= 2) & (seq[np.minimum(lo_ + 1, L - 1)] == a)
          & ((n_nb < 3) | (seq[np.minimum(lo_ + 2, L - 1)] == a)))
    state = rng.bit_generator.state
    acc = rng.random(len(cand)) < np.where(hp, 0.9, 0.25)
    used = min(int(np.searchsorted(np.cumsum(acc), n_err)) + 1, len(cand))
    rng.bit_generator.state = state
    rng.random(used)
    keep = cand[:used][acc[:used]]
    draws = rng.random(2 * len(keep))
    chosen = {}
    for k, p in enumerate(keep.tolist()):
        chosen[p] = ("ins" if draws[2 * k] < 0.55 else "del",
                     1 + int(draws[2 * k + 1] < 0.3))
    events = sorted(chosen.items())
    return _apply_indel_events(seq, cig, events)


def _apply_indel_events(seq: np.ndarray, cig: List[tuple], events
                        ) -> Tuple[np.ndarray, List[tuple]]:
    """Splice (read position -> (ins/del, length)) events into a read's
    sequence and CIGAR; a deletion neither starts the alignment nor ends
    an M run."""
    out_cig: List[list] = []
    out_seq: List[np.ndarray] = []
    r = 0
    ei = 0

    def push(op, ln):
        if ln <= 0:
            return
        if out_cig and out_cig[-1][0] == op:
            out_cig[-1][1] += ln
        else:
            out_cig.append([op, ln])

    for op, ln in cig:
        if op != CMATCH:
            push(op, ln)
            if op in (CINS, CSOFT):
                out_seq.append(seq[r:r + ln])
                r += ln
            continue
        run_end = r + ln
        cur = r
        while ei < len(events) and events[ei][0] < run_end:
            p, (kind, el) = events[ei]
            ei += 1
            if p < cur:
                continue
            if kind == "ins":
                out_seq.append(seq[cur:p + 1])
                push(CMATCH, p + 1 - cur)
                out_seq.append(np.full(el, seq[p], dtype=np.uint8))
                push(CINS, el)
                cur = p + 1
            else:
                if p + 1 >= run_end:
                    continue
                if p == cur and not any(o == CMATCH for o, _ in out_cig):
                    continue
                out_seq.append(seq[cur:p])
                push(CMATCH, p - cur)
                push(CDEL, 1)
                cur = p + 1
        out_seq.append(seq[cur:run_end])
        push(CMATCH, run_end - cur)
        r = run_end
    new_seq = (np.concatenate(out_seq) if out_seq
               else np.zeros(0, np.uint8))
    return new_seq, [(op, ln) for op, ln in out_cig]


def make_record(tid, pos, qname, cigar, seq4, quals, mapq=60, flag=0):
    """One BAM record without its block_size; seq4 in nt4 codes."""
    name = qname.encode() + b"\x00"
    l_seq = len(seq4)
    head = struct.pack("<iiBBHHHiiii", tid, pos, len(name), mapq, 0,
                       len(cigar), flag, l_seq, -1, -1, 0)
    cig = b"".join(struct.pack("<I", (ln << 4) | op) for op, ln in cigar)
    codes = _NT16_LUT[np.asarray(seq4, dtype=np.uint8)]
    if l_seq % 2:
        codes = np.concatenate([codes, np.zeros(1, np.uint8)])
    packed = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8)
    qual = np.asarray(quals, dtype=np.uint8).tobytes()
    return head + name + cig + packed.tobytes() + qual


def synth_reads(ref4: np.ndarray, truth: List[tuple], beg: int, end: int,
                coverage: float, read_len: int, err: float, seed: int,
                qual: int = 35, indel_err: float = 0.0
                ) -> Tuple[List[bytes], int]:
    """The sorted BAM records of diploid reads over [beg, end) and the
    bases they hold."""
    rng = np.random.default_rng(seed)
    haps = [HapMap(ref4, beg, end, truth, 1), HapMap(ref4, beg, end,
                                                     truth, 2)]
    recs = []
    n_bases = 0
    n_reads_per_hap = int(coverage * (end - beg) / read_len / 2)
    for h, hm in enumerate(haps):
        hl = len(hm.seq)
        starts = np.sort(rng.integers(0, max(1, hl - read_len),
                                      n_reads_per_hap))
        for k, s in enumerate(starts):
            s = int(s)
            e = min(s + read_len, hl)
            seq = hm.seq[s:e].copy()
            n_err = rng.poisson(err * len(seq))
            if n_err:
                idx = rng.choice(len(seq), min(n_err, len(seq)),
                                 replace=False)
                seq[idx] = (seq[idx] + 1
                            + rng.integers(0, 3, len(idx))) % 4
            ref_pos, cig = hm.read_cigar(s, e)
            if ref_pos is None or not cig:
                continue
            if indel_err > 0:
                seq, cig = apply_ont_errors(seq, cig, rng, indel_err)
            q_len = sum(ln for op, ln in cig if op in (CMATCH, CINS, CSOFT))
            if q_len != len(seq):
                seq = seq[:q_len]
                if len(seq) < q_len:
                    continue
            n_bases += len(seq)
            recs.append((ref_pos, make_record(
                0, ref_pos, f"s{h+1}_{k:06d}", cig, seq,
                np.full(len(seq), qual, dtype=np.uint8), mapq=60,
                flag=16 if (k % 4) >= 2 else 0)))
    recs.sort(key=lambda r: r[0])
    return [r[1] for r in recs], n_bases


def write_fasta(path: str, tname: str, ref4: np.ndarray) -> None:
    """A FASTA of one contig, 60 bases a line, and its .fai."""
    ascii_seq = np.array([65, 67, 71, 84, 78], dtype=np.uint8)[ref4]
    hdr = f">{tname}\n".encode()
    with open(path, "wb") as fh:
        fh.write(hdr)
        for off in range(0, len(ascii_seq), 60):
            fh.write(ascii_seq[off:off + 60].tobytes() + b"\n")
    with open(path + ".fai", "w") as fh:
        fh.write(f"{tname}\t{len(ascii_seq)}\t{len(hdr)}\t60\t61\n")


def make_contig(task) -> Dict:
    """Build one contig's files; ``task`` is (directory, stem, contig
    name, seed, read model, genome model, length, BGZF level[, keep
    every n-th read]).  Returns what the benchmark keeps of it: paths,
    the planted variants, reads and read bases."""
    d, stem, tname, seed, model, genome, length, level = task[:8]
    every = task[8] if len(task) > 8 else 1
    margin = int(model.get("margin", 2_000))
    ref4, truth = genome_truth(seed, length, model, genome)
    fa = os.path.join(d, stem + ".fa")
    bam = os.path.join(d, stem + ".bam")
    write_fasta(fa, tname, ref4)
    recs, n_bases = synth_reads(
        ref4, truth, margin, length - margin, coverage=model["coverage"],
        read_len=model["read_len"], err=model["sub_err"], seed=seed + 1,
        qual=model["qual"], indel_err=model.get("indel_err", 0.0))
    if every > 1:
        recs = recs[::every]
        n_bases = sum(struct.unpack_from("<i", r, 16)[0] for r in recs)
    bgzf.write_bam(bam, [tname], [length], recs, level=level)
    return {"stem": stem, "tname": tname, "fasta": fa, "bam": bam,
            "length": length, "seed": seed, "n_reads": len(recs),
            "read_bases": n_bases, "truth": truth}


def make_contigs(d: str, tname: str, seeds: Sequence[int], model: Dict,
                 genome: Dict, length: int, procs: int, level: int = 1
                 ) -> List[Dict]:
    """Build one contig per seed in ``d`` on ``procs`` processes (spawned:
    the caller may hold threads and a CUDA context)."""
    tasks = [(d, f"c{k:03d}", tname, int(s), model, genome, int(length),
              level) for k, s in enumerate(seeds)]
    if procs <= 1 or len(tasks) == 1:
        return [make_contig(t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(procs, len(tasks)), mp_context=ctx) as ex:
        return list(ex.map(make_contig, tasks))
