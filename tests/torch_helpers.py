"""Helpers shared by the port's tests (tests/test_torch_*.py),
longcalld_torch/entry.py and chip_smoke.py: VCF bodies, a spy on
run_call's pool dispatch, the seeded synthetic contig they call, random
traceback bytes for the band walk and seeded SV-like pairs for the wide
band buckets.

The contig builder is a copy of tests/synthcontig.py (build_truth,
HapMap, apply_ont_errors, write_synth_bam without the r10 error model,
write_synth_fasta) and tests/util_bam.py (make_record, write_bam) over
the port's io, so that nothing here imports longcalld_tpu; it writes the
same FASTA, BAM and BAI bytes for the same seed
(tests/test_torch_selfcontained.py)."""

import contextlib
import dataclasses
import os
import struct
from typing import List, Tuple

import numpy as np

from longcalld_torch.io.bgzf import BgzfWriter

CMATCH, CINS, CDEL, CSOFT = 0, 1, 2, 4
NT4_TO_NT16 = [1, 2, 4, 8, 15]  # A C G T N
_NT16_LUT = np.array(NT4_TO_NT16, dtype=np.uint8)


def vcf_body(text):
    """The record lines of a VCF text."""
    return [ln for ln in text.splitlines() if not ln.startswith("#")]


def port_opts(opt):
    """The port's own CallOpts with the field values of ``opt``, a CallOpts
    of either package: a port run reads the port's config module only."""
    from longcalld_torch.config import CallOpts
    if isinstance(opt, CallOpts):
        return opt
    return CallOpts(**{f.name: getattr(opt, f.name)
                       for f in dataclasses.fields(CallOpts)})


@contextlib.contextmanager
def pool_calls(module):
    """Record (windows, workers) of every ``module._run_call_procs`` call
    made inside the block; the real function still runs."""
    calls = []
    real = module._run_call_procs

    def spy(opt, out, wins, n_workers, *a, **k):
        calls.append((len(wins), n_workers))
        return real(opt, out, wins, n_workers, *a, **k)

    module._run_call_procs = spy
    try:
        yield calls
    finally:
        module._run_call_procs = real


def phase_window(seed, R=96, V=80, noise=0.03, hp_on=False, no_valid=False):
    """Inputs of the phasing EM for one window (tests/test_torch_phase.py:
    _window): two haplotypes plus noise, reads in random order with
    partial spans, -1 (uncovered) and -2 alleles, digar-less reads,
    unphased reads and a partly filled starting consensus; ``no_valid``
    clears the valid-var mask."""
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 2, V)
    haps = rng.integers(1, 3, R)
    alle = np.where(haps[:, None] == 1, truth[None, :], 1 - truth[None, :])
    alle = np.where(rng.random((R, V)) < noise, 1 - alle, alle)
    starts = rng.integers(0, V, R)
    ends = np.minimum(starts + rng.integers(5, V, R), V - 1)
    cols = np.arange(V)[None, :]
    span = (cols >= starts[:, None]) & (cols <= ends[:, None])
    A = np.where(span, alle, -1)
    A = np.where(span & (rng.random((R, V)) < 0.05), -2, A).astype(np.int8)
    starts, ends = starts.astype(np.int32), ends.astype(np.int32)
    skip = rng.random(R) < 0.05                  # digar-less reads
    starts[skip], ends[skip] = -1, -2
    cons0 = np.stack([truth, 1 - truth]).astype(np.int8)
    cons0[:, rng.random(V) < 0.1] = -1
    flip = rng.random(V) < 0.15                  # consensus to repair
    cons0[:, flip] = cons0[::-1, flip]
    haps0 = np.where(rng.random(R) < 0.1, 0, haps).astype(np.int8)
    valid = rng.random(V) < 0.9
    scoreable = valid & (rng.random(V) < 0.95)
    w_score = rng.integers(0, 4, V).astype(np.int32)
    clean_snp = scoreable & (rng.random(V) < 0.8)
    hp = rng.random(V) < (0.2 if hp_on else 0.0)
    hp_ont = hp & hp_on
    if no_valid:
        valid = np.zeros_like(valid)
    return (A, starts, ends, cons0, haps0, scoreable, w_score, clean_snp,
            valid, hp, hp_ont)


def build_contig(d, seed, length, coverage=20, read_len=10_000,
                 margin=2_000, **bam_kw):
    """A seeded diploid contig of ``length`` bases with planted SNVs,
    indels and ~25 SVs/Mb over [margin, length - margin), and a BAM of
    reads with 0.3% substitutions at ``coverage``.  Returns (FASTA path,
    BAM path, reads written, planted variants)."""
    rng = np.random.default_rng(seed)
    ref4 = rng.integers(0, 4, length).astype(np.uint8)
    truth = build_truth(rng, ref4, margin, length - margin, sv_per_mb=25)
    fa = os.path.join(str(d), f"synth{length}.fa")
    bam = os.path.join(str(d), f"synth{length}.bam")
    write_synth_fasta(fa, "chr1", ref4)
    n_reads = write_synth_bam(bam, "chr1", length, ref4, truth, margin,
                              length - margin, coverage=coverage,
                              read_len=read_len, err=0.003, seed=seed + 1,
                              **bam_kw)
    return fa, bam, n_reads, len(truth)


def random_walk_inputs(rng, B, Lp, n, spread=20, long_runs=False):
    """Inputs of the band walk (tbs, plen, tlen, dlo, finals) made of
    random traceback bytes and finals.  Extension bits are set often, so
    the walk takes every branch and falls off either band edge, which real
    DP output does only in unreachable (all-BIG) regions.  Pairs 0 and 1
    end outside the band, pair 2 near its middle, pair 4 has tied finals
    (the first minimum wins).  Then two blocks of q = max(2, (n-5) // 3)
    full-length pairs: the first ends at b_final in {0, 1, 2} in an I
    state, so it leaves through the left edge (at b_final = 0 always), the
    second at b_final in {B-1, B-2, B-3} in a D state, so it leaves through
    the right edge (at B-1 always).  Needs n >= 9.

    ``long_runs`` makes pairs 0 and 1 plen 0 and 1 and replaces pairs 2
    and 3 by full-length walks of fixed bytes (see _plant_long_runs): pair
    2 collapses an insertion chain of LONG_CHAIN + 1 columns (fewer where
    the band is narrower) and pair 3 takes a run of up to LONG_D + 1 D
    rows, longer than the CUDA kernel's window of 128 columns by 32 rows
    in either direction."""
    src = rng.integers(0, 5, (Lp + 1, n, B), dtype=np.uint8)
    bits = rng.integers(0, 10, (Lp + 1, n, B, 4), dtype=np.uint8) \
        < np.array([9, 9, 6, 6], dtype=np.uint8)
    tbs = src
    for k in range(4):
        tbs |= bits[..., k].astype(np.uint8) << (3 + k)
    q = max(2, (n - 5) // 3)
    left, right = np.arange(5, 5 + q), np.arange(5 + q, 5 + 2 * q)
    plen = rng.integers(0, Lp + 1, n).astype(np.int32)
    plen[5:5 + 2 * q] = Lp
    tlen = np.maximum(plen + rng.integers(-spread, spread, n),
                      0).astype(np.int32)
    dlo = (np.minimum(0, tlen - plen)
           - (B - np.abs(tlen - plen)) // 2).astype(np.int32)
    dlo[:3] += np.array([-B, B, 3], dtype=np.int32)
    finals = rng.integers(0, 50, (n, 5)).astype(np.int32)
    finals[4] = 7
    # PERM order [I1, I2, D1, D2, M]: the minimum picks the first state
    for idx, b_final, first in ((left, left % 3, left % 2),
                                (right, B - 1 - right % 3, 2 + right % 2)):
        dlo[idx] = tlen[idx] - plen[idx] - b_final
        finals[idx] = 9
        finals[idx, first] = 1
    if long_runs:
        plen[:2] = (0, 1)
        _plant_long_runs(tbs, plen, tlen, dlo, finals, B, Lp)
    return tbs, plen, tlen, dlo, finals


LONG_CHAIN = 150      # columns of the long insertion chain (pair 2)
LONG_D = 45           # rows of the long D run (pair 3)


def long_run_rows(Lp):
    """(row of the chain, D rows) of the long-run pairs at this Lp: the
    chain 40 rows below plen (mid-way down the kernel's second window of
    32 rows) or half way down a short pair, and the D run right below it,
    down to row 1 at most."""
    ic = Lp - min(40, Lp // 2)
    return ic, min(LONG_D, ic - 1)


def _plant_long_runs(tbs, plen, tlen, dlo, finals, B, Lp):
    """Pairs 2 and 3 as full-length M walks (every byte 0) that start in
    M: pair 2 at b_final = B - 20 turns into I1 at row ic and collapses a
    chain of min(LONG_CHAIN, b_final - 1) + 1 columns on row ic - 1; pair
    3 at b_final = 10 turns into D1 at row ic and keeps extending for the
    D rows of long_run_rows, so its position drifts right by as many
    columns."""
    ic, d_rows = long_run_rows(Lp)
    for k, b_final in ((2, B - 20), (3, 10)):
        tbs[:, k, :] = 0
        plen[k] = Lp
        dlo[k] = tlen[k] - Lp - b_final
        finals[k] = 9
        finals[k, 4] = 1                       # PERM M: start in state M
    p = B - 20
    chain = min(LONG_CHAIN, p - 1)
    tbs[ic, 2, p] = 1                          # source I1
    tbs[ic - 1, 2, p - chain + 1:p + 1] = 1 << 3    # I1 extends; stops at
    # column p - chain
    tbs[ic, 3, 10] = 3                         # source D1
    tbs[ic - d_rows:ic, 3, :] = 1 << 5         # D1 extends on every row


# SV sizes of sv_pairs: with BatchAligner's band_pad of 64 their band
# buckets are 1024, 4096 and 5128 (past 4096: the kernels do not take it)
SV_WIDTHS = {500: 1024, 1500: 4096, 5000: 5128}


def sv_pairs(seed, n=900):
    """Seeded SV-like pairs, one group per width w of SV_WIDTHS: an n bp
    pattern against a text with a w bp insertion, and the same two
    sequences swapped (a w bp deletion)."""
    rng = np.random.default_rng(seed)
    groups = {}
    for w in SV_WIDTHS:
        p = rng.integers(0, 4, n).astype(np.uint8)
        a = int(rng.integers(n // 4, 3 * n // 4))
        t = np.concatenate([p[:a], rng.integers(0, 4, w).astype(np.uint8),
                            p[a:]])
        groups[w] = [(p, t), (t, p)]
    return groups


# ---- the seeded contig (copies of tests/synthcontig.py, tests/util_bam.py)

def make_record(tid, pos, qname, cigar, seq4, quals, mapq=60, flag=0,
                tags=b""):
    """cigar: list of (op, len) BAM codes; seq4: nt4 codes."""
    name = qname.encode() + b"\x00"
    n_cigar = len(cigar)
    l_seq = len(seq4)
    head = struct.pack("<iiBBHHHiiii", tid, pos, len(name), mapq, 0,
                       n_cigar, flag, l_seq, -1, -1, 0)
    cig = b"".join(struct.pack("<I", (ln << 4) | op) for op, ln in cigar)
    codes = _NT16_LUT[np.asarray(seq4, dtype=np.uint8)]
    if l_seq % 2:
        codes = np.concatenate([codes, np.zeros(1, np.uint8)])
    packed = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8)
    qual = np.asarray(quals, dtype=np.uint8).tobytes()
    return head + name + cig + packed.tobytes() + qual + tags


def write_bam(path, references, lengths, records):
    """records: list of raw record bytes (no block_size prefix)."""
    with open(path, "wb") as fh:
        w = BgzfWriter(fh)
        text = "".join(f"@SQ\tSN:{n}\tLN:{l}\n"
                       for n, l in zip(references, lengths))
        hdr = bytearray(b"BAM\x01")
        hdr += struct.pack("<i", len(text)) + text.encode()
        hdr += struct.pack("<i", len(references))
        for n, l in zip(references, lengths):
            nb = n.encode() + b"\x00"
            hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
        w.write(bytes(hdr))
        for rec in records:
            w.write(struct.pack("<i", len(rec)) + rec)
        w.close()


def build_truth(rng: np.random.Generator, ref4: np.ndarray, beg: int,
                end: int, snv_per_kb: float = 1.0,
                indel_per_kb: float = 0.125, sv_per_mb: float = 5.0,
                min_gap: int = 150) -> List[tuple]:
    """Plant variants at realistic human-ish densities over [beg, end):
    returns sorted [(pos, kind, payload, gt)] with payload = alt base
    (snv) / base list (ins) / deletion length (del).  SVs are ins/del of
    50-400 bp; small indels 1-12 bp."""
    span = end - beg
    n_snv = rng.poisson(snv_per_kb * span / 1000)
    n_ind = rng.poisson(indel_per_kb * span / 1000)
    n_sv = rng.poisson(sv_per_mb * span / 1e6)
    events = []
    for _ in range(n_snv):
        events.append(("snv", None))
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
    # enforce min_gap between consecutive sites (vectorized prune)
    keep = np.ones(len(pos_pool), dtype=bool)
    last = -10**18
    for i, p in enumerate(pos_pool):
        if p - last < min_gap:
            keep[i] = False
        else:
            last = p
    pos_pool = pos_pool[keep]
    truth = []
    for pos, (kind, ln) in zip(pos_pool, events):
        pos = int(pos)
        gt = ("hom" if rng.random() < 0.35
              else ("het1" if rng.random() < 0.5 else "het2"))
        if kind == "snv":
            payload = (int(ref4[pos]) + 1 + int(rng.integers(3))) % 4
        elif kind == "ins":
            payload = rng.integers(0, 4, ln).astype(np.uint8)
        else:
            ln = min(ln, 120) if ln < 50 else ln   # dels bounded by gap
            if ln >= min_gap - 30:
                ln = min_gap - 30
            payload = int(ln)
        truth.append((pos, kind, payload, gt))
    return truth


class HapMap:
    """One haplotype: stitched sequence + run-length hap-to-ref map."""

    def __init__(self, ref4: np.ndarray, beg: int, end: int,
                 truth: List[tuple], hap: int):
        segs: List[np.ndarray] = []
        ops: List[int] = []
        lens: List[int] = []          # length in hap coords (I/M) or ref (D)
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
        self.beg = beg                 # ref coord of hap position 0

    def read_cigar(self, s: int, e: int) -> Tuple[int, list]:
        """CIGAR (list of (op, len)) and 0-based ref start for the read
        covering hap coords [s, e)."""
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
                        # a read starting inside an insertion: soft-clip
                        # the leading inserted bases so POS stays on ref
                        cig.append([CSOFT, hi - lo])
                        continue
                cig.append([op, hi - lo])
            else:
                if ref_pos is None or s >= e:
                    continue
                if cig and s < e:
                    cig.append([CDEL, ln])
        # merge adjacent same-op runs
        out = []
        for op, ln in cig:
            if out and out[-1][0] == op:
                out[-1][1] += ln
            else:
                out.append([op, ln])
        # trailing DEL is illegal; drop it
        while out and out[-1][0] == CDEL:
            out.pop()
        while out and out[0][0] == CDEL:
            ref_pos += out[0][1]
            out.pop(0)
        return ref_pos, [(op, ln) for op, ln in out]


def apply_ont_errors(seq: np.ndarray, cig: List[tuple],
                     rng: np.random.Generator, indel_rate: float
                     ) -> Tuple[np.ndarray, List[tuple]]:
    """Inject ONT-style 1-2 bp indel errors into a read: error sites are
    biased into homopolymer context (the dominant real ONT error mode and
    the reason for the reference's 67% homopolymer-majority consensus
    rule, reference/src/assign_hap.c:264), implemented as
    insertions duplicating the local base or 1 bp deletions inside M
    runs."""
    n_err = rng.poisson(indel_rate * len(seq))
    if n_err == 0:
        return seq, cig
    # read positions currently consumed by M runs
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
    # homopolymer bias: keep a site with p=0.9 if its 3-neighborhood is a
    # run of one base, else p=0.25
    keep = []
    for p in in_m[:2 * n_err]:
        p = int(p)
        s = seq[max(0, p - 1):p + 2]
        hp = len(s) >= 2 and (s == s[0]).all()
        if rng.random() < (0.9 if hp else 0.25):
            keep.append(p)
        if len(keep) >= n_err:
            break
    events = sorted({p: ("ins" if rng.random() < 0.55 else "del",
                         1 + int(rng.random() < 0.3))
                     for p in keep}.items())
    return _apply_indel_events(seq, cig, events)


def _apply_indel_events(seq: np.ndarray, cig: List[tuple], events
                        ) -> Tuple[np.ndarray, List[tuple]]:
    """Splice (read_pos -> ins/del) error events into a read's seq+CIGAR
    (shared by both ONT error models; a deletion may neither start the
    alignment nor end an M run)."""
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
        if op not in (CMATCH,):
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
                    continue    # deletion may not end a run
                if p == cur and not any(o == CMATCH for o, _ in out_cig):
                    continue    # a deletion may not START the alignment
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


def write_synth_bam(path: str, tname: str, ref_len: int, ref4: np.ndarray,
                    truth: List[tuple], beg: int, end: int,
                    coverage: float = 20.0, read_len: int = 12_000,
                    err: float = 0.003, seed: int = 0,
                    qual: int = 35, indel_err: float = 0.0,
                    extra_refs=None) -> int:
    """Write a sorted BAM of diploid reads over [beg, end); returns the
    number of reads.  ``indel_err`` > 0 adds ONT-style indel errors
    (apply_ont_errors)."""
    rng = np.random.default_rng(seed)
    haps = [HapMap(ref4, beg, end, truth, 1), HapMap(ref4, beg, end,
                                                     truth, 2)]
    recs = []
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
            # consumed-length consistency
            q_len = sum(ln for op, ln in cig if op in (CMATCH, CINS, CSOFT))
            if q_len != len(seq):
                seq = seq[:q_len]
                if len(seq) < q_len:
                    continue
            recs.append((ref_pos, make_record(
                0, ref_pos, f"s{h+1}_{k:06d}", cig, seq,
                np.full(len(seq), qual, dtype=np.uint8), mapq=60,
                flag=16 if (k % 4) >= 2 else 0)))
    recs.sort(key=lambda r: r[0])
    names, lens = [tname], [ref_len]
    for en, el in (extra_refs or []):
        names.append(en)
        lens.append(el)
    write_bam(path, names, lens, [r[1] for r in recs])
    # true random access: bench/procs workers fetch only their window
    # spans instead of inflating the whole file (io/bam.build_bai)
    from longcalld_torch.io.bam import build_bai
    build_bai(path)
    return len(recs)


def write_synth_fasta(path: str, tname, ref4) -> None:
    """Write a FASTA (+.fai).  ``tname``/``ref4`` may be lists for a
    multi-contig file (the WGS bench leg adds a read-free contig to
    demonstrate index-driven window skipping at scale)."""
    tnames = tname if isinstance(tname, (list, tuple)) else [tname]
    refs = ref4 if isinstance(ref4, (list, tuple)) else [ref4]
    nt = np.array([65, 67, 71, 84, 78], dtype=np.uint8)  # ACGTN
    fai = []
    off_bytes = 0
    with open(path, "wb") as fh:
        for tn, r4 in zip(tnames, refs):
            ascii_seq = nt[r4]
            hdr = f">{tn}\n".encode()
            fh.write(hdr)
            off_bytes += len(hdr)
            fai.append(f"{tn}\t{len(ascii_seq)}\t{off_bytes}\t60\t61\n")
            for off in range(0, len(ascii_seq), 60):
                fh.write(ascii_seq[off:off + 60].tobytes() + b"\n")
            off_bytes += len(ascii_seq) + (len(ascii_seq) + 59) // 60
    with open(path + ".fai", "w") as fh:
        fh.writelines(fai)
