"""Helpers shared by the port's tests (tests/test_torch_*.py),
longcalld_torch/entry.py, chip_smoke.py and tests/soak_torch.py: VCF
bodies, a spy on
run_call's pool dispatch, the seeded synthetic contig they call, random
traceback bytes for the band walk, seeded SV-like pairs for the wide
band buckets, and the F1 scoring of bench_torch.py's F1 leg.

The contig builder is a copy of tests/synthcontig.py (build_truth,
HapMap, apply_ont_errors, write_synth_bam without the r10 error model,
write_synth_fasta) and tests/util_bam.py (make_record, write_bam, and
sim_read, the read simulator of tests/soak_torch.py) over the port's io,
so that nothing here imports longcalld_tpu; it writes the same FASTA, BAM
and BAI bytes for the same seed (tests/test_torch_selfcontained.py holds
sim_read's source to util_bam's).  evaluate_f1 and classify_fn_causes
are copies of tests/synthcontig.py's and tests/fnclassify.py's over the
port's modules; tests/test_torch_bench.py holds them to equal dicts."""

import contextlib
import dataclasses
import os
import struct
from typing import Dict, List, Tuple

import numpy as np

from longcalld_torch import config
from longcalld_torch.io.bam import CDIFF
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


def contig_truth(seed, length, margin=2_000):
    """(reference as nt4 codes, planted variants) of build_contig's
    contig for this seed and length."""
    rng = np.random.default_rng(seed)
    ref4 = rng.integers(0, 4, length).astype(np.uint8)
    return ref4, build_truth(rng, ref4, margin, length - margin,
                             sv_per_mb=25)


def build_contig(d, seed, length, coverage=20, read_len=10_000,
                 margin=2_000, **bam_kw):
    """A seeded diploid contig of ``length`` bases with planted SNVs,
    indels and ~25 SVs/Mb over [margin, length - margin), and a BAM of
    reads with 0.3% substitutions at ``coverage``.  Returns (FASTA path,
    BAM path, reads written, planted variants)."""
    ref4, truth = contig_truth(seed, length, margin)
    fa = os.path.join(str(d), f"synth{length}.fa")
    bam = os.path.join(str(d), f"synth{length}.bam")
    write_synth_fasta(fa, "chr1", ref4)
    n_reads = write_synth_bam(bam, "chr1", length, ref4, truth, margin,
                              length - margin, coverage=coverage,
                              read_len=read_len, err=0.003, seed=seed + 1,
                              **bam_kw)
    return fa, bam, n_reads, len(truth)


def random_walk_inputs(rng, B, Lp, n, spread=20, long_runs=False,
                       overflow=False):
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
    in either direction.

    ``overflow`` replaces the last two pairs by the walks that the event
    compaction cannot encode (see _plant_overflow): pair n-2 emits an
    event on two rows of every three, more than K = 512 at Lp >= 800,
    and pair n-1 collapses an insertion chain of B columns on its first
    row, more than the 4095 that an event holds at B 4096.  Needs n >= 16
    (the last two pairs are then outside the edge blocks)."""
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
    if overflow:
        assert n >= 16
        _plant_overflow(tbs, plen, tlen, dlo, finals, B, Lp)
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


def _plant_overflow(tbs, plen, tlen, dlo, finals, B, Lp):
    """The last two pairs as full-length walks of fixed bytes.  Pair n-2
    starts in M at the odd column p = B/2 + 1 of a band whose even
    columns hold source D1 and odd ones source I1, no extension bit set:
    its walk cycles an I row of one column (p to p-1), a D row back to p
    and an M row, so it keeps in the band and makes an event on two rows
    of every three.  Pair n-1 starts in I1 at column B-1 of a first row
    whose I1 extension bits are all set: the chain has no stop, covers B
    columns (n_ins = B) and leaves the band through the left edge; then M
    rows to the end."""
    n = plen.shape[0]
    for k, b_final, first in ((n - 2, B // 2 + 1, 4), (n - 1, B - 1, 0)):
        tbs[:, k, :] = 0
        plen[k] = Lp
        dlo[k] = tlen[k] - Lp - b_final
        finals[k] = 9
        finals[k, first] = 1                   # PERM M / I1
    tbs[:, n - 2, 0::2] = 3                    # source D1
    tbs[:, n - 2, 1::2] = 1                    # source I1
    tbs[Lp, n - 1, :] = 1 << 3                 # I1 extends everywhere


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


# ---- the seeded contig and the soak's reads (copies of
# tests/synthcontig.py and tests/util_bam.py)

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


def sim_read(rng, ref4, start, length, hap, variants, err):
    """Simulate one read over ref4[start:start+length) for haplotype
    `hap` (1/2).  `variants`: {pos: (kind, payload, gt)} with kind in
    snv/ins/del, gt in het1/het2/hom; payload = alt base / ins base list /
    del length.  Returns (seq4, cigar)."""
    from longcalld_torch.io.bam import CDEL, CDIFF, CEQUAL, CINS
    seq = []
    cig = []

    def push(op, ln):
        if ln <= 0:
            return
        if cig and cig[-1][0] == op:
            cig[-1][1] += ln
        else:
            cig.append([op, ln])

    i = start
    end = start + length
    while i < end:
        base = int(ref4[i])
        v = variants.get(i)
        on_hap = v is not None and (
            v[2] == "hom" or (v[2] == "het1" and hap == 1)
            or (v[2] == "het2" and hap == 2))
        if on_hap:
            kind, payload, _ = v
            if kind == "snv":
                seq.append(payload)
                push(CDIFF, 1)
                i += 1
                continue
            if kind == "ins":
                seq.append(base)
                push(CEQUAL, 1)
                seq.extend(payload)
                push(CINS, len(payload))
                i += 1
                continue
            seq.append(base)
            push(CEQUAL, 1)
            push(CDEL, payload)
            i += 1 + payload
            continue
        if rng.random() < err:
            seq.append((base + 1 + int(rng.integers(3))) % 4)
            push(CDIFF, 1)
        else:
            seq.append(base)
            push(CEQUAL, 1)
        i += 1
    import numpy as _np
    return _np.array(seq, dtype=_np.uint8), [(op, ln) for op, ln in cig]


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


# ---- the F1 evaluator and the false-negative classifier (copies of
# tests/synthcontig.py:evaluate_f1 with its helpers, and of
# tests/fnclassify.py over the port's modules)

NT4 = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}


def _norm_indel(ref_str: str, alt_str: str):
    """Strip the shared anchor base; returns (kind, payload_len, seq)."""
    if len(alt_str) > len(ref_str):
        return "ins", len(alt_str) - len(ref_str)
    return "del", len(ref_str) - len(alt_str)


def _left_norm_del(ref4: np.ndarray, anchor: int, ln: int) -> int:
    """Canonical (leftmost) anchor for a deletion of ref[anchor+1 ..
    anchor+ln]: shift left while the base entering the deleted window
    from the left equals the one leaving it on the right."""
    s = anchor + 1
    while s > 1 and ref4[s - 1] == ref4[s + ln - 1]:
        s -= 1
    return s - 1


def _left_norm_ins(ref4: np.ndarray, anchor: int, seq) -> int:
    """Canonical (leftmost) anchor for an insertion after ``anchor``:
    rotate the inserted sequence left past equal reference bases."""
    seq = list(np.asarray(seq)) if not isinstance(seq, int) else None
    a = anchor
    if seq is None:
        return a
    k = 0
    while a > 0 and ref4[a] == seq[(len(seq) - 1 - k) % len(seq)]:
        a -= 1
        k += 1
    return a


def evaluate_f1(vcf_body: List[str], truth: List[tuple],
                beg: int, end: int, ref4: np.ndarray = None,
                sv_pos_tol: int = 60,
                sv_len_tol: float = 0.25,
                return_fns: bool = False) -> Dict[str, dict]:
    """Score called records against the planted truth.

    snv: exact pos + alt base.  indel (<50): kind + length at the
    LEFT-NORMALIZED position (the caller left-aligns gaps, so planted and
    called anchors differ by homopolymer/repeat shifts that are pure
    representation, not errors — the same reason hap.py-style truth
    comparison normalizes).  sv (>=50): pos within sv_pos_tol, kind
    match, length within sv_len_tol.
    Returns {class: {tp, fp, fn, precision, recall, f1}}."""
    def clas(kind, payload):
        if kind == "snv":
            return "snv"
        ln = payload if isinstance(payload, int) else len(payload)
        return "sv" if ln >= 50 else "indel"

    truth_in = [(p, k, pl, gt) for p, k, pl, gt in truth if beg <= p < end]
    t_by_class: Dict[str, list] = {"snv": [], "indel": [], "sv": []}
    for p, k, pl, gt in truth_in:
        t_by_class[clas(k, pl)].append((p, k, pl))
    calls: Dict[str, list] = {"snv": [], "indel": [], "sv": []}
    for ln_ in vcf_body:
        if ln_.startswith("#"):
            continue
        f = ln_.split("\t")
        pos1 = int(f[1])
        ref_s, alt_s = f[3], f[4].split(",")[0]
        if len(ref_s) == 1 and len(alt_s) == 1:
            calls["snv"].append((pos1 - 1, NT4.get(alt_s.upper(), 4)))
        else:
            kind, ln = _norm_indel(ref_s, alt_s)
            a = pos1 - 1
            if ref4 is not None:
                if kind == "ins":
                    seq = [NT4.get(c, 4) for c in alt_s[1:].upper()]
                    a = _left_norm_ins(ref4, a, seq)
                else:
                    a = _left_norm_del(ref4, a, ln)
            calls["sv" if ln >= 50 else "indel"].append((a, kind, ln))
    out = {}
    fns: Dict[str, list] = {"snv": [], "indel": [], "sv": []}
    # snv: truth pos is 0-based planted position; VCF pos1-1 == pos
    t_snv = {(p, pl) for p, k, pl in t_by_class["snv"]}
    c_snv = set(calls["snv"])
    tp = len(t_snv & c_snv)
    out["snv"] = _prf(tp, len(c_snv) - tp, len(t_snv) - tp)
    fns["snv"] = sorted(t_snv - c_snv)
    # indel: left-normalized anchor + kind + length on both sides
    t_ind = set()
    for p, k, pl in t_by_class["indel"]:
        ln = pl if isinstance(pl, (int, np.integer)) else len(pl)
        a = p
        if ref4 is not None:
            a = (_left_norm_ins(ref4, p, pl) if k == "ins"
                 else _left_norm_del(ref4, p, int(pl)))
        t_ind.add((a, k, int(ln)))
    c_ind = set(calls["indel"])
    tp = len(t_ind & c_ind)
    out["indel"] = _prf(tp, len(c_ind) - tp, len(t_ind) - tp)
    fns["indel"] = sorted(t_ind - c_ind)
    # sv: fuzzy match
    t_sv = [(p, k, pl if isinstance(pl, int) else len(pl))
            for p, k, pl in t_by_class["sv"]]
    used = [False] * len(t_sv)
    tp = 0
    fp = 0
    for cp, ck, cl in calls["sv"]:
        hit = False
        for i, (p, k, ln) in enumerate(t_sv):
            if used[i] or k != ck:
                continue
            if abs(cp - p) <= sv_pos_tol and \
                    abs(cl - ln) <= sv_len_tol * max(cl, ln):
                used[i] = True
                tp += 1
                hit = True
                break
        if not hit:
            fp += 1
    out["sv"] = _prf(tp, fp, len(t_sv) - tp)
    fns["sv"] = sorted(t for t, u in zip(t_sv, used) if not u)
    if return_fns:
        return out, fns
    return out


def _prf(tp: int, fp: int, fn: int) -> dict:
    p = tp / (tp + fp) if tp + fp else 0.0
    r = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    return {"tp": tp, "fp": fp, "fn": fn, "precision": round(p, 4),
            "recall": round(r, 4), "f1": round(f1, 4)}


def _match_window(kind: str) -> int:
    return 0 if kind == "snv" else 60


def _event_matches(kind: str, length: int, pos1: int, e_pos: int,
                   e_type: int, e_len: int, tol_pos: int) -> bool:
    if kind == "snv":
        return e_type == CDIFF and e_pos == pos1
    want = CINS if kind == "ins" else CDEL
    if e_type != want or abs(e_pos - pos1) > tol_pos:
        return False
    lo, hi = min(e_len, length), max(e_len, length)
    return lo >= 0.7 * hi


def _classify_one(opt, chunk, kind: str, pos0: int, length: int,
                  made_positions: Dict[int, list]) -> str:
    pos1 = pos0 + 1                     # digar/cand coordinates are 1-based
    tol = _match_window("snv" if kind == "snv" else "indel")
    if kind != "snv":
        tol = max(tol, length)

    # 1. read-event support straight from the digars
    n_alt = 0
    n_cov = 0
    for ri in chunk.order:
        d = chunk.digars[ri]
        if d is None:
            continue
        if d.beg > pos1 or d.end < pos1:
            continue
        n_cov += 1
        m = d.var_mask()
        for k in np.nonzero(m)[0]:
            if _event_matches(kind, length, pos1, int(d.pos[k]),
                              int(d.type[k]), int(d.len[k]), tol):
                n_alt += 1
                break
    if n_cov == 0:
        return "no_reads_in_window"
    if n_alt == 0:
        return "no_read_event_support"

    # 2. emitted-but-unmatched: a same-type record exists nearby
    #    (left-normalization / representation difference, not a miss)
    for mp in made_positions.get(kind, []):
        if abs(mp - pos1) <= max(tol, 1 if kind == "snv" else 25):
            return "called_not_matched"

    # 3. the final candidate list
    cand = chunk.cand_vars
    cate = chunk.var_cate
    found = -1
    if cand is not None:
        want_t = CDIFF if kind == "snv" else (CINS if kind == "ins"
                                              else CDEL)
        for i in range(len(cand)):
            cp = int(cand.pos[i])
            if cand.type[i] != want_t:
                continue
            if kind == "snv":
                if cp == pos1:
                    found = i
                    break
            elif abs(cp - pos1) <= max(tol, 25):
                e_len = int(cand.alt_len[i] if kind == "ins"
                            else cand.ref_len[i])
                lo, hi = min(e_len, length), max(e_len, length)
                if lo >= 0.7 * hi:
                    found = i
                    break
    if found >= 0:
        c = int(cate[found])
        if c == config.CAND_SOMATIC_VAR:
            return "demoted_low_af_somatic"
        if cand.hap_cons_alle is not None and \
                cand.hap_cons_alle[found, 1] <= 0 and \
                cand.hap_cons_alle[found, 2] <= 0:
            return "genotyped_refcall"
        dp = int(cand.total_cov[found])
        ad1 = int(cand.alle_covs[found, 1])
        if dp < opt.min_dp or ad1 < opt.min_alt_dp:
            return "write_time_filtered"
        return "called_not_matched"

    # 4. not a surviving candidate
    in_noisy = False
    if chunk.noisy_regs is not None and len(chunk.noisy_regs) > 0:
        lo = pos1 - (tol if kind != "snv" else 0)
        hi = pos1 + (tol if kind != "snv" else 0)
        in_noisy = len(chunk.noisy_regs.overlap_indices(lo, hi)) > 0
    if in_noisy:
        return "dropped_in_noisy_reassembly"
    if n_alt < opt.min_alt_dp:
        return "alt_support_below_min"
    if n_cov < opt.min_dp:
        return "low_coverage_site"
    if n_alt < opt.min_af * n_cov:
        return "demoted_low_af_somatic"
    return "classified_out_clean"


def classify_fn_causes(opt, fasta, bams, fns: Dict[str, list],
                       tname: str, contig_len: int,
                       max_examples: int = 3) -> dict:
    """Bucket every FN by pipeline cause.  ``fns`` is evaluate_f1's
    return_fns payload: snv [(pos0, alt4)], indel/sv [(anchor0, kind,
    len)].  Windows containing FNs are re-run once each through
    load_chunk + call_window (host-only)."""
    from longcalld_torch.core import genotype
    from longcalld_torch.core.pipeline import call_window, load_chunk
    from longcalld_torch.core.windows import Window

    opt = dataclasses.replace(opt, use_device=False, host_procs=0)
    wsize = opt.window_size
    items: List[Tuple[int, str, int, int]] = []   # (pos0, kind, len, cls_i)
    for p, _alt in fns.get("snv", []):
        items.append((int(p), "snv", 1, 0))
    for a, k, ln in fns.get("indel", []):
        items.append((int(a), k, int(ln), 1))
    for a, k, ln in fns.get("sv", []):
        items.append((int(a), k, int(ln), 2))

    by_win: Dict[int, list] = {}
    for it in items:
        by_win.setdefault(it[0] // wsize, []).append(it)

    tid = bams[0].name2tid(tname) if hasattr(bams[0], "name2tid") else 0
    hist: Dict[str, dict] = {}
    for wi in sorted(by_win):
        beg = wi * wsize + 1
        end = min((wi + 1) * wsize, contig_len)
        win = Window(tid, tname, beg, end, 0, wi)
        chunk = load_chunk(opt, fasta, bams, win, None, None)
        made_positions: Dict[str, list] = {}
        if chunk is not None:
            call_window(opt, chunk)
            for v in genotype.make_variants(opt, chunk):
                if v.n_alt_allele == 0 or v.dp < opt.min_dp \
                        or v.ad[1] < opt.min_alt_dp:
                    continue
                a0 = v.alt_bases[0]
                if v.ref_len == 1 and len(a0) == 1:
                    made_positions.setdefault("snv", []).append(v.pos)
                elif len(a0) > v.ref_len:
                    made_positions.setdefault("ins", []).append(v.pos)
                else:
                    made_positions.setdefault("del", []).append(v.pos)
        for pos0, kind, length, cls_i in by_win[wi]:
            if chunk is None:
                cause = "no_reads_in_window"
            else:
                cause = _classify_one(opt, chunk, kind, pos0, length,
                                      made_positions)
            b = hist.setdefault(cause, {"n": 0, "by_class": [0, 0, 0],
                                        "examples": []})
            b["n"] += 1
            b["by_class"][cls_i] += 1
            if len(b["examples"]) < max_examples:
                b["examples"].append(f"{tname}:{pos0 + 1}:{kind}{length}")
    total = sum(b["n"] for b in hist.values())
    return {
        "total_fns": total,
        "buckets": dict(sorted(hist.items(), key=lambda kv: -kv[1]["n"])),
        "by_class_order": ["snv", "indel", "sv"],
    }
