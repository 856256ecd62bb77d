"""The frozen input generator: a seeded diploid contig with planted
variants, its FASTA (+.fai), and a sorted, indexed BAM of reads drawn
from its two haplotypes.

A copy of the contig builder of ``tests/torch_helpers.py`` (contig_truth,
build_truth, HapMap, apply_ont_errors, make_record, write_synth_bam,
write_synth_fasta), drawing the same random numbers in the same order, so
that one seed gives the same FASTA and the same BAM records
(``perfbench/tests/test_gen.py`` holds them equal).  It writes its BGZF
and index with ``perfbench/bgzf.py`` and imports nothing of the program.
``make_contigs`` builds many contigs on a pool of processes and records
each one's read bases, the amount of work the benchmark's rate counts."""

from __future__ import annotations

import multiprocessing
import os
import struct
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np

from perfbench import bgzf

CMATCH, CINS, CDEL, CSOFT = 0, 1, 2, 4
_NT16_LUT = np.array([1, 2, 4, 8, 15], dtype=np.uint8)   # A C G T N


def contig_truth(seed, length, margin=2_000, snv_per_kb=1.0,
                 indel_per_kb=0.125, sv_per_mb=25.0):
    """(reference as nt4 codes, planted variants) of the contig of this
    seed and length."""
    rng = np.random.default_rng(seed)
    ref4 = rng.integers(0, 4, length).astype(np.uint8)
    return ref4, build_truth(rng, ref4, margin, length - margin,
                             snv_per_kb=snv_per_kb,
                             indel_per_kb=indel_per_kb, sv_per_mb=sv_per_mb)


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
    ref4, truth = contig_truth(seed, length, margin, **genome)
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
