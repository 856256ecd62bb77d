"""The frozen generator writes what tests/torch_helpers.py's contig
builder writes for one seed: the same FASTA and .fai bytes, and, at the
same BGZF level, the same BAM and BAI bytes; its ONT reads are the same
records."""

import filecmp
import os
import sys

import numpy as np

from perfbench import gen

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_helpers as th  # noqa: E402

HIFI = {"coverage": 30, "read_len": 15000, "sub_err": 0.003, "qual": 35}


def test_hifi_contig_bytes_equal_the_test_builder(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    fa, bam, n_reads, n_truth = th.build_contig(
        a, 20261017, 200_000, coverage=30, read_len=15000)
    got = gen.make_contig((str(b), "x", "chr1", 20261017, HIFI, {},
                           200_000, 6))
    assert got["n_reads"] == n_reads and len(got["truth"]) == n_truth
    for mine, theirs in ((got["fasta"], fa), (got["bam"], bam)):
        for ext in ("", ".fai" if mine.endswith(".fa") else ".bai"):
            assert filecmp.cmp(mine + ext, theirs + ext, shallow=False)


def test_ont_reads_equal_the_test_builder():
    ref4, truth = gen.contig_truth(7, 300_000)
    ref4b, truthb = th.contig_truth(7, 300_000)
    assert np.array_equal(ref4, ref4b) and len(truth) == len(truthb)
    recs, n_bases = gen.synth_reads(ref4, truth, 2000, 298_000, 30, 20000,
                                    0.004, 8, qual=20, indel_err=0.006)
    rng = np.random.default_rng(8)
    haps = [th.HapMap(ref4, 2000, 298_000, truth, h) for h in (1, 2)]
    theirs = []
    n_per = int(30 * 296_000 / 20000 / 2)
    for h, hm in enumerate(haps):
        starts = np.sort(rng.integers(0, max(1, len(hm.seq) - 20000), n_per))
        for k, s in enumerate(starts):
            s = int(s)
            seq = hm.seq[s:min(s + 20000, len(hm.seq))].copy()
            n_err = rng.poisson(0.004 * len(seq))
            if n_err:
                idx = rng.choice(len(seq), min(n_err, len(seq)),
                                 replace=False)
                seq[idx] = (seq[idx] + 1 + rng.integers(0, 3, len(idx))) % 4
            ref_pos, cig = hm.read_cigar(s, min(s + 20000, len(hm.seq)))
            if ref_pos is None or not cig:
                continue
            seq, cig = th.apply_ont_errors(seq, cig, rng, 0.006)
            q_len = sum(ln for op, ln in cig if op in (0, 1, 4))
            if q_len != len(seq):
                seq = seq[:q_len]
                if len(seq) < q_len:
                    continue
            theirs.append((ref_pos, th.make_record(
                0, ref_pos, f"s{h+1}_{k:06d}", cig, seq,
                np.full(len(seq), 20, dtype=np.uint8), mapq=60,
                flag=16 if (k % 4) >= 2 else 0)))
    theirs.sort(key=lambda r: r[0])
    assert recs == [r[1] for r in theirs]
    assert n_bases == sum(
        int.from_bytes(r[16:20], "little") for r in recs)


def test_contigs_on_a_pool_match_one_process(tmp_path):
    seeds = [11, 13, 17]
    many = gen.make_contigs(str(tmp_path), "chr1", seeds, HIFI, {}, 60_000,
                            procs=3)
    (tmp_path / "one").mkdir()
    one = [gen.make_contig((str(tmp_path / "one"), f"c{k:03d}", "chr1", s,
                            HIFI, {}, 60_000, 1))
           for k, s in enumerate(seeds)]
    assert len(many) == len(one) == 3
    for a, b in zip(many, one):
        assert a["read_bases"] == b["read_bases"] > 0
        assert filecmp.cmp(a["bam"], b["bam"], shallow=False)
