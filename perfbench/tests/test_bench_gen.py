"""The frozen generator writes what tests/torch_helpers.py's contig
builder writes for one seed: the same FASTA and .fai bytes, and, at the
same BGZF level, the same BAM and BAI bytes; its ONT reads are the same
records.  The accepted configurations' contigs are byte-equal to those
the generator made before it had a repeat model.  A configuration with
tandem repeats gets loci that hold their motif, no plant near them, and
reads whose CIGARs place every base of the haplotype they come from."""

import filecmp
import hashlib
import json
import os
import struct
import sys

import numpy as np
import pytest

from perfbench import gen, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_helpers as th  # noqa: E402

HIFI = {"coverage": 30, "read_len": 15000, "sub_err": 0.003, "qual": 35}

# sha256 (first 16 hex digits) of the FASTA, .fai, BAM, BAI and planted
# variants, and the read bases, of 300 kb contigs of both configurations
# (their reads and genome models) at the seeds of run.contig_seeds(
# 2147483659, 2), as the generator made them before its repeat model
BEFORE_REPEATS = {
    ("hifi_hg002_30x", 137438954176): (
        "eb25394a72cc4281", "7316816bc361a7e6", "1892b239dff368c2",
        "5528e5f89e623114", "bf3afc4cb9f30b47", 8880000),
    ("hifi_hg002_30x", 137438954178): (
        "9d6c20b9f6afa507", "7316816bc361a7e6", "77d27551f3a26d26",
        "e48f6eaf798a1e2e", "095284810f88c21e", 8880000),
    ("ont_r10_hg002_30x", 137438954176): (
        "eb25394a72cc4281", "7316816bc361a7e6", "6a432dcf5cae4ca0",
        "91934fd820e73405", "bf3afc4cb9f30b47", 8887831),
    ("ont_r10_hg002_30x", 137438954178): (
        "9d6c20b9f6afa507", "7316816bc361a7e6", "0ba6518c262571d2",
        "4570b016beeb7ab9", "095284810f88c21e", 8888161),
}

# a repeat model for the tests alone (no configuration of BENCHMARK.json
# has one): short tandem repeats and VNTRs, half of them polymorphic
TR_TEST = {
    "loci_per_mb": 200,
    "classes": [
        {"share": 0.6, "motif": [1, 6], "ref_len": [20, 300],
         "change_bp": [1, 200]},
        {"share": 0.4, "motif": [7, 100], "ref_len": [100, 3000],
         "change_bp": [7, 3000]}],
    "impure_copy_share": 0.1, "polymorphic": 0.5, "gain_share": 0.5,
    "zygosity": {"hom": 0.3, "het": 0.5, "compound": 0.2}}
TR_MODEL = dict(HIFI, sub_err=0.0, margin=2000)
TR_LEN = 1_000_000


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def _truth_sha(truth) -> str:
    rows = [[int(p), k, int(pl) if isinstance(pl, (int, np.integer))
             else np.asarray(pl).tolist(), gt] for p, k, pl, gt in truth]
    return _sha(json.dumps(rows).encode())


@pytest.mark.parametrize("config,seed", sorted(BEFORE_REPEATS))
def test_accepted_configs_make_the_same_bytes(tmp_path, config, seed):
    with open(os.path.join(ROOT, "perfbench", "configs",
                           config + ".json")) as fh:
        cfg = json.load(fh)
    c = gen.make_contig((str(tmp_path), "x", "chr1", seed, cfg["reads"],
                         cfg["genome"], 300_000, 1))
    got = tuple(_sha(open(f, "rb").read()) for f in (
        c["fasta"], c["fasta"] + ".fai", c["bam"], c["bam"] + ".bai")) + (
        _truth_sha(c["truth"]), c["read_bases"])
    assert got == BEFORE_REPEATS[(config, seed)]
    assert seed in run.contig_seeds(2147483659, 2)


def _tr_contig(seed=20261018):
    return gen.genome_truth(seed, TR_LEN, TR_MODEL,
                            {"tandem_repeats": TR_TEST})


def _loci(truth):
    return [t[2] for t in truth if t[1] == "tr"]


def test_repeat_loci_hold_their_motif_at_the_drawn_purity():
    ref4, truth = _tr_contig()
    loci = _loci(truth)
    assert len(loci) > 100
    n_copies = n_impure = 0
    kinds = set()
    for lc in loci:
        m = len(lc.motif)
        span = ref4[lc.beg:lc.end]
        assert len(span) % m == 0 and len(span) >= 2 * m
        copies = span.reshape(-1, m)
        diff = (copies != lc.motif[None, :]).sum(axis=1)
        # every impure copy carries one substitution, every other none
        assert sorted(np.flatnonzero(diff)) == list(lc.impure)
        assert (diff[list(lc.impure)] == 1).all()
        n_copies += len(copies)
        n_impure += len(lc.impure)
        al = [lc.allele(ref4, h) for h in (1, 2)]
        for a in al:
            assert len(a) < TR_MODEL["read_len"] - 2000
        e1, e2 = lc.edits
        if e1 is None and e2 is None:
            kinds.add("none")
        elif e1 is None or e2 is None:
            kinds.add("het")
        elif np.array_equal(*al):
            kinds.add("hom")
        else:
            assert len(al[0]) != len(al[1])
            kinds.add("compound")
        for e in (e1, e2):
            if e is not None:
                gain, lost = e
                # whole copies gained or lost at the left end
                assert (len(gain) > 0) != (lost > 0)
                assert len(gain) % m == 0 and lost % m == 0
                assert lost < lc.end - lc.beg
    assert kinds == {"none", "het", "hom", "compound"}
    assert abs(n_impure / n_copies - TR_TEST["impure_copy_share"]) < 0.02
    assert min(m for m in (len(lc.motif) for lc in loci)) <= 6 < max(
        len(lc.motif) for lc in loci)


def test_no_plant_lies_near_a_locus_and_the_main_stream_is_kept():
    ref4, truth = _tr_contig()
    ref4_0, truth_0 = gen.contig_truth(20261018, TR_LEN, 2000)
    loci = _loci(truth)

    def far(t):
        p, kind, pl, _ = t
        q = p + 1 + (int(pl) if kind == "del" else 0)
        return all(lc.beg - q >= 150 or p - lc.end >= 150 for lc in loci)

    for a, b in zip(loci, loci[1:]):
        assert b.beg - a.end >= 150
    # the plants are those drawn without repeats, less those near a locus
    plants = [t for t in truth if t[1] != "tr"]
    assert all(far(t) for t in plants)
    kept = [t for t in truth_0 if far(t)]
    assert len(kept) < len(truth_0)
    assert _truth_sha(plants) == _truth_sha(kept)
    # the reference differs only inside the loci
    inside = np.zeros(TR_LEN, bool)
    for lc in loci:
        inside[lc.beg:lc.end] = True
    assert np.array_equal(ref4[~inside], ref4_0[~inside])
    assert not np.array_equal(ref4[inside], ref4_0[inside])
    # one seed, one contig; another seed, another
    ref4_b, _ = _tr_contig()
    ref4_c, _ = _tr_contig(20261019)
    assert np.array_equal(ref4, ref4_b)
    assert not np.array_equal(ref4, ref4_c)


def _decode(rec: bytes):
    """(position, CIGAR [(op, len)], nt4 bases, name) of a record."""
    (_, pos, l_name, _, _, n_cig, _, l_seq, _, _, _) = struct.unpack_from(
        "<iiBBHHHiiii", rec, 0)
    off = 32
    name = rec[off:off + l_name - 1].decode()
    off += l_name
    cig = [(v & 0xF, v >> 4) for v in struct.unpack_from(
        f"<{n_cig}I", rec, off)]
    off += 4 * n_cig
    packed = np.frombuffer(rec, np.uint8, (l_seq + 1) // 2, off)
    codes = np.stack([packed >> 4, packed & 0xF], axis=1).ravel()[:l_seq]
    nt4 = np.full(16, 4, np.uint8)
    nt4[[1, 2, 4, 8]] = [0, 1, 2, 3]
    return pos, cig, nt4[codes], name


def test_repeat_reads_place_every_base_of_their_haplotype():
    ref4, truth = _tr_contig()
    beg, end = 2000, TR_LEN - 2000
    recs, n_bases = gen.synth_reads(ref4, truth, beg, end, 30,
                                    TR_MODEL["read_len"], 0.0, 7)
    haps = [gen.HapMap(ref4, beg, end, truth, h) for h in (1, 2)]
    snv = [{p for p, k, pl, gt in truth if k == "snv" and
            (gt == "hom" or (gt == "het1") == (h == 1))} for h in (1, 2)]
    spanned = 0
    for rec in recs:
        pos, cig, seq, name = _decode(rec)
        hm = haps[int(name[1]) - 1]
        # the CIGAR consumes the sequence
        assert sum(ln for op, ln in cig if op in (0, 1, 4)) == len(seq)
        # the read is its haplotype's bases from where the CIGAR puts it
        x = pos - beg
        k = int(np.searchsorted(hm.cum_ref, x, side="right")) - 1
        assert hm.ops[k] == gen.CMATCH
        clip = cig[0][1] if cig[0][0] == gen.CSOFT else 0
        h0 = int(hm.cum_hap[k]) + x - int(hm.cum_ref[k]) - clip
        assert np.array_equal(seq, hm.seq[h0:h0 + len(seq)])
        # and every M base matches the reference but at the SNVs of its
        # haplotype: no base sits on the wrong reference position
        r, q = pos, 0
        for op, ln in cig:
            if op == gen.CMATCH:
                bad = np.flatnonzero(seq[q:q + ln] != ref4[r:r + ln]) + r
                assert set(bad.tolist()) <= snv[int(name[1]) - 1]
                r, q = r + ln, q + ln
            elif op == gen.CDEL:
                r += ln
            else:
                q += ln
        spanned += any(op == gen.CINS and ln >= 50 for op, ln in cig)
    assert n_bases == sum(len(_decode(r)[2]) for r in recs)
    assert spanned > 50


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
