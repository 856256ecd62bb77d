"""The plain references against the program's own plain versions, which
they were copied from or stand beside: the alignment cost against the
host aligner's optimum, the EM against phase_fixpoint_plain, and the
record scoring against tests/torch_helpers.py:evaluate_f1.  The repeat
loci's scorer reads nothing wrong in any representation of the truth,
and reads each planted fault; the records' scoring keeps its counts."""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

from perfbench import gen, reference, run
from perfbench.tests import truth_vcf as tv
from perfbench.tests.test_bench_gen import TR_LEN, TR_MODEL, TR_TEST

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_helpers as th  # noqa: E402

SCORE = (6, 6, 2, 24, 1)


def _mutate(rng, p):
    t = list(p)
    for _ in range(int(rng.integers(0, 6))):
        k = int(rng.integers(0, len(t) + 1))
        op = int(rng.integers(0, 3))
        if op == 0 and k < len(t):
            t[k] = (t[k] + 1) % 4
        elif op == 1:
            t[k:k] = list(rng.integers(0, 4, int(rng.integers(1, 40))))
        elif op == 2:
            del t[k:k + int(rng.integers(1, 40))]
    return np.array(t, dtype=np.uint8)


@pytest.mark.parametrize("seed", range(4))
def test_align_cost_is_the_host_aligners_optimum(seed):
    from longcalld_torch.ops.affine_align import align_affine2p
    rng = np.random.default_rng(seed)
    for trial in range(60):
        p = rng.integers(0, 4, int(rng.integers(0, 120))).astype(np.uint8)
        t = _mutate(rng, p)
        r = align_affine2p(p, t, *SCORE, left_align=bool(trial % 2))
        cost = reference.cigar_cost(p, t, r.cigar, *SCORE)
        assert cost == r.score
        assert reference.align_cost(p, t, *SCORE) == cost
        assert reference.align_cost(p, t, *SCORE, bound=cost) == cost


def test_cigar_cost_refuses_a_wrong_alignment():
    p = np.array([0, 1, 2, 3], np.uint8)
    t = np.array([0, 1, 3, 3], np.uint8)
    assert reference.cigar_cost(p, t, [[8, 4]], *SCORE) is None
    assert reference.cigar_cost(p, t, [[7, 2], [8, 1], [7, 1]],
                                *SCORE) == 6
    assert reference.cigar_cost(p, t, [[7, 3]], *SCORE) is None
    assert reference.cigar_cost(p, t, [[0, 4]], *SCORE) == 6


def test_narrow_band_misses_a_wide_detour():
    rng = np.random.default_rng(3)
    p = rng.integers(0, 4, 300).astype(np.uint8)
    t = np.concatenate([p[:100], p[160:], rng.integers(0, 4, 60)]
                       ).astype(np.uint8)
    full = reference.align_cost(p, t, *SCORE)
    assert reference.align_cost(p, t, *SCORE, half_band=16) > full


@pytest.mark.parametrize("kw", [dict(seed=1), dict(seed=2, hp_on=True),
                                dict(seed=3, R=200, V=40),
                                dict(seed=4, no_valid=True)])
def test_phase_fixpoint_equals_the_plain_version(kw):
    from longcalld_torch.ops.phase_kernel import (pack_phase_out,
                                                  phase_fixpoint_plain)
    args = th.phase_window(**kw)
    for max_iter in (10, 1):
        want = pack_phase_out(phase_fixpoint_plain(
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in args),
            max_iter=max_iter)).numpy()
        got = reference.phase_fixpoint(*args, max_iter=max_iter)
        assert np.array_equal(got, want)
    one = reference.phase_fixpoint(*args, max_iter=1)
    full = reference.phase_fixpoint(*args, max_iter=10)
    if not kw.get("no_valid"):
        assert not np.array_equal(one, full)


def test_score_records_agrees_with_evaluate_f1(tmp_path):
    from longcalld_torch.config import CallOpts
    from longcalld_torch.core.pipeline import run_call
    import io
    fa, bam, _, _ = th.build_contig(tmp_path, 5, 100_000, coverage=30,
                                    read_len=15000)
    out = io.StringIO()
    run_call(CallOpts.hifi(ref_fa_fn=fa, in_bam_fns=[bam], n_threads=1,
                           host_procs=0, use_device=False), out)
    body = th.vcf_body(out.getvalue())
    ref4, truth = th.contig_truth(5, 100_000)
    f1 = th.evaluate_f1(body, truth, 2000, 98_000, ref4)
    got = reference.score_records(body, truth, 2000, 98_000, ref4)
    assert got["tp"] == sum(v["tp"] for v in f1.values())
    assert got["fp"] == sum(v["fp"] for v in f1.values())
    assert got["fn"] == sum(v["fn"] for v in f1.values())
    assert got["truth"] == got["tp"] + got["fn"]
    # a record turned from het to hom is a zygosity error
    k = next(i for i, ln in enumerate(body) if "\t0|1" in ln
             or "\t1|0" in ln)
    f = body[k].split("\t")
    f[9] = "1/1" + f[9][3:]
    flipped = body[:k] + ["\t".join(f)] + body[k + 1:]
    assert reference.score_records(flipped, truth, 2000, 98_000,
                                   ref4)["zygosity"] == got["zygosity"] + 1


# ---------------- repeat loci by haplotype sequence ----------------

BEG, END = 17_000, TR_LEN - 17_000


@functools.lru_cache(maxsize=1)
def _tr():
    ref4, truth = gen.genome_truth(20261017, TR_LEN, TR_MODEL,
                                   {"tandem_repeats": TR_TEST})
    plants = [t for t in truth if t[1] != "tr"]
    loci = [t[2] for t in truth if t[1] == "tr"]
    return ref4, truth, plants, loci


def _score(body):
    ref4, _, plants, loci = _tr()
    spans = [(lc.beg, lc.end, lc.allele(ref4, 1), lc.allele(ref4, 2))
             for lc in loci]
    return reference.score_tr_loci(body, spans, ref4, BEG, END, plants)


@pytest.mark.parametrize("phased", [True, False])
@pytest.mark.parametrize("rep", ["left", "right", "split", "whole"])
def test_tr_err_reads_0_on_the_truth(rep, phased):
    ref4, truth, plants, _ = _tr()
    body = tv.truth_lines(truth, ref4, rep, phased)
    if rep == "whole":
        assert any("," in ln.split("\t")[4] and ln.split("\t")[9][:3]
                   in ("1|2", "1/2") for ln in body)
    got = _score(body)
    assert got["tr_loci"] > 100 and got["tr_bad"] == 0
    # and the rest, scored without the loci's windows, is all right
    rest = reference.score_records(
        *reference.outside(body, plants, got["windows"]), BEG, END, ref4)
    assert rest["tp"] == rest["truth"] > 500
    assert rest["fp"] == rest["fn"] == rest["zygosity"] == 0


def _fault(kind):
    """The truth's records with one fault at one locus."""
    ref4, truth, _, loci = _tr()
    body = tv.truth_lines(truth, ref4)
    het = [lc for lc in loci if (lc.edits[0] is None) != (lc.edits[1] is None)
           and lc.beg > BEG + 100 and lc.end < END - 100]
    lc = het[len(het) // 2]
    k = body.index(tv.locus_lines(lc, ref4)[0])
    f = body[k].split("\t")
    if kind == "copy_off":
        m, p0 = len(lc.motif), int(f[1]) - 1
        if len(f[4]) > len(f[3]):
            f[4] += f[4][-m:]           # a copy more gained
        else:                           # a copy more lost
            f[3] += tv._s(ref4[p0 + len(f[3]):p0 + len(f[3]) + m])
        return body[:k] + ["\t".join(f)] + body[k + 1:]
    if kind == "allele_dropped":
        return body[:k] + body[k + 1:]
    if kind == "het_as_hom":
        f[8], f[9] = "GT", "1|1"
        return body[:k] + ["\t".join(f)] + body[k + 1:]
    # an SNV inside a locus that keeps the reference on both haplotypes
    mono = [c for c in loci if c.edits == (None, None)
            and c.beg > BEG + 100 and c.end < END - 100]
    c = mono[len(mono) // 2]
    p = (c.beg + c.end) // 2
    a = int(ref4[p])
    snv = "\t".join(["chr1", str(p + 1), ".", "ACGT"[a], "ACGT"[(a + 1) % 4],
                     "60", "PASS", ".", "GT:PS", "0|1:1"])
    return sorted(body + [snv], key=lambda ln: int(ln.split("\t")[1]))


@pytest.mark.parametrize("kind", ["copy_off", "allele_dropped",
                                  "het_as_hom", "fp_snv"])
def test_tr_err_reads_each_fault(kind):
    ref4, truth, plants, _ = _tr()
    body = _fault(kind)
    assert body != tv.truth_lines(truth, ref4)
    got = _score(body)
    assert got["tr_bad"] >= 1, kind
    # the fault is the loci's: the rest reads no error
    rest = reference.score_records(
        *reference.outside(body, plants, got["windows"]), BEG, END, ref4)
    assert rest["fp"] == rest["fn"] == rest["zygosity"] == 0


def test_a_record_reaching_past_a_window_grows_it():
    """A deletion from a locus's flank into a planted SNV beyond it takes
    the SNV into the window: both are judged together, as the truth."""
    ref4, truth, plants, loci = _tr()
    lc = next(c for c in loci if c.edits == (None, None) and any(
        150 <= t[0] - c.end < 300 and t[1] == "snv" and t[3] == "hom"
        for t in plants))
    snv = next(t for t in plants if 150 <= t[0] - lc.end < 300
               and t[1] == "snv" and t[3] == "hom")
    body = tv.truth_lines(truth, ref4)
    got = _score(body)
    assert all(not (w[0] <= snv[0] < w[1]) for w in got["windows"])
    # the caller writes the SNV with reference bases from inside the
    # locus's flank: one record, the same haplotypes
    s = lc.end + 10
    ref = tv._s(ref4[s:snv[0] + 1])
    alt = ref[:-1] + "ACGT"[int(snv[2])]
    line = "\t".join(["chr1", str(s + 1), ".", ref, alt, "60", "PASS", ".",
                      "GT", "1|1"])
    old = next(ln for ln in body if ln.split("\t")[1] == str(snv[0] + 1))
    body = sorted([ln for ln in body if ln != old] + [line],
                  key=lambda ln: int(ln.split("\t")[1]))
    got2 = _score(body)
    assert got2["tr_bad"] == 0
    assert any(w[0] <= snv[0] < w[1] for w in got2["windows"])
    rest = reference.score_records(
        *reference.outside(body, plants, got2["windows"]), BEG, END, ref4)
    assert rest["truth"] == rest["tp"] and rest["fp"] == 0


# counts (score_records) and rec_err (run.judge) of 300 kb contigs of the
# accepted configurations, at the seeds of run.contig_seeds(2147483659,
# 2), on records written from their plants with faults (every 50th left
# out, every 37th heterozygous one written homozygous, an SNV 60 bp past
# every 97th), as the judge read them before it judged repeat loci
BEFORE_REPEATS = {
    ("hifi_hg002_30x", 137438954176): (
        {"truth": 259, "tp": 254, "fp": 2, "fn": 5, "zygosity": 7},
        0.05405405405405406),
    ("hifi_hg002_30x", 137438954178): (
        {"truth": 292, "tp": 287, "fp": 3, "fn": 5, "zygosity": 4},
        0.0410958904109589),
    ("ont_r10_hg002_30x", 137438954176): (
        {"truth": 249, "tp": 244, "fp": 2, "fn": 5, "zygosity": 7},
        0.05622489959839357),
    ("ont_r10_hg002_30x", 137438954178): (
        {"truth": 282, "tp": 277, "fp": 2, "fn": 5, "zygosity": 4},
        0.03900709219858156),
}


@pytest.mark.parametrize("config,seed", sorted(BEFORE_REPEATS))
def test_score_records_keeps_its_counts(tmp_path, config, seed):
    with open(os.path.join(ROOT, "perfbench", "configs",
                           config + ".json")) as fh:
        cfg = json.load(fh)
    ref4, truth = gen.contig_truth(seed, 300_000, 2000, **cfg["genome"])
    body = []
    for k, ln in enumerate(tv.plant_lines(truth, ref4)):
        if k % 50 == 7:
            continue
        f = ln.split("\t")
        if k % 37 == 3 and f[9].startswith(("0|1", "1|0")):
            f[8], f[9] = "GT", "1|1"
        body.append("\t".join(f))
        if k % 97 == 11:
            p = int(f[1]) + 60
            body.append("\t".join([
                "chr1", str(p), ".", "ACGT"[int(ref4[p - 1])],
                "ACGT"[(int(ref4[p - 1]) + 1) % 4], "60", "PASS", ".", "GT",
                "0/1"]))
    edge = 2000 + cfg["reads"]["read_len"]
    counts, rec_err = BEFORE_REPEATS[(config, seed)]
    assert reference.score_records(body, truth, edge, 300_000 - edge,
                                   ref4) == counts
    call = {"contig": {"seed": seed, "length": 300_000},
            "vcf": "\n".join(body) + "\n", "em_launches": 1}
    checks = run.judge(cfg, {"rec_err": 0.004, "aln_bad": 0, "em_bad": 0},
                       [call], str(tmp_path), False, seed)
    assert checks[0] == {"name": "rec_err", "value": rec_err,
                         "limit": 0.004}
    assert "tr_err" not in {c["name"] for c in checks}
