"""The plain references against the program's own plain versions, which
they were copied from or stand beside: the alignment cost against the
host aligner's optimum, the EM against phase_fixpoint_plain, and the
record scoring against tests/torch_helpers.py:evaluate_f1."""

import os
import sys

import numpy as np
import pytest
import torch

from perfbench import reference

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
