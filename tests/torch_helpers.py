"""Helpers shared by the port's tests (tests/test_torch_*.py) and
chip_smoke.py: VCF bodies, a spy on run_call's pool dispatch, the seeded
synthetic contig they call, random traceback bytes for the band walk and
seeded SV-like pairs for the wide band buckets."""

import contextlib
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from synthcontig import (build_truth, write_synth_bam,  # noqa: E402
                         write_synth_fasta)


def vcf_body(text):
    """The record lines of a VCF text."""
    return [ln for ln in text.splitlines() if not ln.startswith("#")]


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


def random_walk_inputs(rng, B, Lp, n, spread=20):
    """Inputs of the band walk (tbs, plen, tlen, dlo, finals) made of
    random traceback bytes and finals.  Extension bits are set often, so
    the walk takes every branch and falls off either band edge, which real
    DP output does only in unreachable (all-BIG) regions.  Pairs 0 and 1
    end outside the band, pair 2 near its middle, pair 4 has tied finals
    (the first minimum wins).  Then two blocks of q = max(2, (n-5) // 3)
    full-length pairs: the first ends at b_final in {0, 1, 2} in an I
    state, so it leaves through the left edge (at b_final = 0 always), the
    second at b_final in {B-1, B-2, B-3} in a D state, so it leaves through
    the right edge (at B-1 always).  Needs n >= 9."""
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
    return tbs, plen, tlen, dlo, finals


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
