"""Helpers shared by the port's tests (tests/test_torch_*.py) and
chip_smoke.py: VCF bodies, a spy on run_call's pool dispatch, and the
seeded synthetic contig they call."""

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
