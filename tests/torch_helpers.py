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
