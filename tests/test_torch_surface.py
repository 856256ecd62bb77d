"""The rest of the port's `call` surface against the JAX package: the ONT
preset, somatic + TE annotation (-s -T), phased alignment output (-b,
--refine-aln -b, -C, -S), checkpoint/resume in-process, on the pool and
across the two, and --shard auto.

Tolerance: byte-equal VCF bodies, and byte-equal BAM/CRAM/SAM files.
Workloads are seeded synthetic contigs (tests/synthcontig.py) of 100 kb at
20x with 25 kb windows (four windows: the pool engages with 2 explicit
workers).  Port runs with ``use_device`` run on ``device="cpu"`` (the
kernels' plain PyTorch versions and the phasing EM on CPU tensors).
Port runs take the port's own CallOpts and its own Checkpoint.
"""

import dataclasses
import io
import os
import sys

import numpy as np
import pytest

from longcalld_torch.core import pipeline as tpl
from longcalld_torch.utils.checkpoint import Checkpoint
from longcalld_tpu.config import CallOpts
from longcalld_tpu.core import pipeline as jpl

sys.path.insert(0, os.path.dirname(__file__))
from synthcontig import (build_truth, write_synth_bam,  # noqa: E402
                         write_synth_fasta)
from torch_helpers import (build_contig, pool_calls, port_opts,  # noqa: E402
                           vcf_body)

L = 100_000


def _run(run_call, opt, **kw):
    if run_call is tpl.run_call:
        opt = port_opts(opt)
    buf = io.StringIO()
    n = run_call(opt, buf, "t", **kw)
    return n, vcf_body(buf.getvalue())


def _build(d, seed, **bam_kw):
    return build_contig(d, seed, L, **bam_kw)[:2]


@pytest.fixture(scope="module")
def contig(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("torch_surface"), 21)


def _opt(contig, ckpt=None, **kw):
    fa, bam = contig
    kw.setdefault("use_device", False)
    kw.setdefault("host_procs", 0)
    kw.setdefault("n_threads", 2)
    return CallOpts.hifi(ref_fa_fn=fa, in_bam_fns=[bam], window_size=25_000,
                         checkpoint_dir=ckpt, **kw)


def _pool_opt(contig, ckpt=None, **kw):
    """Four windows, two explicit workers: run_call takes the pool."""
    return _opt(contig, ckpt, host_procs=2, **kw)


@pytest.fixture(scope="module")
def fresh(contig):
    n, body = _run(jpl.run_call, _opt(contig))
    assert len(body) > 50
    return n, body


# ---------------------------------------------------------------- presets


def test_ont_preset_matches_jax(tmp_path):
    """CallOpts.ont on reads with ONT-style homopolymer indel errors; the
    port runs its phasing EM (with the homopolymer 67% rule) on CPU
    tensors and routes every alignment pair through the band kernels'
    plain versions."""
    fa, bam = _build(tmp_path, 31, indel_err=0.01)
    base = dict(ref_fa_fn=fa, in_bam_fns=[bam], window_size=50_000,
                host_procs=0, n_threads=2)
    n0, ref = _run(jpl.run_call, CallOpts.ont(use_device=False, **base))
    from longcalld_torch.ops import wfa
    wfa._ALIGNER_CACHE.clear()
    n1, got = _run(tpl.run_call, CallOpts.ont(use_device=True,
                                              device_min_cells=1,
                                              **base), device="cpu")
    assert (n1, got) == (n0, ref)
    assert len(ref) > 50
    assert wfa.aligner_totals()["cells_device"] > 0


def test_somatic_te_matches_jax(tmp_path):
    """-s -T: a seeded TE FASTA and a planted het INS cut from its first
    sequence (target-site duplication + TE + polyA tail); the record
    carries MEI and the TE's REPNAME in both packages."""
    rng = np.random.default_rng(41)
    te = [rng.integers(0, 4, 320).astype(np.uint8) for _ in range(3)]
    te_fa = str(tmp_path / "te.fa")
    write_synth_fasta(te_fa, ["TE_A", "TE_B", "TE_C"], te)
    ref4 = rng.integers(0, 4, L).astype(np.uint8)
    ins_at = 51_234
    truth = [t for t in build_truth(rng, ref4, 2000, L - 2000, sv_per_mb=10)
             if abs(t[0] - ins_at) > 400]
    ins = np.concatenate([ref4[ins_at + 1:ins_at + 13], te[0][10:290],
                          np.zeros(20, np.uint8)])
    truth.append((ins_at, "ins", ins, "het1"))
    truth.sort(key=lambda t: t[0])
    fa, bam = str(tmp_path / "s.fa"), str(tmp_path / "s.bam")
    write_synth_fasta(fa, "chr1", ref4)
    write_synth_bam(bam, "chr1", L, ref4, truth, 2000, L - 2000,
                    coverage=20, read_len=10_000, err=0.003, seed=42)
    base = dict(ref_fa_fn=fa, in_bam_fns=[bam], window_size=50_000,
                host_procs=0, n_threads=2, out_somatic=True,
                te_seq_fn=te_fa)
    n0, ref = _run(jpl.run_call, CallOpts.hifi(use_device=False, **base))
    n1, got = _run(tpl.run_call, CallOpts.hifi(use_device=True, **base),
                   device="cpu")
    assert (n1, got) == (n0, ref)
    assert any("MEI" in ln and "REPNAME=+TE_A" in ln for ln in ref)


# ------------------------------------------------------ phased alignments


@pytest.mark.parametrize("kind", ["bam", "refine_bam", "cram", "sam"])
def test_phased_alignment_output_matches_jax(contig, fresh, kind, tmp_path):
    """-b, --refine-aln -b, -C and -S: the written file is byte-equal to
    the JAX package's (-b pins the in-process path in both)."""
    ext = {"cram": "cram", "sam": "sam"}.get(kind, "bam")
    kw = dict(refine_bam=kind == "refine_bam", out_is_cram=kind == "cram",
              out_is_sam=kind == "sam")
    paths = {}
    for name, run_call in (("jax", jpl.run_call), ("torch", tpl.run_call)):
        paths[name] = str(tmp_path / f"{name}.{ext}")
        opt = _opt(contig, out_bam_fn=paths[name], host_procs=2, **kw)
        assert _run(run_call, opt) == fresh
    with open(paths["jax"], "rb") as f0, open(paths["torch"], "rb") as f1:
        ref = f0.read()
        assert f1.read() == ref
    assert len(ref) > 1000


# --------------------------------------------------------------- resume


def test_checkpointed_run_matches_fresh(contig, fresh, tmp_path, monkeypatch):
    ck = str(tmp_path / "ck")
    assert _run(tpl.run_call, _opt(contig, ck)) == fresh
    files = os.listdir(ck)
    assert "meta.json" in files
    assert sum(f.startswith("win_") for f in files) == 4

    def boom(*a, **k):
        raise AssertionError("window recomputed on full resume")
    monkeypatch.setattr(tpl, "call_window", boom)
    assert _run(tpl.run_call, _opt(contig, ck)) == fresh


@pytest.mark.parametrize("kill_after", [0, 2])
def test_kill_and_resume_in_process(contig, fresh, tmp_path, monkeypatch,
                                    kill_after):
    ck = str(tmp_path / "ck")
    seen = {"n": 0}
    real = tpl.call_window

    class Boom(RuntimeError):
        pass

    def dying(opt, chunk):
        if seen["n"] >= kill_after:
            raise Boom()
        seen["n"] += 1
        return real(opt, chunk)

    monkeypatch.setattr(tpl, "call_window", dying)
    with pytest.raises(Boom):
        _run(tpl.run_call, _opt(contig, ck))
    monkeypatch.undo()
    assert _run(tpl.run_call, _opt(contig, ck)) == fresh


def _kill_saves(monkeypatch, method, after):
    """Make Checkpoint.<method> raise once ``after`` windows are saved."""
    real = getattr(Checkpoint, method)
    seen = {"n": 0}

    class Stop(RuntimeError):
        pass

    def dying(self, *a, **k):
        if seen["n"] >= after:
            raise Stop()
        seen["n"] += 1
        return real(self, *a, **k)

    monkeypatch.setattr(Checkpoint, method, dying)
    return Stop


@pytest.mark.parametrize("after", [1, 3])
def test_kill_and_resume_on_pool(contig, fresh, tmp_path, monkeypatch,
                                 after):
    ck = str(tmp_path / "ck")
    stop = _kill_saves(monkeypatch, "save_procs_state", after)
    with pool_calls(tpl) as calls, pytest.raises(stop):
        _run(tpl.run_call, _pool_opt(contig, ck))
    monkeypatch.undo()
    with pool_calls(tpl) as resumed:
        assert _run(tpl.run_call, _pool_opt(contig, ck)) == fresh
    assert calls == resumed == [(4, 2)]


@pytest.mark.parametrize("first", ["in_process", "pool"])
def test_resume_across_modes(contig, fresh, tmp_path, monkeypatch, first):
    """A directory written by one mode resumes under the other (the npz
    schema is shared), and the JAX package resumes the port's."""
    ck = str(tmp_path / "ck")
    if first == "in_process":
        stop = _kill_saves(monkeypatch, "save", 2)
        opt0, opt1 = _opt(contig, ck), _pool_opt(contig, ck)
    else:
        stop = _kill_saves(monkeypatch, "save_procs_state", 2)
        opt0, opt1 = _pool_opt(contig, ck), _opt(contig, ck)
    with pytest.raises(stop):
        _run(tpl.run_call, opt0)
    monkeypatch.undo()
    assert _run(tpl.run_call, opt1) == fresh
    assert _run(jpl.run_call, dataclasses.replace(opt1)) == fresh


# ---------------------------------------------------------------- shards


def test_shard_auto_without_env_is_unsharded(contig, fresh, monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert _run(tpl.run_call, _opt(contig, shard="auto")) == fresh


def test_shard_auto_ranks_merge_to_full_run(contig, tmp_path, monkeypatch):
    """RANK/WORLD_SIZE (as torchrun sets them) pick every n-th region
    chunk; merging the two ranks' VCFs gives the JAX unsharded records."""
    from longcalld_torch.cli import merge_vcfs
    regions = ["chr1:1-50000", "chr1:50001-100000"]
    paths = []
    monkeypatch.setenv("WORLD_SIZE", "2")
    for rank in range(2):
        monkeypatch.setenv("RANK", str(rank))
        path = tmp_path / f"s{rank}.vcf"
        with open(path, "w") as f:
            tpl.run_call(port_opts(_opt(contig, shard="auto",
                                        regions=regions)), f, "t")
        assert vcf_body(path.read_text()), f"rank {rank} is empty"
        paths.append(str(path))
    merged = io.StringIO()
    merge_vcfs(paths, merged)
    _, full = _run(jpl.run_call, _opt(contig, regions=regions))
    assert vcf_body(merged.getvalue()) == full
    monkeypatch.setenv("RANK", "2")
    with pytest.raises(ValueError, match="bad shard spec"):
        _run(tpl.run_call, _opt(contig, shard="auto"))
