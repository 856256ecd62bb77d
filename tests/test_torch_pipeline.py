"""End-to-end parity of the port's `call` (longcalld_torch/core/pipeline.py)
with the JAX package's, on a seeded synthetic diploid contig.

Tolerance: byte-equal VCF bodies.  The workload is a 200 kb random
reference with planted SNVs, small indels and SVs (25/Mb, so noisy regions
produce alignment pairs for the device path), 20x HiFi-like reads, and
100 kb windows so the stitch between windows runs.  The port runs on CPU
tensors with device_min_cells=1, so every eligible pair goes through its
kernel wrappers (their plain versions on CPU); the JAX package runs with
use_device True and False.  A subprocess whose import system refuses jax
must produce the same VCF.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from longcalld_tpu.config import CallOpts
from longcalld_tpu.core.pipeline import run_call as run_call_jax
from longcalld_torch.core.pipeline import run_call as run_call_torch
from longcalld_torch.ops import wfa as twfa

sys.path.insert(0, os.path.dirname(__file__))
from synthcontig import (build_truth, write_synth_bam,  # noqa: E402
                         write_synth_fasta)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 200_000


def _opt(fa, bam, **kw):
    return CallOpts.hifi(ref_fa_fn=fa, in_bam_fns=[bam], host_procs=0,
                         n_threads=2, window_size=100_000, **kw)


def _body(text):
    return [ln for ln in text.splitlines() if not ln.startswith("#")]


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pipeline")
    rng = np.random.default_rng(5)
    ref4 = rng.integers(0, 4, L).astype(np.uint8)
    truth = build_truth(rng, ref4, 2000, L - 2000, sv_per_mb=25)
    fa, bam = str(d / "s.fa"), str(d / "s.bam")
    write_synth_fasta(fa, "chr1", ref4)
    write_synth_bam(bam, "chr1", L, ref4, truth, 2000, L - 2000,
                    coverage=20, read_len=10_000, err=0.003, seed=6)
    return fa, bam


@pytest.fixture(scope="module")
def jax_bodies(workload):
    out = {}
    for use_device in (True, False):
        buf = io.StringIO()
        run_call_jax(_opt(*workload, use_device=use_device), buf, "t")
        out[use_device] = _body(buf.getvalue())
    assert out[True] == out[False]
    assert len(out[False]) > 50
    return out


def test_port_device_path_matches_jax(workload, jax_bodies):
    twfa._ALIGNER_CACHE.clear()
    buf = io.StringIO()
    run_call_torch(_opt(*workload, use_device=True, device_min_cells=1),
                   buf, "t", device="cpu")
    assert _body(buf.getvalue()) == jax_bodies[True]
    tot = twfa.aligner_totals()
    assert tot["cells_device"] > 0 and tot["n_dispatch"] > 0


def test_port_host_only_matches_jax(workload, jax_bodies, monkeypatch):
    """use_device=False runs host-only and never resolves a device."""
    import longcalld_torch.utils.device as tdev

    def boom(*a, **k):
        raise AssertionError("host-only run resolved a device")
    monkeypatch.setattr(tdev, "resolve_device", boom)
    monkeypatch.setattr(twfa, "resolve_device", boom)
    buf = io.StringIO()
    run_call_torch(_opt(*workload, use_device=False), buf, "t")
    assert _body(buf.getvalue()) == jax_bodies[False]


_NO_JAX = r"""
import importlib.abc, io, sys

class RefuseJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is refused in this process")
        return None

sys.meta_path.insert(0, RefuseJax())
from longcalld_tpu.config import CallOpts
from longcalld_torch.core.pipeline import run_call
fa, bam = sys.argv[1], sys.argv[2]
opt = CallOpts.hifi(ref_fa_fn=fa, in_bam_fns=[bam], host_procs=0,
                    n_threads=2, window_size=100_000, device_min_cells=1)
buf = io.StringIO()
run_call(opt, buf, "t", device="cpu")
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
sys.stdout.write(buf.getvalue())
"""


def test_port_runs_without_jax(workload, jax_bodies):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, *workload],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert _body(proc.stdout) == jax_bodies[True]


def test_cli_host_only_matches_jax(workload, jax_bodies, tmp_path):
    """`longcalld-torch call --no-device --profile DIR` equals the JAX
    package's host-only run and writes a torch.profiler trace."""
    from longcalld_torch.cli import main
    out = tmp_path / "o.vcf"
    fa, bam = workload
    assert main(["call", fa, bam, "--no-device", "--host-procs", "0",
                 "-t", "2", "-o", str(out), "--profile",
                 str(tmp_path / "prof")]) == 0
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    ref = io.StringIO()
    run_call_jax(CallOpts.hifi(ref_fa_fn=fa, in_bam_fns=[bam],
                               host_procs=0, n_threads=2,
                               use_device=False), ref, "t")
    assert _body(out.read_text()) == _body(ref.getvalue())


def test_cuda_requested_without_cuda_raises(workload, monkeypatch):
    from longcalld_torch.utils.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        run_call_torch(_opt(*workload, use_device=True), io.StringIO(), "t")


def test_shard_auto_not_ported(workload):
    with pytest.raises(NotImplementedError, match="shard"):
        run_call_torch(_opt(*workload, use_device=False, shard="auto"),
                       io.StringIO(), "t")


def test_shard_partition_merges_to_full_run(workload, tmp_path):
    """--shard i/n takes every n-th region chunk; merging the shard VCFs
    gives the JAX package's unsharded records (host-only, so cheap)."""
    from longcalld_tpu.cli import merge_vcfs
    regions = ["chr1:1-100000", "chr1:100001-200000"]
    paths = []
    for i in range(2):
        path = tmp_path / f"s{i}.vcf"
        with open(path, "w") as f:
            run_call_torch(_opt(*workload, use_device=False, regions=regions,
                                shard=f"{i}/2"), f, "t")
        assert _body(path.read_text()), f"shard {i} is empty"
        paths.append(str(path))
    merged = io.StringIO()
    merge_vcfs(paths, merged)
    full = io.StringIO()
    run_call_jax(_opt(*workload, use_device=False, regions=regions), full,
                 "t")
    assert _body(merged.getvalue()) == _body(full.getvalue())
