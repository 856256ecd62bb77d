"""The port's window-range process pool (longcalld_torch/core/procpool.py,
procworker.py and pipeline._run_call_procs) against the JAX package.

Tolerance: byte-equal VCF bodies.  Workloads are seeded synthetic contigs
(tests/synthcontig.py, tests/util_bam.py): a 200 kb diploid contig at 20x
with 25 kb windows (8 windows, so 4 explicit workers engage the pool), and
40 kb planted-het scenes over 5 kb windows where every stitch vote crosses
a worker-range boundary.  Device workers run on ``device="cpu"``, i.e.
through the kernels' plain PyTorch versions.  Pools stay at 2-4 workers.
Port runs take the port's own CallOpts and report into its own counters.
"""

import dataclasses
import io
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from longcalld_torch.config import CallOpts as TCallOpts
from longcalld_torch.core import pipeline as tpl
from longcalld_torch.core import procpool
from longcalld_torch.core.windows import Window
from longcalld_torch.utils import counters
from longcalld_tpu.config import CallOpts
from longcalld_tpu.core import pipeline as jpl

sys.path.insert(0, os.path.dirname(__file__))
from synthcontig import write_synth_fasta  # noqa: E402
from torch_helpers import (build_contig, pool_calls, port_opts,  # noqa: E402
                           vcf_body)
from util_bam import make_record, sim_read, write_bam  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 200_000


def _call(run_call, opt, **kw):
    if run_call is tpl.run_call:
        opt = port_opts(opt)
    buf = io.StringIO()
    run_call(opt, buf, "t", **kw)
    return vcf_body(buf.getvalue())


def _opt(fa, bam, **kw):
    kw.setdefault("window_size", 25_000)
    return CallOpts.hifi(ref_fa_fn=fa, in_bam_fns=[bam], **kw)


@pytest.fixture(scope="module")
def contig(tmp_path_factory):
    return build_contig(tmp_path_factory.mktemp("torch_procs"), 5, L)[:2]


@pytest.fixture(scope="module")
def jax_ref(contig):
    """The JAX package in-process and on its own pool: equal bodies."""
    seq = _call(jpl.run_call, _opt(*contig, host_procs=0, n_threads=2,
                                   use_device=False))
    par = _call(jpl.run_call, _opt(*contig, host_procs=4, n_threads=4,
                                   use_device=False))
    assert seq == par
    assert len(seq) > 100
    return seq


def test_host_workers_match_jax(contig, jax_ref, monkeypatch):
    """The CLI default shape: use_device on, host-only workers; the parent
    never resolves a torch device."""
    import longcalld_torch.utils.device as tdev

    def boom(*a, **k):
        raise AssertionError("host-worker run resolved a device")
    monkeypatch.setattr(tdev, "resolve_device", boom)
    counters.reset()
    with pool_calls(tpl) as calls:
        assert _call(tpl.run_call, _opt(*contig, host_procs=4,
                                        n_threads=4)) == jax_ref
    assert calls == [(8, 4)]
    assert counters.snapshot().get("aln_cells_device", 0) == 0


def test_device_workers_match_jax(contig, jax_ref):
    """procs_use_device: every worker runs the device path (CPU tensors,
    so the kernels' plain versions) and the parent attributes device DP
    cells to at least two workers."""
    counters.reset()
    with pool_calls(tpl) as calls:
        body = _call(tpl.run_call, _opt(*contig, host_procs=4, n_threads=4,
                                        procs_use_device=True,
                                        device_min_cells=1), device="cpu")
    assert body == jax_ref
    assert calls == [(8, 4)]
    snap = counters.snapshot()
    assert snap.get("aln_cells_device", 0) > 0
    per_worker = {k: v for k, v in snap.items()
                  if k.startswith("aln_cells_device_w") and v > 0}
    assert len(per_worker) >= 2, per_worker
    # CPU tensors take the plain versions: no kernel launch is counted
    assert snap.get("aln_band_fwd_launches", 0) == 0


def _het_scene(tmp_path, seed, n_reads, somatic):
    """A 60 kb random reference with planted het SNVs every 300-900 bp over
    [10 kb, 50 kb) and 7 kb reads crossing every 5 kb window boundary
    (tests/test_procs.py's scenes on a synthetic reference).  ``somatic``
    adds a mosaic SNV on 1/4 of hap-1 reads and a 40 bp INS on 1/4 of
    hap-2 reads."""
    ref_len, beg, span, read_len = 60_000, 10_000, 40_000, 7_000
    rng = np.random.default_rng(seed)
    ref4 = rng.integers(0, 4, ref_len).astype(np.uint8)
    som_pos, ins_at = beg + 14_800, beg + 21_433
    variants = {}
    pos = beg + 400
    while pos < beg + span - 600:
        if not somatic or min(abs(pos - som_pos), abs(pos - ins_at)) > 120:
            gt = ["het1", "het2"][int(rng.integers(2))]
            alt = (int(ref4[pos]) + 1 + int(rng.integers(3))) % 4
            variants[pos] = ("snv", alt, gt)
        pos += int(rng.integers(300, 900))
    som_alt = (int(ref4[som_pos]) + 1) % 4
    ins_seq = rng.integers(0, 4, 40).tolist()
    recs = []
    for k in range(n_reads):
        hap = 1 + (k % 2)
        start = beg + int(rng.integers(0, span - read_len))
        v = dict(variants)
        if somatic and hap == 1 and k % 8 in (0, 2):
            v[som_pos] = ("snv", som_alt, "hom")
        if somatic and hap == 2 and k % 8 in (1, 3):
            v[ins_at] = ("ins", ins_seq, "hom")
        seq4, cigar = sim_read(rng, ref4, start, read_len, hap, v,
                               err=0.002)
        quals = np.full(len(seq4), 35, dtype=np.uint8)
        recs.append((start, make_record(0, start, f"r{seed}_{k:03d}", cigar,
                                        seq4, quals, mapq=60,
                                        flag=16 if k % 4 >= 2 else 0)))
    recs.sort(key=lambda r: r[0])
    fa, bam = str(tmp_path / "h.fa"), str(tmp_path / "h.bam")
    write_synth_fasta(fa, "chr1", ref4)
    write_bam(bam, ["chr1"], [ref_len], [r[1] for r in recs])
    return dict(ref_fa_fn=fa, in_bam_fns=[bam], use_device=False,
                regions=[f"chr1:{beg + 1}-{beg + span}"], window_size=5_000)


@pytest.mark.parametrize("seed", [3, 11, 27])
def test_cross_range_stitch_fuzz(seed, tmp_path):
    """Single-window ranges: every stitch vote crosses a worker-range
    boundary and must reproduce the JAX package's sequential flip/rename
    chain exactly."""
    base = _het_scene(tmp_path, seed, 60, somatic=False)
    seq = _call(jpl.run_call, CallOpts.hifi(n_threads=1, host_procs=0,
                                            **base))
    with pool_calls(tpl) as calls:
        par = _call(tpl.run_call, CallOpts.hifi(n_threads=4, host_procs=4,
                                                **base))
    assert calls == [(8, 4)]
    assert seq == par
    # the run phased across boundaries (PS blocks span several windows)
    ps = [ln.split("\t")[9].split(":")[-1] for ln in seq
          if "PS" in ln.split("\t")[8]]
    assert ps and len(set(ps)) < len(ps)


def test_somatic_cross_range_equality(tmp_path):
    """-s across worker-range boundaries: a mosaic SNV and a carrier-private
    40 bp INS come out byte-identical to the JAX package's sequential
    path."""
    base = _het_scene(tmp_path, 5, 48, somatic=True)
    base["out_somatic"] = True
    seq = _call(jpl.run_call, CallOpts.hifi(n_threads=1, host_procs=0,
                                            **base))
    with pool_calls(tpl) as calls:
        par = _call(tpl.run_call, CallOpts.hifi(n_threads=3, host_procs=3,
                                                **base))
    assert calls == [(8, 3)]
    assert seq == par
    assert any("SOMATIC" in ln.split("\t")[7] for ln in seq)


@pytest.mark.parametrize("kw,pool", [
    (dict(host_procs=4, n_threads=4, window_size=50_000), False),  # 4 < 2*4
    (dict(host_procs=4, n_threads=4, window_size=25_000), True),   # 8 >= 2*4
    (dict(host_procs=-1, n_threads=4, window_size=25_000), False),  # 8 < 4*4
    (dict(host_procs=-1, n_threads=2, window_size=25_000), True),  # 8 >= 4*2
    (dict(host_procs=-1, n_threads=4, window_size=12_500), True),  # 16
    (dict(host_procs=1, n_threads=4, window_size=12_500), False),
    (dict(host_procs=4, n_threads=4, window_size=25_000,
          out_bam_fn="o.bam"), False),                            # -b
])
def test_pool_rule_matches_jax(contig, kw, pool, monkeypatch, tmp_path):
    """Few-window streams stay in-process, many-window streams take the
    pool, under exactly pipeline.py:682-691,771 of the JAX package.  Both
    packages' window loads are stubbed out, so only the routing runs."""
    taken = {}
    for name, mod in (("jax", jpl), ("torch", tpl)):
        def spy(opt, out, wins, n_workers, *a, _name=name, **k):
            taken[_name] = (len(wins), n_workers)
            return 0
        monkeypatch.setattr(mod, "_run_call_procs", spy)
        monkeypatch.setattr(mod, "load_chunk", lambda *a, **k: None)
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    if "out_bam_fn" in kw:
        kw = dict(kw, out_bam_fn=str(tmp_path / kw["out_bam_fn"]))
    opt = _opt(*contig, use_device=False, **kw)
    _call(jpl.run_call, opt)
    _call(tpl.run_call, opt)
    assert ("torch" in taken) == pool
    assert taken.get("torch") == taken.get("jax")


def test_worker_error_propagates_and_pool_survives(contig, jax_ref):
    good = port_opts(_opt(*contig, host_procs=4, n_threads=4,
                          use_device=False))
    bad = dataclasses.replace(good, in_bam_fns=["/nonexistent/nope.bam"])
    wins = [Window(0, "chr1", 1, 25_000, 0, 0)]
    with pytest.raises(RuntimeError, match="range worker failed"):
        list(procpool.imap_ranges(bad, wins, [(0, 1)], n_workers=2))
    assert _call(tpl.run_call, good) == jax_ref


_SYSTEM_EXIT = r"""
import importlib.abc, importlib.machinery, sys

class ExitOnMarker(importlib.abc.MetaPathFinder):
    # both packages' pipeline modules get a _range_worker that raises
    # SystemExit(1) for a run whose first BAM is named exit.bam
    def find_spec(self, name, path=None, target=None):
        if name not in ("longcalld_torch.core.pipeline",
                        "longcalld_tpu.core.pipeline"):
            return None
        spec = importlib.machinery.PathFinder.find_spec(name, path)
        run = spec.loader.exec_module

        def exec_module(module):
            run(module)
            real = module._range_worker

            def _range_worker(payload):
                if payload[0].in_bam_fns[0].endswith("exit.bam"):
                    raise SystemExit(1)
                return real(payload)
            module._range_worker = _range_worker
        spec.loader.exec_module = exec_module
        return spec

sys.meta_path.insert(0, ExitOnMarker())
"""


def test_worker_system_exit_propagates_and_pool_survives(contig, jax_ref,
                                                         tmp_path,
                                                         monkeypatch):
    """A SystemExit raised by _range_worker (utils/log.py:error_exit, a
    KeyboardInterrupt alike) comes back to the parent as RuntimeError
    with the worker's traceback, in the port's pool as in the JAX
    package's, and the same workers then run a good call to the same
    records.  The workers start with a sitecustomize that makes the
    range worker exit for a marked run."""
    from longcalld_tpu.core import procpool as jprocpool
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SYSTEM_EXIT)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(site), ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    wins = [Window(0, "chr1", 1, 25_000, 0, 0)]
    for pool, run_call, conv in ((procpool, tpl.run_call, port_opts),
                                 (jprocpool, jpl.run_call, lambda o: o)):
        pool.shutdown()            # workers start anew, with the hook
        try:
            good = _opt(*contig, host_procs=4, n_threads=4, use_device=False)
            bad = conv(dataclasses.replace(
                good, in_bam_fns=[str(tmp_path / "exit.bam")]))
            with pytest.raises(RuntimeError,
                               match="range worker failed(.|\n)*SystemExit"):
                list(pool.imap_ranges(bad, wins, [(0, 1)], n_workers=4))
            with pool._LOCK:
                workers = [w for ws in pool._POOLS.values() for w in ws]
            assert len(workers) == 4 and all(w.alive() for w in workers)
            assert _call(run_call, good) == jax_ref
            with pool._LOCK:
                after = [w for ws in pool._POOLS.values() for w in ws]
            assert after == workers    # the same four processes
        finally:
            pool.shutdown()


def test_device_worker_without_card_raises(contig):
    """A worker asked for cuda:0 that sees no card fails the range; it
    never runs host-only.  The parent refuses a CUDA device it lacks
    before any worker starts."""
    opt = port_opts(_opt(*contig, use_device=True))
    wins = [Window(0, "chr1", 1, 25_000, 0, 0)]
    no_card = lambda k, n: {"CUDA_VISIBLE_DEVICES": ""}  # noqa: E731
    with pytest.raises(RuntimeError, match="range worker failed(.|\n)*cuda"):
        list(procpool.imap_ranges(opt, wins, [(0, 1)], n_workers=2,
                                  worker_env_fn=no_card, device="cuda:0"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            _call(tpl.run_call, _opt(*contig, host_procs=4, n_threads=4,
                                     procs_use_device=True),
                  device="cuda:0")


def test_host_and_device_pools_never_share(contig, jax_ref):
    host = _call(tpl.run_call, _opt(*contig, host_procs=2, n_threads=2,
                                    use_device=False))
    dev = _call(tpl.run_call, _opt(*contig, host_procs=2, n_threads=2,
                                   procs_use_device=True), device="cpu")
    assert host == dev == jax_ref
    with procpool._LOCK:
        pools = dict(procpool._POOLS)
    assert ("host", None) in pools
    dev_keys = [k for k in pools if k[:2] == ("dev", "cpu")]
    assert dev_keys
    assert dict(dev_keys[0][2]) == {"CUDA_VISIBLE_DEVICES": ""}
    owners = {}
    for key, ws in pools.items():
        for w in ws:
            assert owners.setdefault(id(w), key) == key


def test_worker_env_fn_expansion(monkeypatch):
    custom = types.SimpleNamespace(
        worker_device_env="CUDA_VISIBLE_DEVICES={k}; POOL_SIZE={n}",
        window_devices=0)
    fn = tpl._worker_env_fn(custom, torch.device("cuda", 0))
    assert fn(3, 4) == {"CUDA_VISIBLE_DEVICES": "3", "POOL_SIZE": "4"}

    default = types.SimpleNamespace(worker_device_env=tpl.TPU_WORKER_ENV,
                                    window_devices=0)
    assert TCallOpts().worker_device_env == tpl.TPU_WORKER_ENV
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    fn = tpl._worker_env_fn(default, torch.device("cuda", 0))
    assert [fn(k, 5)["CUDA_VISIBLE_DEVICES"] for k in range(5)] == \
        ["0", "1", "2", "0", "1"]
    capped = dataclasses.replace(TCallOpts(), window_devices=2)
    fn = tpl._worker_env_fn(capped, torch.device("cuda", 0))
    assert [fn(k, 4)["CUDA_VISIBLE_DEVICES"] for k in range(4)] == \
        ["0", "1", "0", "1"]
    fn = tpl._worker_env_fn(default, torch.device("cpu"))
    assert fn(1, 4) == {"CUDA_VISIBLE_DEVICES": ""}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tpl._worker_env_fn(default, torch.device("cuda", 0))


def test_worker_env_fn_stays_in_parent_mask(monkeypatch):
    """A parent limited to physical cards 3 and 5 gives its device
    workers those cards, never card 0 or 1."""
    default = types.SimpleNamespace(worker_device_env=tpl.TPU_WORKER_ENV,
                                    window_devices=0)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3, 5")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    fn = tpl._worker_env_fn(default, torch.device("cuda", 0))
    assert [fn(k, 5)["CUDA_VISIBLE_DEVICES"] for k in range(5)] == \
        ["3", "5", "3", "5", "3"]
    one = types.SimpleNamespace(worker_device_env=tpl.TPU_WORKER_ENV,
                                window_devices=1)
    fn = tpl._worker_env_fn(one, torch.device("cuda", 0))
    assert [fn(k, 3)["CUDA_VISIBLE_DEVICES"] for k in range(3)] == \
        ["3", "3", "3"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tpl._worker_env_fn(default, torch.device("cuda", 0))


def test_worker_environ():
    env = procpool.worker_environ()
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert env["PYTHONPATH"].split(os.pathsep)[0] == procpool.REPO_ROOT
    env = procpool.worker_environ({"CUDA_VISIBLE_DEVICES": "0",
                                   "PYTHONHASHSEED": None})
    assert env["CUDA_VISIBLE_DEVICES"] == "0"
    assert "PYTHONHASHSEED" not in env


_REFUSE_JAX = r"""
import importlib.abc, os, sys

class RefuseJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "longcalld_tpu"):
            with open(os.environ["NOJAX_LOG"], "a") as f:
                f.write(f"{os.getpid()} {name}\n")
            raise ImportError(name + " is refused in this process")
        return None

sys.meta_path.insert(0, RefuseJax())
"""

_POOL_PARENT = r"""
import io, sys
from longcalld_torch.config import CallOpts
from longcalld_torch.core import pipeline
from torch_helpers import pool_calls
fa, bam = sys.argv[1], sys.argv[2]
bodies = []
with pool_calls(pipeline) as calls:
    for kw, dev in ((dict(), None), (dict(procs_use_device=True), "cpu")):
        opt = CallOpts.hifi(ref_fa_fn=fa, in_bam_fns=[bam], host_procs=2,
                            n_threads=2, window_size=25_000, **kw)
        buf = io.StringIO()
        pipeline.run_call(opt, buf, "t", device=dev)
        bodies.append(buf.getvalue())
assert calls == [(8, 2), (8, 2)] and bodies[0] == bodies[1]
assert not any(m.split(".")[0] in ("jax", "jaxlib", "longcalld_tpu")
               for m in sys.modules)
sys.stdout.write(bodies[0])
"""


def test_no_worker_imports_jax(contig, jax_ref, tmp_path):
    """A parent whose every process refuses jax and the JAX package
    (sitecustomize first on PYTHONPATH, inherited by the workers) runs
    host and device pools to the same records; no process even tried to
    import either."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_REFUSE_JAX)
    log = tmp_path / "jax_attempts.log"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(site), ROOT, os.path.join(ROOT, "tests")]), NOJAX_LOG=str(log))
    proc = subprocess.run([sys.executable, "-c", _POOL_PARENT, *contig],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert not log.exists(), log.read_text()
    assert vcf_body(proc.stdout) == jax_ref
