"""The port's multi-device phasing path (longcalld_torch/ops/phase_kernel.py
sharded_phase_fixpoint, longcalld_torch/parallel/mesh.py, run_call with
``mesh_devices > 1``, longcalld_torch/entry.py) against the JAX package's
forms on the 8-device virtual CPU mesh that tests/conftest.py sets up.

Tolerance: exact equality of every output (all are integers; every count
stays below 2^24, so the shards' partial sums add exactly), and byte-equal
VCF bodies.  A CPU mesh is n entries of ``cpu``: the blocks run one after
another on the host, through the same code that puts them on n cards.
Port runs take the port's own CallOpts and report into its own counters.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from longcalld_tpu.config import CallOpts  # noqa: E402
from longcalld_tpu.core import pipeline as jpl  # noqa: E402
from longcalld_tpu.ops import phase_kernel as jpk  # noqa: E402
from longcalld_tpu.parallel import mesh as jmesh  # noqa: E402
from longcalld_torch.core import pipeline as tpl  # noqa: E402
from longcalld_torch.core import procpool  # noqa: E402
from longcalld_torch.ops import phase_kernel as tpk  # noqa: E402
from longcalld_torch.ops.convert import from_numpy  # noqa: E402
from longcalld_torch.parallel import mesh as tmesh  # noqa: E402
from longcalld_torch.utils import counters  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import (build_contig, phase_window,  # noqa: E402
                           pool_calls, port_opts, vcf_body)

CPU = torch.device("cpu")
FIELDS = ("cons", "haps", "ps_start", "agree", "conflict", "profile")

# (seed, keyword arguments of phase_window): R = 96 reads, divisible by 8;
# the reads are not sorted by start, so read spans cross block boundaries
WINDOWS = {
    "hp_off": (0, {}), "hp_on": (1, dict(hp_on=True)),
    "hp_off_2": (2, {}), "hp_on_3": (3, dict(hp_on=True)),
    "noisy": (10, dict(noise=0.2)), "no_valid_var": (7, dict(no_valid=True)),
}


def _window(name):
    seed, kw = WINDOWS[name]
    return phase_window(seed, **kw)


def _assert_equal(got, want, n_iter):
    for name in FIELDS:
        g = getattr(got, name)
        w = np.asarray(getattr(want, name))
        assert g.dtype == from_numpy(w, CPU).dtype, name
        np.testing.assert_array_equal(g.cpu().numpy(), w, err_msg=name)
    assert got.n_iter == n_iter


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX one-device EM and its 8-device reads-sharded form, which
    must agree with each other, per window."""
    refs = {}
    for name in WINDOWS:
        args = [jnp.asarray(a) for a in _window(name)]
        one = jpk.phase_fixpoint_kernel(*args)
        sh = jpk.sharded_phase_fixpoint(8)(*args)
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(sh, f)),
                                          np.asarray(getattr(one, f)), f)
        assert int(sh.n_iter) == int(one.n_iter)
        refs[name] = one
    return refs


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_em_matches_jax(jax_refs, n, window):
    ref = jax_refs[window]
    before = tpk.sharded_calls()
    out = tpk.sharded_phase_fixpoint(tmesh.make_mesh(n, "cpu"))(
        *from_numpy(_window(window), CPU))
    _assert_equal(out, ref, int(ref.n_iter))
    assert tpk.sharded_calls() == before + 1
    if window == "noisy":
        assert out.n_iter >= 2


def test_one_device_em_is_the_one_shard_case(jax_refs):
    """phase_fixpoint and a one-entry mesh give the same outputs."""
    args = from_numpy(_window("noisy"), CPU)
    one = tpk.phase_fixpoint(*args)
    mesh1 = tpk.sharded_phase_fixpoint([CPU])(*args)
    _assert_equal(one, jax_refs["noisy"], int(jax_refs["noisy"].n_iter))
    _assert_equal(mesh1, jax_refs["noisy"], int(jax_refs["noisy"].n_iter))


def test_indivisible_reads_raise():
    args = from_numpy(_window("hp_off"), CPU)       # R = 96
    with pytest.raises(ValueError, match="shard evenly"):
        tpk.sharded_phase_fixpoint(tmesh.make_mesh(5, "cpu"))(*args)


def test_window_batch_matches_jax():
    """tests/test_multichip.py:36-49 on the port: the per-window EM over a
    window axis and its block-sharded form, against the JAX pair."""
    batch = tmesh.make_example_window_batch(16, 24, 48, seed=3)
    jbatch = jmesh.make_example_window_batch(n_windows=16, n_reads=24,
                                             n_vars=48, seed=3)
    for a, b in zip(batch, jbatch):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    jref = jmesh.window_phase_batch(jbatch, max_iter=4)
    jout, jtotal = jmesh.sharded_window_phase(jmesh.make_mesh(8), jbatch,
                                              max_iter=4)
    tb = from_numpy(batch, CPU)
    ref = tmesh.window_phase_batch(tb, max_iter=4)
    out, total = tmesh.sharded_window_phase(tmesh.make_mesh(8, "cpu"), tb,
                                            max_iter=4)
    for got in (ref, out):
        for name in got._fields:
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(jref, name)),
                err_msg=name)
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(jout, name)),
                err_msg=name)
    assert ref.n_iter.dtype == torch.int32
    assert total == int(jtotal) == int((ref.haps > 0).sum())


def test_make_mesh(monkeypatch):
    assert tmesh.make_mesh(3, "cpu") == [CPU] * 3
    assert tmesh.make_mesh(2, devices=["cpu", "cpu"]) == [CPU, CPU]
    with pytest.raises(ValueError, match="2 devices given"):
        tmesh.make_mesh(3, devices=["cpu", "cpu"])
    # fewer cards than asked: raise, never a smaller mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="only 1 CUDA devices"):
        tmesh.make_mesh(4, "cuda:0")


@pytest.fixture(scope="module")
def contig(tmp_path_factory):
    """tests/test_torch_pipeline.py's 200 kb workload (seed 5, 20x)."""
    return build_contig(tmp_path_factory.mktemp("torch_mesh"), 5,
                        200_000)[:2]


def _opt(fa, bam, **kw):
    return CallOpts.hifi(ref_fa_fn=fa, in_bam_fns=[bam], n_threads=2, **kw)


def _call(run_call, opt, **kw):
    if run_call is tpl.run_call:
        opt = port_opts(opt)
    buf = io.StringIO()
    run_call(opt, buf, "t", **kw)
    return vcf_body(buf.getvalue())


@pytest.fixture(scope="module")
def jax_host(contig):
    body = _call(jpl.run_call, _opt(*contig, host_procs=0,
                                    window_size=100_000, use_device=False))
    assert len(body) > 50
    return body


def test_run_call_mesh8_matches_jax(contig, jax_host):
    """run_call with mesh_devices=8 on CPU: byte-equal to the JAX package's
    mesh run and to host only, through the sharded EM."""
    jax_mesh = _call(jpl.run_call, _opt(*contig, host_procs=0,
                                        window_size=100_000, use_device=True,
                                        mesh_devices=8))
    assert jax_mesh == jax_host
    tpk.reset_cuda_calls()
    body = _call(tpl.run_call, _opt(*contig, host_procs=0,
                                    window_size=100_000, use_device=True,
                                    mesh_devices=8, device_min_cells=1),
                 device="cpu")
    assert body == jax_host
    assert tpk.sharded_calls() > 0


def test_run_phase_kernel_pads_reads_to_mesh(tmp_path, monkeypatch):
    """mesh_devices=3: the 128-read bucket pads to 129 (padding reads have
    starts -1 and haps 0), and the records equal the JAX package's mesh
    and host-only runs."""
    fa, bam, n_reads, _ = build_contig(tmp_path, 8, 60_000, coverage=10,
                                       read_len=5_000)
    assert n_reads <= 128
    sizes = []
    real = tpk.shard_reads

    def spy(devices, alleles, *a):
        sizes.append((len(devices), alleles.shape[0]))
        return real(devices, alleles, *a)
    monkeypatch.setattr(tpk, "shard_reads", spy)
    host = _call(jpl.run_call, _opt(fa, bam, host_procs=0,
                                    use_device=False))
    assert len(host) > 10
    assert _call(jpl.run_call, _opt(fa, bam, host_procs=0, use_device=True,
                                    mesh_devices=3)) == host
    assert _call(tpl.run_call, _opt(fa, bam, host_procs=0, use_device=True,
                                    mesh_devices=3), device="cpu") == host
    assert sizes and set(sizes) == {(3, 129)}


def test_run_call_explicit_mesh(contig, jax_host):
    """An explicit device list is the mesh; its length must be
    mesh_devices, and a mesh needs mesh_devices > 1."""
    opt = _opt(*contig, host_procs=0, window_size=100_000, use_device=True,
               mesh_devices=2)
    assert _call(tpl.run_call, opt, device="cpu",
                 mesh=["cpu", "cpu"]) == jax_host
    with pytest.raises(ValueError, match="3 devices given"):
        _call(tpl.run_call, opt, device="cpu", mesh=["cpu"] * 3)
    with pytest.raises(ValueError, match="mesh is given"):
        _call(tpl.run_call, _opt(*contig, host_procs=0, use_device=True),
              device="cpu", mesh=["cpu", "cpu"])


def test_procs_use_device_cuda_mesh_raises(contig, monkeypatch):
    """A device worker owns one card: with mesh_devices > 1 on CUDA the
    parent raises before it builds a kernel or starts a worker."""
    from longcalld_torch.utils import kbuild

    def boom(*a, **k):
        raise AssertionError("reached the kernel build or the pool")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(kbuild, "load", boom)
    monkeypatch.setattr(procpool, "imap_ranges", boom)
    with pool_calls(tpl) as calls, pytest.raises(ValueError,
                                                 match="owns one card"):
        _call(tpl.run_call, _opt(*contig, host_procs=2, window_size=50_000,
                                 procs_use_device=True, mesh_devices=2))
    assert calls == [(4, 2)]


def test_device_workers_on_cpu_mesh_match_jax(contig, jax_host):
    """With a CPU device the pool keeps the JAX package's behaviour: every
    device worker shards each window's EM over its own CPU mesh, and the
    counter delta shows the sharded EM ran in the workers."""
    counters.reset()
    try:
        with pool_calls(tpl) as calls:
            body = _call(tpl.run_call, _opt(
                *contig, host_procs=2, window_size=50_000,
                procs_use_device=True, mesh_devices=2), device="cpu")
    finally:
        procpool.shutdown()
    assert calls == [(4, 2)]
    assert body == _call(jpl.run_call, _opt(*contig, host_procs=0,
                                            window_size=50_000,
                                            use_device=False))
    assert counters.snapshot().get("aln_phase_sharded_calls", 0) > 0


def test_entry_matches_jax_entry():
    """entry() is the port's EM on the JAX entry's example window."""
    import __graft_entry__

    from longcalld_torch import entry
    fn, args = entry.entry()
    jfn, jargs = __graft_entry__.entry()
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for got, want in zip(fn(*args), jax.jit(jfn)(*jargs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dryrun_multichip_clean():
    """tests/test_multichip.py:52-54 on the port."""
    from longcalld_torch import entry
    before = tpk.sharded_calls()
    entry.dryrun_multichip(8, device="cpu")
    assert tpk.sharded_calls() > before
