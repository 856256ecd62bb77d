"""Compile-check and multi-device dry-run entry of the port: the
counterpart of __graft_entry__.py (entry :6-25, dryrun_multichip
:28-222)."""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def entry():
    """(fn, example_args): the phasing EM that run_call runs per window
    (ops/phase_kernel.phase_fixpoint) and one window of
    ``make_example_window_batch(1, 64, 128)`` as CPU tensors; fn returns
    (cons, haps, ps_start)."""
    from longcalld_torch.ops.convert import from_numpy
    from longcalld_torch.ops.phase_kernel import phase_fixpoint
    from longcalld_torch.parallel.mesh import make_example_window_batch

    batch = make_example_window_batch(n_windows=1, n_reads=64, n_vars=128)
    example = from_numpy(tuple(x[0] for x in batch), "cpu")

    def fn(alleles, starts, ends, cons0, haps0, scoreable, w_score,
           clean_snp, valid, hp_het, hp_ont):
        out = phase_fixpoint(alleles, starts, ends, cons0, haps0, scoreable,
                             w_score, clean_snp, valid, hp_het, hp_ont)
        return out.cons, out.haps, out.ps_start

    return fn, example


def differing_fields(a, b) -> list:
    """Names of the fields where two PhaseKernelOut differ (tensors on
    any devices, or ints)."""
    import torch
    diff = []
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if not (torch.equal(x.cpu(), y.cpu()) if isinstance(x, torch.Tensor)
                else int(x) == int(y)):
            diff.append(name)
    return diff


def _same(a, b, what: str) -> None:
    bad = differing_fields(a, b)
    if bad:
        raise AssertionError(f"{what}: {bad} differ from the one-device EM")


def dryrun_mesh(n_devices: int, devices=None, device=None) -> list:
    """The dry run's mesh of ``n_devices`` entries: ``devices`` when
    given; n CPU entries for ``device="cpu"``; otherwise the visible cards
    from ``device`` (default cuda:0) on, repeated round-robin to n entries
    where fewer are visible.  Without CUDA it raises
    (utils/device.py:resolve_device): the dry run never moves to the CPU
    unasked."""
    import torch

    from longcalld_torch.parallel.mesh import make_mesh
    from longcalld_torch.utils.device import resolve_device

    if devices is not None:
        return make_mesh(n_devices, devices=devices)
    lead = resolve_device(device)
    if lead.type == "cpu":
        return make_mesh(n_devices, lead)
    count = torch.cuda.device_count()
    cards = [torch.device("cuda", (lead.index + k) % count)
             for k in range(min(n_devices, count))]
    print(f"dry run: {n_devices} mesh entries on {len(cards)} distinct "
          f"card(s) of {count} visible", flush=True)
    return make_mesh(n_devices, devices=[cards[k % len(cards)]
                                         for k in range(n_devices)])


def dryrun_multichip(n_devices: int, devices=None, device=None) -> None:
    """Run both mesh shardings on an ``n_devices`` mesh and hold them
    equal to the one-device EM, then run the real pipeline over the mesh.
    The mesh is ``dryrun_mesh(n_devices, devices, device)``: the given
    devices, n CPU entries for ``device="cpu"``, else the visible cards
    (repeated where fewer than n are visible); without CUDA and without
    ``device="cpu"`` it raises.

    1. window data-parallelism: a window batch in blocks over the mesh,
       with the summed phased-read count;
    2. read model-parallelism: one window's EM with its reads split over
       the mesh, the path ``CallOpts.mesh_devices`` routes run_call
       through;
    3. each read block holds R/n reads on its own mesh device (in place of
       the JAX dry run's XLA cost_analysis, which PyTorch has no
       counterpart of);
    4. run_call on a seeded contig (tests/torch_helpers.py:build_contig):
       (a) with ``mesh_devices = n`` and (b) with windows round-robin over
       ``window_devices = n``, each with VCF bodies byte-equal to host
       only.
    Any difference raises."""
    import io
    import json
    import tempfile

    from longcalld_torch.ops import phase_kernel
    from longcalld_torch.ops.convert import from_numpy
    from longcalld_torch.parallel.mesh import (make_example_window_batch,
                                               sharded_window_phase,
                                               window_phase_batch)

    mesh = dryrun_mesh(n_devices, devices, device)
    lead = mesh[0]

    # 1. windows over the mesh
    n_windows = 2 * n_devices
    batch = from_numpy(make_example_window_batch(
        n_windows=n_windows, n_reads=16, n_vars=32), "cpu")
    out, total = sharded_window_phase(mesh, batch, max_iter=4)
    ref = window_phase_batch(tuple(x.to(lead) for x in batch), max_iter=4)
    if out.haps.shape[0] != n_windows:
        raise AssertionError(f"{out.haps.shape[0]} windows came back")
    if total != int((ref.haps > 0).sum()):
        raise AssertionError("phased-read total differs")
    _same(out, ref, "sharded_window_phase")

    # 2. reads over the mesh (R = 16 * n_devices shards evenly)
    one = make_example_window_batch(n_windows=1, n_reads=16 * n_devices,
                                    n_vars=32, seed=1)
    args = from_numpy(tuple(x[0] for x in one), "cpu")
    sh = phase_kernel.sharded_phase_fixpoint(mesh)(*args)
    ref1 = phase_kernel.phase_fixpoint(*(x.to(lead) for x in args))
    _same(sh, ref1, "sharded_phase_fixpoint")

    # 3. where the read blocks live
    blocks = phase_kernel.shard_reads(mesh, args[0], args[1], args[2],
                                      args[4])
    R = args[0].shape[0]
    for k, blk in enumerate(blocks):
        if any(x.shape[0] != R // n_devices or x.device != mesh[k]
               for x in blk):
            raise AssertionError(f"read block {k} is not R/n reads on "
                                 f"{mesh[k]}")
    print(json.dumps({"reads_sharding": {
        "n_devices": n_devices, "reads": R,
        "reads_per_block": R // n_devices,
        "devices": [str(d) for d in mesh]}}))

    # 4. the real pipeline over the mesh
    if os.path.join(ROOT, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_helpers import build_contig, vcf_body

    from longcalld_torch.config import CallOpts
    from longcalld_torch.core.pipeline import run_call

    with tempfile.TemporaryDirectory() as d:
        fa, bam, _, _ = build_contig(d, 11, 120_000)

        def vcf(mesh_list=None, **kw):
            buf = io.StringIO()
            opt = CallOpts.hifi(ref_fa_fn=fa, in_bam_fns=[bam], host_procs=0,
                                **kw)
            run_call(opt, buf, "dryrun", device=lead, mesh=mesh_list)
            return vcf_body(buf.getvalue())

        before = phase_kernel.sharded_calls()
        mesh_vcf = vcf(mesh, use_device=True, mesh_devices=n_devices)
        if phase_kernel.sharded_calls() == before:
            raise AssertionError("the mesh run never ran the sharded EM")
        if mesh_vcf != vcf(use_device=False):
            raise AssertionError("mesh VCF differs from host only")
        if len(mesh_vcf) <= 10:
            raise AssertionError("the seeded contig produced no calls")
        win_vcf = vcf(use_device=True, window_devices=n_devices,
                      window_size=50_000, n_threads=2)
        if win_vcf != vcf(use_device=False, window_size=50_000):
            raise AssertionError("window round-robin VCF differs from host "
                                 "only")
