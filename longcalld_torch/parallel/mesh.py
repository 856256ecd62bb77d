"""The phasing EM over a 1-D device mesh: the port of
longcalld_tpu/parallel/mesh.py.

A mesh is a list of ``torch.device``.  Two shardings use it, as in the JAX
package:

* **Window data-parallelism**: ``sharded_window_phase`` gives each mesh
  device a contiguous block of a window batch (``P("dp")`` on axis 0) and
  sums the phased-read counts over the blocks.
* **Read model-parallelism** within one window:
  ``ops.phase_kernel.sharded_phase_fixpoint`` splits the reads axis of one
  window's EM over the mesh.  ``CallOpts.mesh_devices > 1`` routes
  run_call's phasing through it.

The JAX forms are shard_map programs; here each block's work is issued
from one process to its own device.  A CUDA mesh is the first n visible
cards and never shrinks quietly; a CPU mesh is n entries of ``cpu`` (the
analog of the JAX tests' virtual CPU devices); an explicit device list is
taken as given and may repeat a card.
"""

from __future__ import annotations

import numpy as np
import torch

from longcalld_torch.ops.phase_kernel import PhaseKernelOut, phase_fixpoint
from longcalld_torch.utils.device import resolve_device


def make_mesh(n_devices: int, device=None, devices=None) -> list:
    """The mesh of ``n_devices`` entries (mesh.py:make_mesh): ``devices``
    when given (its length must be ``n_devices``), else n entries of
    ``cpu`` for a CPU ``device``, else the first n visible cards (raising
    when fewer are visible).  Every CUDA entry is resolved, which turns
    TF32 off."""
    if devices is not None:
        if len(devices) != n_devices:
            raise ValueError(f"make_mesh({n_devices}): {len(devices)} "
                             "devices given")
        return [resolve_device(d) for d in devices]
    lead = resolve_device(device)
    if lead.type == "cpu":
        return [lead] * n_devices
    count = torch.cuda.device_count()
    if count < n_devices:
        raise RuntimeError(
            f"make_mesh({n_devices}): only {count} CUDA devices visible; a "
            "silently smaller mesh would fake-validate sharding (pass "
            "devices=[...] to put several shards on one card)")
    return [resolve_device(torch.device("cuda", k))
            for k in range(n_devices)]


def window_phase_batch(batch, max_iter: int = 10) -> PhaseKernelOut:
    """The EM per window over a leading window axis on every input
    (mesh.py:window_phase_batch's vmap): outputs stacked on that axis,
    ``n_iter`` as an int32 tensor (n_windows,)."""
    outs = [phase_fixpoint(*(x[w] for x in batch), max_iter=max_iter)
            for w in range(batch[0].shape[0])]
    lead = batch[0].device
    return PhaseKernelOut(
        *(torch.stack([getattr(o, f) for o in outs])
          for f in PhaseKernelOut._fields[:-1]),
        n_iter=torch.tensor([o.n_iter for o in outs], dtype=torch.int32,
                            device=lead))


def sharded_window_phase(mesh, batch, max_iter: int = 10):
    """Windows in contiguous blocks over the mesh (mesh.py:
    sharded_window_phase): block k of n_windows / len(mesh) windows runs
    on ``mesh[k]``.  Returns (outputs concatenated in block order on
    ``mesh[0]``, total phased reads as an int)."""
    n = len(mesh)
    n_windows = batch[0].shape[0]
    if n_windows % n:
        raise ValueError(f"{n_windows} windows do not shard evenly over a "
                         f"mesh of {n} devices")
    k = n_windows // n
    outs = [window_phase_batch(
        tuple(x[i * k:(i + 1) * k].to(d, non_blocking=True) for x in batch),
        max_iter) for i, d in enumerate(mesh)]
    lead = torch.device(mesh[0])
    out = PhaseKernelOut(*(torch.cat([getattr(o, f).to(lead) for o in outs])
                           for f in PhaseKernelOut._fields))
    total = sum(int((o.haps > 0).sum()) for o in outs)
    return out, total


def make_example_window_batch(n_windows: int, n_reads: int = 64,
                              n_vars: int = 128, seed: int = 0):
    """Synthetic padded window batch (two haplotypes + noise) in the EM's
    input layout, as numpy arrays equal to mesh.py:
    make_example_window_batch's for the same arguments."""
    rng = np.random.default_rng(seed)
    A = np.full((n_windows, n_reads, n_vars), -1, dtype=np.int8)
    cons0 = np.full((n_windows, 2, n_vars), -1, dtype=np.int8)
    haps0 = np.zeros((n_windows, n_reads), dtype=np.int8)
    for wdw in range(n_windows):
        truth = rng.integers(0, 2, n_vars)
        haps = rng.integers(1, 3, n_reads)
        alle = np.where((haps[:, None] == 1), truth[None, :],
                        1 - truth[None, :])
        noise = rng.random((n_reads, n_vars)) < 0.02
        A[wdw] = np.where(noise, 1 - alle, alle)
        cons0[wdw, 0] = truth
        cons0[wdw, 1] = 1 - truth
        haps0[wdw] = haps
    ones_v = np.ones((n_windows, n_vars), dtype=bool)
    zeros_v = np.zeros((n_windows, n_vars), dtype=bool)
    return (A, np.zeros((n_windows, n_reads), dtype=np.int32),
            np.full((n_windows, n_reads), n_vars - 1, dtype=np.int32),
            cons0, haps0, ones_v, np.full((n_windows, n_vars), 2,
                                          dtype=np.int32),
            ones_v.copy(), ones_v.copy(), zeros_v, zeros_v.copy())
