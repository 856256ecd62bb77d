"""Phasing entry point: the port of
longcalld_tpu/core/phase.py:assign_haplotypes (:464-500), composed from
that module's host helpers.  The fixpoint EM runs
through longcalld_torch.ops.phase_kernel where phase.py:490-493 calls the
JAX kernel; everything else is the JAX package's host code unchanged.
"""

from __future__ import annotations

import numpy as np

from longcalld_tpu.config import CallOpts
from longcalld_tpu.core.chunk import WindowChunk
from longcalld_tpu.core.phase import (_iter_update_cons,
                                      _iter_update_phase_set,
                                      _prepare_read_var_order,
                                      _update_read_phase_sets,
                                      init_var_hap_state, seed_sweep)


def assign_haplotypes(opt: CallOpts, chunk: WindowChunk,
                      target_cate: int) -> None:
    """Top-level phasing (assign_hap.c:473-547): the seeded sweep on
    host, then the fixpoint iterations on the chunk's device (with
    ``use_device``) or in the host loop."""
    cand = chunk.cand_vars
    n_vars = len(cand)
    if n_vars == 0:
        return
    valid_mask = (chunk.var_cate & target_cate) != 0
    valid_idx = np.nonzero(valid_mask)[0]
    if len(valid_idx) == 0:
        return

    chunk.haps[:] = 0
    chunk.phase_sets[:] = -1
    init_var_hap_state(opt, chunk, valid_idx)
    _prepare_read_var_order(chunk)
    seed_sweep(opt, chunk, valid_idx, target_cate)

    done = False
    if getattr(opt, "use_device", False) and getattr(
            opt, "use_device_phase", True):
        from longcalld_torch.ops.phase_kernel import run_phase_kernel
        done = run_phase_kernel(opt, chunk, target_cate, valid_idx)
    if not done:
        for _ in range(10):
            changed1 = _iter_update_phase_set(chunk, valid_idx)
            changed2 = _iter_update_cons(opt, chunk, valid_idx, target_cate)
            if not changed1 and not changed2:
                break
    _update_read_phase_sets(chunk, valid_mask)
