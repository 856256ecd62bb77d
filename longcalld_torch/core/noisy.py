"""Noisy-region re-assembly driver.

Re-implements the outer loop of collect_var_main's noisy-region stage
(reference/src/collect_var.c:2947-2977) with a TPU-first twist: every
region's engine (core.consensus.collect_noisy_vars1) is a coroutine that
yields pairwise-alignment requests, and this driver runs all regions of a
window in lockstep rounds, fusing their requests into a handful of large
batched device calls per round.  Variant/profile merges are applied in
deterministic region order once a wave completes, then phasing re-runs —
matching the reference's sequential semantics (regions are disjoint genomic
intervals, so merge order across a wave only needs to be deterministic).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from longcalld_torch import config
from longcalld_torch.config import CallOpts
from longcalld_torch.core.chunk import WindowChunk
from longcalld_torch.core.phase import assign_haplotypes
from longcalld_torch.ops.wfa import get_aligner


def sort_noisy_regs(chunk: WindowChunk) -> List[int]:
    """Order regions by label (contained var size) then length
    (sort_noisy_regs, collect_var.c:2745-2769)."""
    regs = chunk.noisy_regs
    n = len(regs)
    lens = (regs.ends - regs.starts).astype(np.int64)
    labs = regs.labels
    return sorted(range(n), key=lambda i: (int(labs[i]), int(lens[i])))


def fuse_requests(requests):
    """Fuse one round's (pairs, left_align) requests into a single flat
    submit: [(key, (pairs, la))] -> (flat, flags, owners) where owners is
    [(key, offset, count)].  ``la`` is one flag for the whole request or
    a per-pair flag list (the fused star-MSA rounds) — the single wire
    convention shared by this driver and consensus._drive_lockstep."""
    flat: list = []
    flags: list = []
    owners: list = []
    for key, (pairs, req_la) in requests:
        if not pairs:
            continue
        owners.append((key, len(flat), len(pairs)))
        flat.extend(pairs)
        if isinstance(req_la, (list, tuple)):
            flags.extend(req_la)
        else:
            flags.extend([req_la] * len(pairs))
    return flat, flags, owners


def drive_generators(gens: Dict[int, "object"], aligner) -> Dict[int, tuple]:
    """Run region coroutines in lockstep; batch each round's alignment
    requests into one device call per gap convention."""
    results: Dict[int, tuple] = {}
    to_send: Dict[int, object] = {i: None for i in gens}
    live = dict(gens)
    while live:
        requests: Dict[int, tuple] = {}
        for i in list(live):
            try:
                req = live[i].send(to_send.get(i))
                requests[i] = req
            except StopIteration as e:
                results[i] = e.value
                del live[i]
        if not requests:
            break
        to_send = {i: [] for i in requests}
        # one fused submit per round: both gap conventions share device
        # batches (per-pair reversal), minimizing dispatches on the link
        flat, flags, owners = fuse_requests(requests.items())
        if flat:
            res = aligner.collect(aligner.submit(flat, left_align=flags))
            for i, off, cnt in owners:
                to_send[i] = res[off:off + cnt]
    return results


def process_noisy_regions(opt: CallOpts, chunk: WindowChunk) -> None:
    from longcalld_torch.core.consensus import (collect_noisy_vars1,
                                              merge_var_profile)
    aligner = get_aligner(opt, getattr(chunk, "_device", None))
    aligner.memo_clear()  # memo is per-window (pairs repeat across waves)
    order = sort_noisy_regs(chunk)
    done = [False] * len(order)
    while True:
        pending = [r for r in order if not done[r]]
        if not pending:
            break
        gens = {r: collect_noisy_vars1(opt, chunk, r) for r in pending}
        outcomes = drive_generators(gens, aligner)
        new_done = False
        new_var = False
        # apply merges in the deterministic region order
        for r in pending:
            out = outcomes.get(r)
            if out is None:
                done[r] = True
                new_done = True
                continue
            if out[0] == "done":
                done[r] = True
                new_done = True
            elif out[0] == "retry":
                pass  # unresolved; retried after phasing updates
            else:  # ("vars", germline_payload, somatic_payload|None)
                _, germ, som = out
                cand, te_l, cate, prof = germ
                n_new = merge_var_profile(opt, chunk, cand, te_l, cate, prof)
                done[r] = True
                new_done = True
                if n_new > 0:
                    new_var = True
                if som is not None:
                    s_cand, s_te, s_cate, s_prof = som
                    merge_var_profile(opt, chunk, s_cand, s_te, s_cate,
                                      s_prof)
        if new_var:
            assign_haplotypes(opt, chunk, config.CAND_GERMLINE_VAR_CATE)
        if not new_done:
            break
