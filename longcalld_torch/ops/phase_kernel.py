"""Phasing fixpoint EM on the device: the port of
longcalld_tpu/ops/phase_kernel.py (_phase_fixpoint :83-256, run_phase_kernel
:317-418).  It is PyTorch code (the JAX form is an XLA program, not a
Pallas kernel).  Outputs are bit-equal.

* The masked dots run in float32 and are exact because every count stays
  below 2^24 (phase_kernel.py:25-28).  On CUDA that needs full fp32
  matmuls: ``phase_fixpoint`` raises if TF32 is enabled.
* The serial phase-set scan over variants (phase_kernel.py:149-164, up to
  8192 steps) is two prefix operations: a cummax for the segment start and
  a cumsum parity for the flip state, which is never reset at a new
  segment (``scan_phase_sets``; tests hold it equal to the scan).
* The 10-round counted trip with select-masked updates becomes a loop
  that stops once nothing changed, which gives the same outputs and n_iter.
* Not ported: sharded_phase_fixpoint (the reads-axis mesh form).
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from longcalld_torch.ops.convert import from_numpy
from longcalld_torch.utils.device import resolve_device


class PhaseKernelOut(NamedTuple):
    cons: torch.Tensor        # int8 (2, V)
    haps: torch.Tensor        # int8 (R,)
    ps_start: torch.Tensor    # int32 (V,): index of the var starting this
                              # var's phase set; -1 outside the valid set
    agree: torch.Tensor       # int32 (R,)
    conflict: torch.Tensor    # int32 (R,)
    profile: torch.Tensor     # int32 (2, V, 2)
    n_iter: int


_count_lock = threading.Lock()
_cuda_calls = 0


def cuda_calls() -> int:
    """How many times phase_fixpoint ran on a CUDA device."""
    with _count_lock:
        return _cuda_calls


def reset_cuda_calls() -> None:
    global _cuda_calls
    with _count_lock:
        _cuda_calls = 0


def _complement_fill(c1, c2, mask):
    """read_to_cons_allele_score's one-sided fill (assign_hap.c:139-143)."""
    f1 = torch.where(mask & (c1 == -1) & (c2 != -1), 1 - c2, c1)
    f2 = torch.where(mask & (c2 == -1) & (c1 != -1), 1 - c1, c2)
    return f1, f2


def _cons_update(p0, p1, hp_ont):
    """update_var_hap_to_cons_alle core (assign_hap.c:244-268): majority,
    ref preferred on ties, -1 uncovered; ONT homopolymer indels need a 67%
    majority (compared in float32, as the JAX form does)."""
    max_i = torch.where(p1 > p0, 1, torch.where(p0 > 0, 0, -1))
    max_cov = torch.where(max_i == 1, p1, torch.where(max_i == 0, p0, 0))
    weak = hp_ont & (max_cov.to(torch.float32)
                     < (p0 + p1).to(torch.float32) * 0.67)
    return torch.where(weak, -1, max_i).to(torch.int32)


def scan_phase_sets(valid, het, n_agree, n_conflict):
    """Phase-set starts and consensus flips of phase_kernel.py:149-164 in
    prefix form.  The scan's carry (start, flip) only ever takes the last
    segment start (a running max of indices) and the parity of the flips
    so far, so both are prefix operations over the variant axis.  Returns
    (ps_start int32 (V,), flip_here bool (V,))."""
    V = valid.shape[0]
    iota = torch.arange(V, dtype=torch.int32, device=valid.device)
    is_first = torch.zeros_like(valid)
    if bool(valid.any()):
        is_first[int(torch.argmax(valid.to(torch.int32)))] = True
    new_seg = het & (n_agree < 2) & (n_conflict < 2)
    do_flip = het & ~new_seg & (n_conflict > n_agree)
    seg = valid & (is_first | new_seg)
    start = torch.cummax(torch.where(seg, iota, -1), dim=0).values
    flips = torch.cumsum((valid & ~is_first & do_flip).to(torch.int32),
                         dim=0, dtype=torch.int32)
    flip_here = valid & ~is_first & het & ((flips & 1) == 1)
    return torch.where(valid, start, -1).to(torch.int32), flip_here


def phase_fixpoint(alleles, starts, ends, cons0, haps0, scoreable, w_score,
                   clean_snp, valid, hp_het, hp_ont,
                   max_iter: int = 10) -> PhaseKernelOut:
    """Fixpoint phasing iterations (phase_kernel.py:_phase_fixpoint); the
    arguments are its arguments, as tensors on one device."""
    global _cuda_calls
    dev = alleles.device
    if dev.type == "cuda":
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("phase_fixpoint needs full fp32 matmuls: "
                               "torch.backends.cuda.matmul.allow_tf32 is "
                               "True (utils.device.resolve_device turns it "
                               "off)")
        with _count_lock:
            _cuda_calls += 1
    f32, i32 = torch.float32, torch.int32
    R, V = alleles.shape
    A = alleles.to(i32)
    A0 = A == 0
    A1 = A == 1
    Af0 = A0.to(f32)
    Af1 = A1.to(f32)
    A01 = (A0 | A1).to(f32)
    Df = Af0 - Af1
    w = w_score.to(i32)
    iota_v = torch.arange(V, dtype=i32, device=dev)
    read_valid = starts >= 0
    # constant over the iterations
    scored_any = scoreable & ((A0 | A1) & read_valid[:, None]).any(dim=0)
    tgt = valid.to(f32)[None, :]
    Af0t, Af1t = Af0 * tgt, Af1 * tgt

    def ps_flip(c1, c2, haps):
        """iter_update_var_hap_cons_phase_set (assign_hap.c:345-422)."""
        het = valid & (c1 != -1) & (c2 != -1) & (c1 != c2) & ~hp_het
        prev_incl = torch.cummax(torch.where(het, iota_v, -1), dim=0).values
        prev_het = torch.cat([prev_incl.new_full((1,), -1), prev_incl[:-1]])
        h1 = (haps == 1)[:, None]
        own_c = torch.where(h1, c1[None, :], c2[None, :])
        oth_c = torch.where(h1, c2[None, :], c1[None, :])
        own_m = (A == own_c) & (A >= 0)
        oth_m = (A == oth_c) & (A >= 0)
        prev_own = own_m.index_select(1, prev_het.clamp_min(0))
        cover = ((starts[:, None] <= prev_het[None, :])
                 & (ends[:, None] >= iota_v[None, :]))
        act = (haps != 0)[:, None] & cover & (prev_het >= 0)[None, :]
        n_agree = (act & prev_own & own_m).sum(dim=0, dtype=i32)
        n_conflict = (act & prev_own & ~own_m & oth_m).sum(dim=0, dtype=i32)
        ps_start, flip = scan_phase_sets(valid, het, n_agree, n_conflict)
        nc1 = torch.where(flip, c2, c1)
        nc2 = torch.where(flip, c1, c2)
        return nc1, nc2, ps_start, bool(flip.any())

    def reassign(c1, c2):
        """iter_update_var_hap_to_cons_alle (assign_hap.c:425-467)."""
        f1, f2 = _complement_fill(c1, c2, scored_any)
        cons_set = scoreable & (f1 != -1)
        wf = torch.where(cons_set, w, 0).to(f32)
        s1 = Df @ (wf * (1 - 2 * f1).to(f32))
        s2 = Df @ (wf * (1 - 2 * f2).to(f32))
        n_used = A01 @ (cons_set & (w > 0)).to(f32)
        max_s = torch.maximum(s1, s2)
        min_s = torch.minimum(s1, s2)
        max_hap = torch.where(s1 >= s2, 1, 2)
        min_hap = torch.where(s1 <= s2, 1, 2)
        hap = torch.where(max_s > 0, max_hap,
                          torch.where(min_s < 0, 3 - min_hap, 0))
        hap = torch.where(n_used == 0, 0, hap)    # iter path maps -1 -> 0
        hap = torch.where(read_valid, hap, 0).to(i32)
        cs = clean_snp & cons_set

        def cnt(a0v, a1v):
            return Af0 @ a0v.to(f32) + Af1 @ a1v.to(f32)
        ag1 = cnt(cs & (f1 == 0), cs & (f1 == 1))
        cf1 = cnt(cs & (f1 == 1), cs & (f1 == 0))
        ag2 = cnt(cs & (f2 == 0), cs & (f2 == 1))
        cf2 = cnt(cs & (f2 == 1), cs & (f2 == 0))
        pos = (max_s > 0) & read_valid
        ag = torch.where(pos, torch.where(max_hap == 1, ag1, ag2), 0)
        cf = torch.where(pos, torch.where(max_hap == 1, cf1, cf2), 0)
        h1 = (((hap == 1) | (hap == 0)) & read_valid).to(f32)
        h2 = (((hap == 2) | (hap == 0)) & read_valid).to(f32)
        p10 = (h1 @ Af0t).to(i32)
        p11 = (h1 @ Af1t).to(i32)
        p20 = (h2 @ Af0t).to(i32)
        p21 = (h2 @ Af1t).to(i32)
        nc1 = torch.where(valid, _cons_update(p10, p11, hp_ont), f1)
        nc2 = torch.where(valid, _cons_update(p20, p21, hp_ont), f2)
        prof = torch.stack([torch.stack([p10, p11], dim=-1),
                            torch.stack([p20, p21], dim=-1)])
        # changed vs the PRE-fill consensus (phase_kernel.py:216-218)
        changed = bool((((nc1 != c1) | (nc2 != c2)) & valid).any())
        return (nc1, nc2, hap, ag.to(i32), cf.to(i32), prof, changed)

    c1 = cons0[0].to(i32)
    c2 = cons0[1].to(i32)
    haps = haps0.to(i32)
    prof = torch.zeros((2, V, 2), dtype=i32, device=dev)
    agree = torch.zeros(R, dtype=i32, device=dev)
    conflict = torch.zeros(R, dtype=i32, device=dev)
    ps_start = torch.full((V,), -1, dtype=i32, device=dev)
    n_iter = 0
    # phase_kernel.py:222-250 runs max_iter select-masked rounds; once a
    # round changes nothing the later rounds are no-ops, so stop there
    for _ in range(max_iter):
        c1, c2, ps_start, ch1 = ps_flip(c1, c2, haps)
        c1, c2, haps, agree, conflict, prof, ch2 = reassign(c1, c2)
        n_iter += 1
        if not (ch1 or ch2):
            break
    return PhaseKernelOut(
        cons=torch.stack([c1, c2]).to(torch.int8), haps=haps.to(torch.int8),
        ps_start=ps_start, agree=agree, conflict=conflict, profile=prof,
        n_iter=n_iter)


# ---------------- host bridge ----------------

_R_BUCKETS = (128, 512, 2048, 8192)
_V_BUCKETS = (128, 512, 2048, 8192)


def _bucket(n: int, opts) -> int:
    for o in opts:
        if n <= o:
            return o
    return n


def run_phase_kernel(opt, chunk, target_cate: int,
                     valid_idx: np.ndarray) -> bool:
    """phase_kernel.py:run_phase_kernel: build padded inputs from the
    post-sweep chunk, run phase_fixpoint on the chunk's ``_device``
    (default cuda:0), write results back.  Returns False (caller runs the
    host loop) when the window shape is degenerate."""
    from longcalld_tpu.core.phase import _score_masks
    from longcalld_tpu.io.bam import CDIFF

    if int(getattr(opt, "mesh_devices", 0) or 0) > 1:
        raise NotImplementedError(
            "mesh_devices > 1 (reads-axis sharded phasing) is not yet "
            "ported to longcalld_torch")
    cand = chunk.cand_vars
    n_reads = chunk.n_reads
    n_vars = len(cand)
    if n_reads == 0 or n_vars == 0:
        return False
    dev = resolve_device(getattr(chunk, "_device", None))
    R = _bucket(n_reads, _R_BUCKETS)
    V = _bucket(n_vars, _V_BUCKETS)

    valid_mask = np.zeros(V, dtype=bool)
    valid_mask[:n_vars] = (chunk.var_cate & target_cate) != 0
    scoreable_s, w_score_s, clean_snp_s = _score_masks(chunk, target_cate)
    scoreable = np.zeros(V, dtype=bool)
    scoreable[:n_vars] = scoreable_s
    w_score = np.zeros(V, dtype=np.int32)
    w_score[:n_vars] = w_score_s
    clean_snp = np.zeros(V, dtype=bool)
    clean_snp[:n_vars] = clean_snp_s
    hp = (cand.is_homopolymer_indel
          if cand.is_homopolymer_indel is not None
          else np.zeros(n_vars, dtype=bool))
    hp_het = np.zeros(V, dtype=bool)
    hp_het[:n_vars] = hp
    hp_ont = np.zeros(V, dtype=bool)
    if opt.is_ont:
        hp_ont[:n_vars] = hp

    alleles = np.full((R, V), -1, dtype=np.int8)
    alleles[:n_reads, :n_vars] = chunk.alleles
    starts = np.full(R, -1, dtype=np.int32)
    ends = np.full(R, -2, dtype=np.int32)
    starts[:n_reads] = chunk.read_start_var
    ends[:n_reads] = chunk.read_end_var
    # digar-less (skipped) reads never join scoring or profile updates
    has_digar = np.array([chunk.digars[ri] is not None
                          for ri in range(n_reads)], dtype=bool)
    starts[:n_reads][~has_digar] = -1
    ends[:n_reads][~has_digar] = -2

    cons0 = np.full((2, V), -1, dtype=np.int8)
    cons0[:, :n_vars] = cand.hap_cons_alle[:, 1:].T  # post seed_sweep
    haps0 = np.zeros(R, dtype=np.int8)
    haps0[:n_reads] = chunk.haps

    out = phase_fixpoint(*from_numpy(
        (alleles, starts, ends, cons0, haps0, scoreable, w_score, clean_snp,
         valid_mask, hp_het, hp_ont), dev))
    cons = out.cons.cpu().numpy()
    haps = out.haps.cpu().numpy()
    ps_start = out.ps_start.cpu().numpy()[:n_vars]
    agree = out.agree.cpu().numpy()
    conflict = out.conflict.cpu().numpy()
    profile = out.profile.cpu().numpy()

    cand.hap_cons_alle[:, 1] = cons[0, :n_vars]
    cand.hap_cons_alle[:, 2] = cons[1, :n_vars]
    cand.hap_profile[:, 1, :] = profile[0, :n_vars]
    cand.hap_profile[:, 2, :] = profile[1, :n_vars]
    chunk.haps[:] = haps[:n_reads]
    chunk.n_clean_agree_snps[:] = agree[:n_reads]
    chunk.n_clean_conflict_snps[:] = conflict[:n_reads]
    # phase-set ids: the segment-starting var's position (SNP: pos; indel:
    # pos-1) (assign_hap.c:392-397)
    ok = (ps_start >= 0) & (ps_start < n_vars)
    si = ps_start[ok]
    cand.phase_set[np.nonzero(ok)[0]] = np.where(
        cand.type[si] == CDIFF, cand.pos[si], cand.pos[si] - 1)
    return True
