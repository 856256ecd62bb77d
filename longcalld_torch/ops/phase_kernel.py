"""Phasing fixpoint EM on the device: the port of
longcalld_tpu/ops/phase_kernel.py (_phase_fixpoint :83-256,
sharded_phase_fixpoint :279-301, run_phase_kernel :317-418).  It is
PyTorch code (the JAX forms are XLA programs, not Pallas kernels).
Outputs are bit-equal.

* One EM serves one device and a mesh: the reads axis is split into
  contiguous shards (``_ReadShard``), each on its own device, and every
  reduction over reads goes through ``rsum`` (the shards' partial sums
  added on the lead device, the JAX form's psum).  Var-axis state is
  computed once on the lead device and copied to the shards.
  ``phase_fixpoint`` is the one-shard case, ``sharded_phase_fixpoint`` the
  mesh form.
* The masked dots run in float32 and every reduced quantity is a count
  below 2^24 (phase_kernel.py:25-28), so each partial sum and each sum of
  partials is exact in any order, in int32 and in fp32: the sharded EM is
  bit-equal to the one-device EM.  On CUDA that needs full fp32 matmuls:
  the EM raises if TF32 is enabled.
* The serial phase-set scan over variants (phase_kernel.py:149-164, up to
  8192 steps) is two prefix operations: a cummax for the segment start and
  a cumsum parity for the flip state, which is never reset at a new
  segment (``scan_phase_sets``; tests hold it equal to the scan).
* The 10-round counted trip with select-masked updates becomes a loop
  that stops once nothing changed, which gives the same outputs and n_iter.
  The stop is decided from replicated values, so every shard stops in the
  same round.
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
_sharded_calls = 0


def cuda_calls() -> int:
    """How many EM runs had their lead device on CUDA."""
    with _count_lock:
        return _cuda_calls


def sharded_calls() -> int:
    """How many EM runs went through a ``sharded_phase_fixpoint`` mesh."""
    with _count_lock:
        return _sharded_calls


def reset_cuda_calls() -> None:
    """Set both counters to 0."""
    global _cuda_calls, _sharded_calls
    with _count_lock:
        _cuda_calls = 0
        _sharded_calls = 0


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


class _ReadShard:
    """One contiguous block of a window's reads on its own device: the
    (r, V) planes derived from its alleles, and its per-read state (haps,
    agree, conflict).  Its methods do the per-read work of one round and
    return the block's partial sums over reads."""

    def __init__(self, alleles, starts, ends, haps0, valid):
        f32, i32 = torch.float32, torch.int32
        self.device = alleles.device
        self.A = alleles.to(i32)
        A0, A1 = self.A == 0, self.A == 1
        self.Af0, self.Af1 = A0.to(f32), A1.to(f32)
        self.A01 = (A0 | A1).to(f32)
        self.Df = self.Af0 - self.Af1
        self.starts, self.ends = starts, ends
        self.read_valid = starts >= 0
        # constant over the iterations
        self.scored = ((A0 | A1) & self.read_valid[:, None]).any(dim=0)
        tgt = valid.to(f32)[None, :]
        self.Af0t, self.Af1t = self.Af0 * tgt, self.Af1 * tgt
        self.haps = haps0.to(i32)
        self.agree = torch.zeros_like(starts, dtype=i32)
        self.conflict = torch.zeros_like(starts, dtype=i32)

    def phase_set_counts(self, c1, c2, prev_het, iota_v):
        """This block's share of n_agree/n_conflict
        (iter_update_var_hap_cons_phase_set, assign_hap.c:345-422).
        ``prev_own`` indexes the var axis, so a read whose span crosses a
        block boundary needs nothing from another block."""
        i32 = torch.int32
        A = self.A
        h1 = (self.haps == 1)[:, None]
        own_c = torch.where(h1, c1[None, :], c2[None, :])
        oth_c = torch.where(h1, c2[None, :], c1[None, :])
        own_m = (A == own_c) & (A >= 0)
        oth_m = (A == oth_c) & (A >= 0)
        prev_own = own_m.index_select(1, prev_het.clamp_min(0))
        cover = ((self.starts[:, None] <= prev_het[None, :])
                 & (self.ends[:, None] >= iota_v[None, :]))
        act = (self.haps != 0)[:, None] & cover & (prev_het >= 0)[None, :]
        return ((act & prev_own & own_m).sum(dim=0, dtype=i32),
                (act & prev_own & ~own_m & oth_m).sum(dim=0, dtype=i32))

    def reassign(self, sv1, sv2, used, e10, e11, e20, e21):
        """Read re-assignment of iter_update_var_hap_to_cons_alle
        (assign_hap.c:425-467) on this block; ``eXY`` is the clean-SNP
        mask where filled consensus X holds allele Y.  Updates the block's
        haps/agree/conflict and returns its partial per-hap allele counts
        (p10, p11, p20, p21)."""
        f32, i32 = torch.float32, torch.int32
        rv = self.read_valid
        s1 = self.Df @ sv1
        s2 = self.Df @ sv2
        n_used = self.A01 @ used
        max_s = torch.maximum(s1, s2)
        min_s = torch.minimum(s1, s2)
        max_hap = torch.where(s1 >= s2, 1, 2)
        min_hap = torch.where(s1 <= s2, 1, 2)
        hap = torch.where(max_s > 0, max_hap,
                          torch.where(min_s < 0, 3 - min_hap, 0))
        hap = torch.where(n_used == 0, 0, hap)    # iter path maps -1 -> 0
        hap = torch.where(rv, hap, 0).to(i32)

        def cnt(a0v, a1v):
            return self.Af0 @ a0v + self.Af1 @ a1v
        pos = (max_s > 0) & rv
        first = max_hap == 1
        self.agree = torch.where(pos, torch.where(
            first, cnt(e10, e11), cnt(e20, e21)), 0).to(i32)
        self.conflict = torch.where(pos, torch.where(
            first, cnt(e11, e10), cnt(e21, e20)), 0).to(i32)
        self.haps = hap
        h1 = (((hap == 1) | (hap == 0)) & rv).to(f32)
        h2 = (((hap == 2) | (hap == 0)) & rv).to(f32)
        return tuple((h @ m).to(i32) for h in (h1, h2)
                     for m in (self.Af0t, self.Af1t))


def _fixpoint(shards, cons0, scoreable, w_score, clean_snp, valid, hp_het,
              hp_ont, max_iter: int) -> PhaseKernelOut:
    """The EM over ``shards``, a list of (alleles, starts, ends, haps0)
    blocks of consecutive reads, each on its own device; the var-axis
    arguments lie on the lead device, the first block's."""
    global _cuda_calls
    devs = [s[0].device for s in shards]
    if any(d.type == "cuda" for d in devs):
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("phase_fixpoint needs full fp32 matmuls: "
                               "torch.backends.cuda.matmul.allow_tf32 is "
                               "True (utils.device.resolve_device turns it "
                               "off)")
    lead = devs[0]
    if lead.type == "cuda":
        with _count_lock:
            _cuda_calls += 1
    f32, i32 = torch.float32, torch.int32
    V = valid.shape[0]

    def bcast(*vs):
        """Var-axis vectors from the lead device to every block's device
        (no copy for a block on the lead device)."""
        return [[v.to(d, non_blocking=True) for v in vs] for d in devs]

    def rsum(parts):
        """The one reduction over reads: the blocks' partial (V,) sums,
        added on the lead device."""
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(lead, non_blocking=True)
        return total

    blocks = [_ReadShard(a, s, e, h, v) for (a, s, e, h), (v,)
              in zip(shards, bcast(valid))]
    iota_v = torch.arange(V, dtype=i32, device=lead)
    iotas = [b[0] for b in bcast(iota_v)]
    scored_any = scoreable & (rsum([b.scored.to(i32) for b in blocks]) > 0)
    w = w_score.to(i32)
    c1 = cons0[0].to(i32)
    c2 = cons0[1].to(i32)
    prof = torch.zeros((2, V, 2), dtype=i32, device=lead)
    ps_start = torch.full((V,), -1, dtype=i32, device=lead)
    n_iter = 0
    # phase_kernel.py:222-250 runs max_iter select-masked rounds; once a
    # round changes nothing the later rounds are no-ops, so stop there
    for _ in range(max_iter):
        # phase sets and consensus flips (assign_hap.c:345-422)
        het = valid & (c1 != -1) & (c2 != -1) & (c1 != c2) & ~hp_het
        prev_incl = torch.cummax(torch.where(het, iota_v, -1), dim=0).values
        prev_het = torch.cat([prev_incl.new_full((1,), -1), prev_incl[:-1]])
        parts = [b.phase_set_counts(*vs, it) for b, vs, it
                 in zip(blocks, bcast(c1, c2, prev_het), iotas)]
        n_agree = rsum([p[0] for p in parts])
        n_conflict = rsum([p[1] for p in parts])
        ps_start, flip = scan_phase_sets(valid, het, n_agree, n_conflict)
        c1, c2 = torch.where(flip, c2, c1), torch.where(flip, c1, c2)

        # read re-assignment and consensus refresh (assign_hap.c:425-467)
        f1, f2 = _complement_fill(c1, c2, scored_any)
        cons_set = scoreable & (f1 != -1)
        wf = torch.where(cons_set, w, 0).to(f32)
        cs = clean_snp & cons_set
        vecs = (wf * (1 - 2 * f1).to(f32), wf * (1 - 2 * f2).to(f32),
                (cons_set & (w > 0)).to(f32),
                *((cs & (f == a)).to(f32) for f in (f1, f2) for a in (0, 1)))
        parts = [b.reassign(*vs) for b, vs in zip(blocks, bcast(*vecs))]
        p10, p11, p20, p21 = (rsum([p[k] for p in parts]) for k in range(4))
        nc1 = torch.where(valid, _cons_update(p10, p11, hp_ont), f1)
        nc2 = torch.where(valid, _cons_update(p20, p21, hp_ont), f2)
        prof = torch.stack([torch.stack([p10, p11], dim=-1),
                            torch.stack([p20, p21], dim=-1)])
        # changed vs the PRE-fill consensus (phase_kernel.py:216-218)
        changed = flip.any() | (((nc1 != c1) | (nc2 != c2)) & valid).any()
        c1, c2 = nc1, nc2
        n_iter += 1
        if not bool(changed):
            break

    def gather(name):
        return torch.cat([getattr(b, name).to(lead) for b in blocks])
    return PhaseKernelOut(
        cons=torch.stack([c1, c2]).to(torch.int8),
        haps=gather("haps").to(torch.int8), ps_start=ps_start,
        agree=gather("agree"), conflict=gather("conflict"), profile=prof,
        n_iter=n_iter)


def phase_fixpoint(alleles, starts, ends, cons0, haps0, scoreable, w_score,
                   clean_snp, valid, hp_het, hp_ont,
                   max_iter: int = 10) -> PhaseKernelOut:
    """Fixpoint phasing iterations (phase_kernel.py:_phase_fixpoint); the
    arguments are its arguments, as tensors on one device."""
    return _fixpoint([(alleles, starts, ends, haps0)], cons0, scoreable,
                     w_score, clean_snp, valid, hp_het, hp_ont, max_iter)


def shard_reads(devices, alleles, starts, ends, haps0):
    """Split the reads axis into ``len(devices)`` contiguous blocks of R/n
    reads, block k on ``devices[k]``, as ``P("dp")`` places it.  Raises
    when R does not divide evenly."""
    n = len(devices)
    R = alleles.shape[0]
    if R % n:
        raise ValueError(f"{R} reads do not shard evenly over a mesh of {n} "
                         "devices (pad R to a multiple of the mesh size)")
    r = R // n
    return [tuple(x[k * r:(k + 1) * r].to(d, non_blocking=True)
                  for x in (alleles, starts, ends, haps0))
            for k, d in enumerate(devices)]


def sharded_phase_fixpoint(devices, max_iter: int = 10):
    """The reads-axis mesh form (phase_kernel.py:sharded_phase_fixpoint):
    returns a callable with phase_fixpoint's array arguments (on any
    device) that splits R into ``len(devices)`` contiguous blocks, one per
    mesh device (``shard_reads``; R must divide evenly).  haps, agree and
    conflict come back concatenated in block order, the var-axis outputs
    once; all on the lead device ``devices[0]``."""
    devices = [torch.device(d) for d in devices]

    def run(alleles, starts, ends, cons0, haps0, scoreable, w_score,
            clean_snp, valid, hp_het, hp_ont) -> PhaseKernelOut:
        global _sharded_calls
        shards = shard_reads(devices, alleles, starts, ends, haps0)
        with _count_lock:
            _sharded_calls += 1
        lead = devices[0]
        return _fixpoint(shards, *(x.to(lead) for x in (
            cons0, scoreable, w_score, clean_snp, valid, hp_het, hp_ont)),
            max_iter)
    return run


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
    post-sweep chunk, run the EM on the chunk's ``_device`` (default
    cuda:0) or, with ``opt.mesh_devices > 1``, over the chunk's ``_mesh``
    (default ``make_mesh(mesh_devices, _device)``) with R padded to a
    multiple of the mesh size, and write results back.  Returns False
    (caller runs the host loop) when the window shape is degenerate."""
    from longcalld_torch.core.phase import _score_masks
    from longcalld_torch.io.bam import CDIFF

    cand = chunk.cand_vars
    n_reads = chunk.n_reads
    n_vars = len(cand)
    if n_reads == 0 or n_vars == 0:
        return False
    dev = resolve_device(getattr(chunk, "_device", None))
    R = _bucket(n_reads, _R_BUCKETS)
    V = _bucket(n_vars, _V_BUCKETS)
    mesh = None
    if int(getattr(opt, "mesh_devices", 0) or 0) > 1:
        mesh = getattr(chunk, "_mesh", None)
        if mesh is None:
            from longcalld_torch.parallel.mesh import make_mesh
            mesh = make_mesh(opt.mesh_devices, dev)
        R += (-R) % len(mesh)    # reads axis shards evenly over the mesh

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

    # padding reads (starts -1, haps 0) never score or count
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

    arrays = (alleles, starts, ends, cons0, haps0, scoreable, w_score,
              clean_snp, valid_mask, hp_het, hp_ont)
    if mesh is None:
        out = phase_fixpoint(*from_numpy(arrays, dev))
    else:
        # host tensors: each read block is copied straight to its device
        out = sharded_phase_fixpoint(mesh)(*from_numpy(arrays, "cpu"))
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
