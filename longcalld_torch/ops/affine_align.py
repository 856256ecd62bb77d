"""Gap-affine-2p pairwise alignment with traceback (host oracle).

Functional replacement for the reference's WFA2-lib usage (wfa_end2end_aln,
reference/src/align.c:374-460): global alignment under
match=0 / mismatch / {open1,ext1} / {open2,ext2} costs, emitting BAM-style
CIGAR and gap-padded "alignment strings" over the 0-5 alphabet (5 = '-').
Left-gap placement is achieved exactly like the reference: align the
reversed sequences, then reverse the result (:410-458).

Rows are numpy-vectorized: the only sequential dependency inside a row (the
insertion state) collapses to a prefix-min because gaps open from M only:
    I[i,j] = min_{g<j} M[i,g] + o + (j-g)*e
           = (running min of M[i,g] - g*e) + j*e + o.
Execution tiers (all produce identical results):
  1. native/affine2p.c via ctypes -- bit-identical C port, releases the
     GIL so batches parallelize across worker threads;
  2. this numpy implementation -- the readable oracle and fallback;
  3. longcalld_torch.ops.wfa -- the batched banded jax/lax device kernel
     (same recursion, band-escape-checked, exact-fallback to tiers 1/2).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

BIG = np.int32(1 << 28)

# preference order for ties: I1, I2, D1, D2, M -> canonical state ids
_PERM = np.array([1, 2, 3, 4, 0], dtype=np.uint8)

# op codes (BAM): 7 '=', 8 'X', 1 'I' (consumes text), 2 'D' (consumes
# pattern)
OP_EQ, OP_X, OP_I, OP_D = 7, 8, 1, 2


class AlnResult(NamedTuple):
    cigar: np.ndarray        # (k, 2) of (op, len)
    pattern_alg: np.ndarray  # uint8, gap-padded pattern (5 = gap)
    text_alg: np.ndarray     # uint8, gap-padded text
    score: int               # total cost (>= 0)


def align_affine2p(pattern: np.ndarray, text: np.ndarray,
                   mismatch: int = 6, gap_open1: int = 6, gap_ext1: int = 2,
                   gap_open2: int = 24, gap_ext2: int = 1,
                   left_align: bool = True) -> AlnResult:
    p = np.asarray(pattern, dtype=np.uint8)
    t = np.asarray(text, dtype=np.uint8)
    if left_align:
        res = _align(p[::-1].copy(), t[::-1].copy(), mismatch, gap_open1,
                     gap_ext1, gap_open2, gap_ext2)
        return AlnResult(cigar=res.cigar[::-1].copy(),
                         pattern_alg=res.pattern_alg[::-1].copy(),
                         text_alg=res.text_alg[::-1].copy(),
                         score=res.score)
    return _align(p, t, mismatch, gap_open1, gap_ext1, gap_open2, gap_ext2)


def _gap_cost(length: int, o1: int, e1: int, o2: int, e2: int) -> int:
    if length == 0:
        return 0
    return min(o1 + e1 * length, o2 + e2 * length)


# ---------------- native fast path ----------------

_NATIVE = None
# product-cells cap for the native path.  The routed C entry only needs
# n x guided-band memory on the (dominant) pairs its greedy prepass can
# bound, so the cap guards just the degenerate worst case where every
# fallback tier would try a full plane; past it the numpy oracle would
# be hopeless too, so it is set far above any pair the pipeline produces
_NATIVE_MAX_CELLS = 1 << 33


def _load_native():
    """ctypes binding to native/affine2p.c (compiled on demand, like the
    sdust fast path)."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    import ctypes
    import os
    import subprocess
    d = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
    so = os.path.join(d, "_affine2p.so")
    src = os.path.join(d, "affine2p.c")
    if os.path.exists(src):
        from longcalld_torch.utils.cbuild import build_so
        if not build_so(src, so):
            _NATIVE = False
            return False
    try:
        lib = ctypes.CDLL(so)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.affine2p_align.restype = ctypes.c_int
        lib.affine2p_align.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, u8p, i64p]
        lib.affine2p_align_full.restype = ctypes.c_int
        lib.affine2p_align_full.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            u8p, u8p, u8p, i64p, i64p, i64p]
        lib.affine2p_align_band_full.restype = ctypes.c_int
        lib.affine2p_align_band_full.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            u8p, u8p, u8p, i64p, i64p, i64p]
        lib.affine2p_align_auto_full.restype = ctypes.c_int
        lib.affine2p_align_auto_full.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            u8p, u8p, u8p, i64p, i64p, i64p]
        lib.affine2p_cell_counter.restype = ctypes.c_int64
        lib.affine2p_cell_counter.argtypes = [ctypes.c_int64]
        lib.affine2p_align_many.restype = ctypes.c_int
        lib.affine2p_align_many.argtypes = [
            u8p, i64p, u8p, i64p, ctypes.c_int64, u8p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            u8p, u8p, i64p, i64p, i64p, i64p, i64p, ctypes.c_int64]
        _NATIVE = lib
    except OSError:
        _NATIVE = False
    return _NATIVE


def native_cell_counters() -> dict:
    """Actual executed host-DP work from native/affine2p.c (process-wide
    accumulators): banded cells (rows x padded width), full-plane cells,
    and the greedy-prepass work proxy (diagonal visits + slide steps).
    These measure what the CPU truly ran, unlike the routing layer's
    pattern x text products; the bench compares them against the
    reference's modeled WFA2 wavefront volume."""
    lib = _load_native()
    if not lib:
        return {}
    return {"cells_host_band_exec": int(lib.affine2p_cell_counter(0)),
            "cells_host_full_exec": int(lib.affine2p_cell_counter(1)),
            "cells_host_greedy_exec": int(lib.affine2p_cell_counter(2))}


def _align_native(p: np.ndarray, t: np.ndarray, x: int, o1: int, e1: int,
                  o2: int, e2: int):
    """C exact DP (ctypes releases the GIL, so batch callers thread this).
    Returns None when unavailable/oversize -> numpy fallback."""
    import ctypes
    lib = _load_native()
    if not lib:
        return None
    n, m = len(p), len(t)
    if (n + 1) * (m + 1) > _NATIVE_MAX_CELLS:
        return None
    p = np.ascontiguousarray(p, dtype=np.uint8)
    t = np.ascontiguousarray(t, dtype=np.uint8)
    L = n + m
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    ops_fwd = np.empty(L, dtype=np.uint8)
    pat_alg = np.empty(L, dtype=np.uint8)
    txt_alg = np.empty(L, dtype=np.uint8)
    cigar = np.empty((L, 2), dtype=np.int64)
    score = ctypes.c_int64(0)
    n_cigar = ctypes.c_int64(0)
    # routed entry: greedy O(nd) prepass -> provably escape-free guided
    # band; identical-pair shortcut; full-DP / ladder fallback (all in C)
    k = lib.affine2p_align_auto_full(
        p.ctypes.data_as(u8p), n, t.ctypes.data_as(u8p), m,
        x, o1, e1, o2, e2,
        ops_fwd.ctypes.data_as(u8p), pat_alg.ctypes.data_as(u8p),
        txt_alg.ctypes.data_as(u8p), cigar.ctypes.data_as(i64p),
        ctypes.byref(n_cigar), ctypes.byref(score))
    if k < 0:
        return None
    return AlnResult(cigar=cigar[:n_cigar.value], pattern_alg=pat_alg[:k],
                     text_alg=txt_alg[:k], score=int(score.value))


def align_affine2p_many(pairs, flags, mismatch: int, gap_open1: int,
                        gap_ext1: int, gap_open2: int, gap_ext2: int,
                        n_threads: int = 8):
    """Batched align_affine2p: ONE GIL-released C call aligns every pair
    (atomic-counter worker threads, native/affine2p.c affine2p_align_many),
    including the per-pair left-gap reversal.  Oversize pairs (full-DP
    memory cap) fall back to the single-pair path.  Returns a list of
    AlnResult, or None when the native library is unavailable."""
    import ctypes
    lib = _load_native()
    if not lib:
        return None
    n_pairs = len(pairs)
    if n_pairs == 0:
        return []
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    # LPT scheduling: hand the workers the most expensive pairs first so a
    # big pair drawn last can't extend the batch wall (atomic-counter
    # stealing balances the rest); outputs are un-permuted below
    def cost(p, t):
        n, m = len(p), len(t)
        cells = (n + 1) * (m + 1)
        return cells if cells <= (1 << 16) else max(n, m) * (abs(n - m) + 128)
    perm = sorted(range(n_pairs),
                  key=lambda k: -cost(pairs[k][0], pairs[k][1]))
    inv = [0] * n_pairs
    for r, k in enumerate(perm):
        inv[k] = r
    pairs = [pairs[k] for k in perm]
    flags = [flags[k] for k in perm]
    plens = np.array([len(p) for p, _ in pairs], dtype=np.int64)
    tlens = np.array([len(t) for _, t in pairs], dtype=np.int64)
    oversize = (plens + 1) * (tlens + 1) > _NATIVE_MAX_CELLS
    poff = np.zeros(n_pairs + 1, dtype=np.int64)
    toff = np.zeros(n_pairs + 1, dtype=np.int64)
    np.cumsum(np.where(oversize, 0, plens), out=poff[1:])
    np.cumsum(np.where(oversize, 0, tlens), out=toff[1:])
    pbuf = np.empty(int(poff[-1]), dtype=np.uint8)
    tbuf = np.empty(int(toff[-1]), dtype=np.uint8)
    for k, (p, t) in enumerate(pairs):
        if not oversize[k]:
            pbuf[poff[k]:poff[k + 1]] = p
            tbuf[toff[k]:toff[k + 1]] = t
    la = np.array([1 if f else 0 for f in flags], dtype=np.uint8)
    ooff = np.zeros(n_pairs + 1, dtype=np.int64)
    np.cumsum(np.where(oversize, 0, plens + tlens), out=ooff[1:])
    total = int(ooff[-1])
    pat = np.empty(total, dtype=np.uint8)
    txt = np.empty(total, dtype=np.uint8)
    cigar = np.empty(2 * total, dtype=np.int64)
    klen = np.full(n_pairs, -1, dtype=np.int64)
    ncig = np.zeros(n_pairs, dtype=np.int64)
    score = np.zeros(n_pairs, dtype=np.int64)
    # oversize pairs get zero-width slices; mark them failed so the
    # single-pair fallback below handles them
    rc = lib.affine2p_align_many(
        pbuf.ctypes.data_as(u8p), poff.ctypes.data_as(i64p),
        tbuf.ctypes.data_as(u8p), toff.ctypes.data_as(i64p),
        n_pairs, la.ctypes.data_as(u8p),
        mismatch, gap_open1, gap_ext1, gap_open2, gap_ext2,
        pat.ctypes.data_as(u8p), txt.ctypes.data_as(u8p),
        ooff.ctypes.data_as(i64p), cigar.ctypes.data_as(i64p),
        klen.ctypes.data_as(i64p), ncig.ctypes.data_as(i64p),
        score.ctypes.data_as(i64p), max(1, int(n_threads)))
    if rc < 0:
        return None
    out = []
    for k in range(n_pairs):
        kk = int(klen[k])
        if oversize[k] or kk < 0:
            out.append(align_affine2p(pairs[k][0], pairs[k][1], mismatch,
                                      gap_open1, gap_ext1, gap_open2,
                                      gap_ext2, left_align=bool(flags[k])))
            continue
        o = int(ooff[k])
        nc = int(ncig[k])
        out.append(AlnResult(
            cigar=cigar[2 * o:2 * o + 2 * nc].reshape(nc, 2).copy(),
            pattern_alg=pat[o:o + kk].copy(),
            text_alg=txt[o:o + kk].copy(),
            score=int(score[k])))
    return [out[inv[k]] for k in range(n_pairs)]


def _align(p: np.ndarray, t: np.ndarray, x: int, o1: int, e1: int,
           o2: int, e2: int) -> AlnResult:
    n, m = len(p), len(t)
    if n == 0 or m == 0:
        ops = np.concatenate([np.full(n, OP_D, dtype=np.int64),
                              np.full(m, OP_I, dtype=np.int64)])
        score = _gap_cost(n, o1, e1, o2, e2) + _gap_cost(m, o1, e1, o2, e2)
        return _finish(p, t, ops, score)
    res = _align_native(p, t, x, o1, e1, o2, e2)
    if res is not None:
        return res

    jj = np.arange(m + 1, dtype=np.int64)
    M = np.full(m + 1, BIG, dtype=np.int32)
    I1 = np.full(m + 1, BIG, dtype=np.int32)
    I2 = np.full(m + 1, BIG, dtype=np.int32)
    D1 = np.full(m + 1, BIG, dtype=np.int32)
    D2 = np.full(m + 1, BIG, dtype=np.int32)
    M[0] = 0
    I1[1:] = o1 + e1 * jj[1:]
    I2[1:] = o2 + e2 * jj[1:]

    # traceback: tbM = source state of the diagonal step (0..4);
    # tb{I,D}{1,2} True = extension, False = opened from M
    tbM = np.zeros((n + 1, m + 1), dtype=np.uint8)
    tbI1 = np.zeros((n + 1, m + 1), dtype=bool)
    tbI2 = np.zeros((n + 1, m + 1), dtype=bool)
    tbD1 = np.zeros((n + 1, m + 1), dtype=bool)
    tbD2 = np.zeros((n + 1, m + 1), dtype=bool)
    tbI1[0, 1:] = jj[1:] > 1
    tbI2[0, 1:] = jj[1:] > 1

    for i in range(1, n + 1):
        sub = np.where(p[i - 1] == t, 0, x).astype(np.int32)
        # tie-break prefers gap states over M so gaps sit as late (right)
        # as possible — matching WFA2's natural placement, which the
        # left_align reversal then flips
        stack = np.stack([I1[:-1], I2[:-1], D1[:-1], D2[:-1], M[:-1]])
        src_perm = np.argmin(stack, axis=0)
        diag_best = np.take_along_axis(stack, src_perm[None, :], axis=0)[0]
        src = _PERM[src_perm]
        nM = np.full(m + 1, BIG, dtype=np.int32)
        nM[1:] = np.minimum(diag_best.astype(np.int64) + sub, BIG)
        tbM[i, 1:] = src

        open1 = np.minimum(M.astype(np.int64) + o1 + e1, BIG).astype(np.int32)
        ext1 = np.minimum(D1.astype(np.int64) + e1, BIG).astype(np.int32)
        nD1 = np.minimum(open1, ext1)
        tbD1[i] = ext1 < open1
        open2 = np.minimum(M.astype(np.int64) + o2 + e2, BIG).astype(np.int32)
        ext2 = np.minimum(D2.astype(np.int64) + e2, BIG).astype(np.int32)
        nD2 = np.minimum(open2, ext2)
        tbD2[i] = ext2 < open2

        nI1 = np.full(m + 1, BIG, dtype=np.int32)
        nI2 = np.full(m + 1, BIG, dtype=np.int32)
        base1 = np.where(nM < BIG, nM.astype(np.int64) - jj * e1, BIG)
        run1 = np.minimum.accumulate(base1)
        nI1[1:] = np.minimum(run1[:-1] + jj[1:] * e1 + o1, BIG)
        base2 = np.where(nM < BIG, nM.astype(np.int64) - jj * e2, BIG)
        run2 = np.minimum.accumulate(base2)
        nI2[1:] = np.minimum(run2[:-1] + jj[1:] * e2 + o2, BIG)
        adj1 = np.minimum(nM[:-1].astype(np.int64) + o1 + e1, BIG)
        adj2 = np.minimum(nM[:-1].astype(np.int64) + o2 + e2, BIG)
        tbI1[i, 1:] = nI1[1:] < adj1
        tbI2[i, 1:] = nI2[1:] < adj2

        M, I1, I2, D1, D2 = nM, nI1, nI2, nD1, nD2

    finals = np.array([I1[m], I2[m], D1[m], D2[m], M[m]])
    state = int(_PERM[int(np.argmin(finals))])
    score = int(finals.min())

    ops = []
    i, j = n, m
    while i > 0 or j > 0:
        if state == 0:
            if i == 0:      # leading text gap reached via row-0 I chain
                state = 1
                continue
            if j == 0:      # leading pattern gap reached via column-0 D chain
                state = 3
                continue
            ops.append(OP_EQ if p[i - 1] == t[j - 1] else OP_X)
            state = int(tbM[i, j])
            i -= 1
            j -= 1
        elif state in (1, 2):
            ext = tbI1[i, j] if state == 1 else tbI2[i, j]
            ops.append(OP_I)
            j -= 1
            if not ext:
                state = 0
        else:
            ext = tbD1[i, j] if state == 3 else tbD2[i, j]
            ops.append(OP_D)
            i -= 1
            if not ext:
                state = 0
    ops.reverse()
    return _finish(p, t, np.array(ops, dtype=np.int64), score)


def _finish(p: np.ndarray, t: np.ndarray, ops: np.ndarray,
            score: int) -> AlnResult:
    L = len(ops)
    pat_alg = np.full(L, 5, dtype=np.uint8)
    txt_alg = np.full(L, 5, dtype=np.uint8)
    consume_p = (ops == OP_EQ) | (ops == OP_X) | (ops == OP_D)
    consume_t = (ops == OP_EQ) | (ops == OP_X) | (ops == OP_I)
    if L:
        pi = np.cumsum(consume_p) - 1
        ti = np.cumsum(consume_t) - 1
        pat_alg[consume_p] = p[pi[consume_p]]
        txt_alg[consume_t] = t[ti[consume_t]]
        change = np.nonzero(np.diff(ops))[0] + 1
        bounds = np.concatenate([[0], change, [L]])
        cig = np.stack([ops[bounds[:-1]], bounds[1:] - bounds[:-1]], axis=1)
    else:
        cig = np.zeros((0, 2), dtype=np.int64)
    return AlnResult(cigar=cig, pattern_alg=pat_alg, text_alg=txt_alg,
                     score=int(score))
