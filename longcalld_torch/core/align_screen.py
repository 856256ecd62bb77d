"""Cheap edit-distance screens (host reference implementations).

Covers the reference's edlib uses (reference/src/align.c:164-275):
global (NW) and infix (HW) edit distance with equal-base counting, plus the
cyclic VNTR fuzzy sequence comparator (vntr_fuzzy_comp_seq,
reference/src/collect_var.c:120-150).

The row-wise DP uses the prefix-min trick so every row is one numpy pass,
with a C traceback fast path (native/affine2p.c edit_xgaps_nw).  These
screens run on single short pairs below the device dispatch floor, so
they stay host-side; pairs large enough to benefit from the chip go
through the banded device kernel in longcalld_torch.ops.wfa instead.
"""

from __future__ import annotations

import ctypes

import numpy as np

_U8P = ctypes.POINTER(ctypes.c_uint8)
_XGAPS = None
_EDIT = None


def _bind_native(name: str, argtypes: list):
    """Bind one int64-returning symbol from the shared affine2p library;
    False (cached by the callers) when unavailable."""
    from longcalld_torch.ops.affine_align import _load_native
    lib = _load_native()
    if not lib:
        return False
    try:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = argtypes
        return lib
    except AttributeError:
        return False


def _xgaps_native():
    """ctypes handle to native/affine2p.c's edit_xgaps_nw (C traceback is
    ~5x the numpy row DP; falls back silently when the .so is absent)."""
    global _XGAPS
    if _XGAPS is None:
        _XGAPS = _bind_native("edit_xgaps_nw",
                              [_U8P, ctypes.c_int64, _U8P, ctypes.c_int64])
    return _XGAPS or None


def _edit_native():
    """ctypes handle to native/affine2p.c's edit_distance."""
    global _EDIT
    if _EDIT is None:
        _EDIT = _bind_native("edit_distance",
                             [_U8P, ctypes.c_int64, _U8P, ctypes.c_int64,
                              ctypes.c_int64])
    return _EDIT or None


def _edit_c(target: np.ndarray, query: np.ndarray, hw: int):
    lib = _edit_native()
    if lib is None:
        return None
    t8 = np.ascontiguousarray(target, dtype=np.uint8)
    q8 = np.ascontiguousarray(query, dtype=np.uint8)
    r = lib.edit_distance(t8.ctypes.data_as(_U8P), len(t8),
                          q8.ctypes.data_as(_U8P), len(q8), hw)
    return int(r) if r >= 0 else None


def edit_distance_nw(target: np.ndarray, query: np.ndarray) -> int:
    """Global (NW) edit distance."""
    r = _edit_c(target, query, 0)
    if r is not None:
        return r
    t = np.asarray(target, dtype=np.int16)
    q = np.asarray(query, dtype=np.int16)
    n = len(t)
    if n == 0:
        return len(q)
    prev = np.arange(n + 1, dtype=np.int32)
    pos = np.arange(n + 1, dtype=np.int32)
    for i, qb in enumerate(q, start=1):
        sub = prev[:-1] + (t != qb)
        cand = np.minimum(np.concatenate([[i], sub]),
                          np.concatenate([[i], prev[1:] + 1]))
        cand[0] = i
        # left-dependency via prefix-min of (cand - j) + j
        row = np.minimum.accumulate(cand - pos) + pos
        prev = row
    return int(prev[-1])


def edit_xgaps_nw(target: np.ndarray, query: np.ndarray) -> int:
    """#mismatches + #gap-opens on an optimal global edit path (edlib_xgaps
    + edlibAlignmentToXGAPS, reference/src/align.c:189-233).

    Unlike the affine aligner's op counts, this uses unit gap costs, so
    unrelated sequences cannot hide behind two long cheap gaps — which is
    what makes it the right 10% screen for POA read admission."""
    lib = _xgaps_native()
    if lib is not None:
        t8 = np.ascontiguousarray(target, dtype=np.uint8)
        q8 = np.ascontiguousarray(query, dtype=np.uint8)
        r = lib.edit_xgaps_nw(
            t8.ctypes.data_as(_U8P), len(t8),
            q8.ctypes.data_as(_U8P), len(q8))
        if r >= 0:
            return int(r)
    t = np.asarray(target, dtype=np.int16)
    q = np.asarray(query, dtype=np.int16)
    n, m = len(t), len(q)
    if n == 0 or m == 0:
        return 1 if (n or m) else 0
    rows = np.empty((m + 1, n + 1), dtype=np.int32)
    rows[0] = np.arange(n + 1)
    pos = np.arange(n + 1, dtype=np.int32)
    for i, qb in enumerate(q, start=1):
        prev = rows[i - 1]
        sub = prev[:-1] + (t != qb)
        cand = np.minimum(np.concatenate([[i], sub]),
                          np.concatenate([[i], prev[1:] + 1]))
        cand[0] = i
        rows[i] = np.minimum.accumulate(cand - pos) + pos
    i, j = m, n
    n_mm = 0
    n_gaps = 0
    last_gap = 0  # 1 = consuming query, 2 = consuming target
    while i > 0 or j > 0:
        v = rows[i, j]
        if (i > 0 and j > 0
                and rows[i - 1, j - 1] + (t[j - 1] != q[i - 1]) == v):
            n_mm += int(t[j - 1] != q[i - 1])
            i -= 1
            j -= 1
            last_gap = 0
        elif i > 0 and rows[i - 1, j] + 1 == v:
            if last_gap != 1:
                n_gaps += 1
            last_gap = 1
            i -= 1
        else:
            if last_gap != 2:
                n_gaps += 1
            last_gap = 2
            j -= 1
    return n_mm + n_gaps


def edit_distance_hw(target: np.ndarray, query: np.ndarray) -> int:
    """Infix (HW) edit distance: query aligned inside target, free target
    ends."""
    r = _edit_c(target, query, 1)
    if r is not None:
        return r
    t = np.asarray(target, dtype=np.int16)
    q = np.asarray(query, dtype=np.int16)
    n = len(t)
    if n == 0:
        return len(q)
    prev = np.zeros(n + 1, dtype=np.int32)
    pos = np.arange(n + 1, dtype=np.int32)
    for i, qb in enumerate(q, start=1):
        sub = prev[:-1] + (t != qb)
        cand = np.minimum(np.concatenate([[i], sub]),
                          np.concatenate([[i], prev[1:] + 1]))
        cand[0] = i
        row = np.minimum.accumulate(cand - pos) + pos
        prev = row
    return int(prev.min())


def infix_n_eq(target: np.ndarray, query: np.ndarray) -> int:
    """#equal bases on the optimal infix path, computed as qlen - dist (a
    path with dist edits matches at least qlen-dist query bases; edlib's
    reported count coincides for minimal paths)."""
    d = edit_distance_hw(target, query)
    return max(0, len(query) - d)


def vntr_fuzzy_comp_seq(seq1: np.ndarray, seq2: np.ndarray) -> int:
    """Cyclic-rotation fuzzy match: double the longer sequence, infix-align
    the shorter; equal if >=80% of the shorter matches.  Returns 0 on match,
    1 otherwise (vntr_fuzzy_comp_seq, collect_var.c:120-150)."""
    if len(seq1) > len(seq2):
        long_seq, short_seq = seq1, seq2
    else:
        long_seq, short_seq = seq2, seq1
    doubled = np.concatenate([long_seq, long_seq])
    n_eq = infix_n_eq(doubled, short_seq)
    return 0 if n_eq >= len(short_seq) * 0.8 else 1
