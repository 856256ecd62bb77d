"""Symmetric DUST low-complexity masking.

Implemented from the algorithm as published — Morgulis, Gertz, Schäffer &
Agarwala, "A fast and symmetric DUST implementation to mask low-complexity
DNA sequences", J. Comput. Biol. 13(5), 2006.  The paper defines the score
of a run of triplets as sum_t C(count_t, 2) over its triplet multiset,
normalised by (run length); a *perfect* interval is one whose score exceeds
the threshold and is not contained in any higher-scoring interval; the
masked output is the union of perfect intervals discovered by a one-pass
scan with a bounded window.

Design notes (this codebase's formulation — deliberately not the vendored
C masker's streaming-queue structure):

* triplet codes are accumulated in an **append-only log**; the active
  window and the high-count-free suffix are just two cursors
  (``win_beg``/``suf_beg``) into that log, so there is no ring buffer and
  no separate suffix-length bookkeeping;
* pair counts (sum of C(count,2)) are maintained incrementally via the
  identity  C(c+1,2) - C(c,2) = c;
* candidate perfect intervals carry their score as an exact rational
  (numerator = pair count, denominator = run length) compared by
  cross-multiplication.

Output convention and parameterisation (T=5, W=20; 0-based half-open
intervals, overlaps merged; window state deliberately persisting across
N breaks while the triplet register resets) match the masker the reference
tool invokes at reference/src/bam_utils.c:1575-1581, so masked sets
are interchangeable.  The C fast path in native/sdust.c mirrors this
module exactly and is fuzz-asserted equal in tests/test_intervals.py.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

WLEN = 3                   # triplet words
NCODE = 1 << (2 * WLEN)    # 64 triplet codes


def _sdust_core(seq4: np.ndarray, T: int, W: int) -> List[Tuple[int, int]]:
    win_len = W - WLEN + 1          # max triplets in the active window

    trips: List[int] = []           # append-only triplet log (push order)
    win_beg = 0                     # window  = trips[win_beg:]
    suf_beg = 0                     # suffix  = trips[suf_beg:] (every code
                                    #   appears <= 2T/10 times in it)
    win_cnt = [0] * NCODE
    suf_cnt = [0] * NCODE
    win_pairs = 0                   # sum_t C(win_cnt[t], 2)
    suf_pairs = 0
    perfect: List[Tuple[int, int, int, int]] = []   # (beg, end, num, den),
                                                    # beg descending
    masked: List[Tuple[int, int]] = []

    def emit_expired(win_seq_beg: int) -> None:
        """Move perfect intervals that fell behind the window into the
        result, merging touching output intervals."""
        if not perfect or perfect[-1][0] >= win_seq_beg:
            return
        beg, end = perfect[-1][0], perfect[-1][1]
        if masked and beg <= masked[-1][1]:
            masked[-1] = (masked[-1][0], max(masked[-1][1], end))
        else:
            masked.append((beg, end))
        while perfect and perfect[-1][0] < win_seq_beg:
            perfect.pop()

    def push(code: int) -> None:
        """Slide the window over one more triplet."""
        nonlocal win_beg, suf_beg, win_pairs, suf_pairs
        if len(trips) - win_beg == win_len:         # window at capacity
            old = trips[win_beg]
            win_beg += 1
            win_cnt[old] -= 1
            win_pairs -= win_cnt[old]
            if suf_beg < win_beg:                   # suffix was the whole
                suf_cnt[old] -= 1                   # window: shrink it too
                suf_pairs -= suf_cnt[old]
                suf_beg = win_beg
        trips.append(code)
        win_pairs += win_cnt[code]
        win_cnt[code] += 1
        suf_pairs += suf_cnt[code]
        suf_cnt[code] += 1
        if suf_cnt[code] * 10 > 2 * T:              # code now too frequent:
            while True:                             # advance suffix past its
                old = trips[suf_beg]                # previous occurrence
                suf_beg += 1
                suf_cnt[old] -= 1
                suf_pairs -= suf_cnt[old]
                if old == code:
                    break

    def probe_perfect(win_seq_beg: int) -> None:
        """Extend the suffix leftwards through the window, recording every
        extension whose score beats T and is not dominated by a
        higher-scoring recorded interval it contains."""
        cnt = suf_cnt.copy()
        pairs = suf_pairs
        best_num = best_den = 0
        for i in range(suf_beg - 1, win_beg - 1, -1):
            code = trips[i]
            pairs += cnt[code]
            cnt[code] += 1
            run = len(trips) - i - 1
            if pairs * 10 > T * run:
                seq_beg = (i - win_beg) + win_seq_beg
                j = 0
                while j < len(perfect) and perfect[j][0] >= seq_beg:
                    p = perfect[j]
                    if best_num == 0 or p[2] * best_den > best_num * p[3]:
                        best_num, best_den = p[2], p[3]
                    j += 1
                if best_num == 0 or pairs * best_den >= best_num * run:
                    best_num, best_den = pairs, run
                    seq_end = (len(trips) - win_beg) + (WLEN - 1) \
                        + win_seq_beg
                    perfect.insert(j, (seq_beg, seq_end, pairs, run))

    n = len(seq4)
    run = 0        # bases since the last N break
    code = 0       # rolling 2-bit triplet register
    for i in range(n + 1):
        b = int(seq4[i]) if i < n else 4
        if b < 4:
            run += 1
            code = ((code << 2) | b) & (NCODE - 1)
            if run >= WLEN:
                win_seq_beg = max(run - W, 0) + (i + 1 - run)
                emit_expired(win_seq_beg)
                push(code)
                if win_pairs * 10 > (len(trips) - suf_beg) * T:
                    probe_perfect(win_seq_beg)
        else:
            win_seq_beg = max(run - W + 1, 0) + (i + 1 - run)
            while perfect:
                emit_expired(win_seq_beg)
                win_seq_beg += 1
            run = code = 0     # triplet register resets; window counts
                               # deliberately persist across the break
    return masked


def sdust(seq4: np.ndarray, T: int = 5, W: int = 20) -> List[Tuple[int, int]]:
    """Mask low-complexity regions of an nt4-coded sequence.

    Exact sequential pass (host oracle; production uses the C fast path
    via sdust_native, which runs once per 500 kb window on the host while
    the device computes)."""
    seq4 = np.asarray(seq4, dtype=np.uint8)
    if len(seq4) < WLEN:
        return []
    return _sdust_core(seq4, T, W)


# ---------------- native fast path ----------------

_NATIVE = None


def _load_native():
    """ctypes binding to the C implementation (built on demand)."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    import ctypes
    import os
    import subprocess
    d = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
    so = os.path.join(d, "_sdust.so")
    src = os.path.join(d, "sdust.c")
    from longcalld_torch.utils.cbuild import build_so
    if not build_so(src, so, flags=("-O2",)):
        _NATIVE = False
        return False
    try:
        lib = ctypes.CDLL(so)
        lib.sdust_mask.restype = ctypes.POINTER(ctypes.c_int64)
        lib.sdust_mask.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.sdust_free.argtypes = [ctypes.POINTER(ctypes.c_int64)]
        _NATIVE = lib
    except OSError:
        _NATIVE = False
    return _NATIVE


def sdust_native(seq4: np.ndarray, T: int = 5, W: int = 20) -> np.ndarray:
    """C-accelerated sdust; falls back to the Python core.  Returns an
    (n, 2) int64 array of [start, end) rows."""
    import ctypes
    lib = _load_native()
    seq4 = np.ascontiguousarray(seq4, dtype=np.uint8)
    if not lib:
        return np.asarray(sdust(seq4, T, W), dtype=np.int64).reshape(-1, 2)
    n_out = ctypes.c_int(0)
    ptr = lib.sdust_mask(
        seq4.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(seq4), T, W, ctypes.byref(n_out))
    try:
        packed = np.ctypeslib.as_array(ptr, shape=(n_out.value,)).copy() \
            if n_out.value else np.empty(0, dtype=np.int64)
    finally:
        if n_out.value:
            lib.sdust_free(ptr)
    out = np.empty((len(packed), 2), dtype=np.int64)
    out[:, 0] = (packed >> 32) & 0xFFFFFFFF
    out[:, 1] = packed & 0xFFFFFFFF
    return out
