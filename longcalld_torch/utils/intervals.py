"""Labelled interval sets (replaces cgranges: reference/src/cgranges.c).

All coordinates are 0-based half-open [start, end), matching the reference's
cr_add convention.  The reference stores intervals in a single pseudo-contig
("cr"), so this implementation drops the contig dimension entirely and keeps
numpy arrays sorted by (start, end) for vectorized overlap queries.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np


class IntervalSet:
    """Sorted labelled intervals with overlap / containment / merge ops."""

    __slots__ = ("_starts", "_ends", "_labels", "_pending", "_pending_arr",
                 "_indexed", "_runmax")

    def __init__(self):
        self._starts = np.empty(0, dtype=np.int64)
        self._ends = np.empty(0, dtype=np.int64)
        self._labels = np.empty(0, dtype=np.int64)
        self._pending: List[Tuple[int, int, int]] = []
        self._pending_arr: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._indexed = True
        self._runmax = None

    @classmethod
    def from_arrays(cls, starts, ends, labels=None) -> "IntervalSet":
        s = cls()
        starts = np.asarray(starts, dtype=np.int64)
        ends = np.asarray(ends, dtype=np.int64)
        labels = (np.zeros_like(starts) if labels is None
                  else np.asarray(labels, dtype=np.int64))
        order = np.lexsort((ends, starts))
        s._starts, s._ends, s._labels = starts[order], ends[order], labels[order]
        return s

    def _run_max(self) -> np.ndarray:
        """Running max of ends over the start-sorted order: intervals with
        start < q live in a prefix, and the prefix overlaps (qstart, ·) iff
        its max end exceeds qstart — the cgranges implicit-tree trick
        flattened to one cached cummax."""
        if self._runmax is None:
            self._runmax = np.maximum.accumulate(self._ends)
        return self._runmax

    def add(self, start: int, end: int, label: int = 0) -> None:
        self._pending.append((int(start), int(end), int(label)))
        self._indexed = False

    def add_many(self, starts, ends, label: int = 0) -> None:
        """Bulk add with one shared label (no Python work per row)."""
        starts = np.asarray(starts, dtype=np.int64)
        if not len(starts):
            return
        self._pending_arr.append(
            (starts, np.asarray(ends, dtype=np.int64),
             np.full(len(starts), label, dtype=np.int64)))
        self._indexed = False

    def index(self) -> "IntervalSet":
        if self._pending or self._pending_arr:
            chunks_s = [self._starts]
            chunks_e = [self._ends]
            chunks_l = [self._labels]
            if self._pending:
                chunks_s.append(np.array([p[0] for p in self._pending],
                                         dtype=np.int64))
                chunks_e.append(np.array([p[1] for p in self._pending],
                                         dtype=np.int64))
                chunks_l.append(np.array([p[2] for p in self._pending],
                                         dtype=np.int64))
            for s, e, l in self._pending_arr:
                chunks_s.append(s)
                chunks_e.append(e)
                chunks_l.append(l)
            starts = np.concatenate(chunks_s)
            ends = np.concatenate(chunks_e)
            labels = np.concatenate(chunks_l)
            order = np.lexsort((ends, starts))
            self._starts, self._ends, self._labels = (
                starts[order], ends[order], labels[order])
            self._pending.clear()
            self._pending_arr.clear()
            self._runmax = None
        self._indexed = True
        return self

    def __len__(self) -> int:
        self.index()
        return len(self._starts)

    @property
    def starts(self) -> np.ndarray:
        self.index()
        return self._starts

    @property
    def ends(self) -> np.ndarray:
        self.index()
        return self._ends

    @property
    def labels(self) -> np.ndarray:
        self.index()
        return self._labels

    def __iter__(self) -> Iterator[Tuple[int, int, int]]:
        self.index()
        for s, e, l in zip(self._starts, self._ends, self._labels):
            yield int(s), int(e), int(l)

    # --- queries (mirror cr_overlap / cr_is_contained semantics) ---
    def overlap_indices(self, qstart: int, qend: int) -> np.ndarray:
        """Indices of intervals with start < qend and end > qstart."""
        self.index()
        if len(self._starts) == 0:
            return np.empty(0, dtype=np.int64)
        hi = int(self._starts.searchsorted(qend, side="left"))
        if hi == 0:
            return np.empty(0, dtype=np.int64)
        # the run-max is nondecreasing: indices below its first value
        # > qstart cannot overlap, so the candidate window is [lo, hi)
        lo = int(self._run_max().searchsorted(qstart, side="right"))
        if lo >= hi:
            return np.empty(0, dtype=np.int64)
        return lo + np.nonzero(self._ends[lo:hi] > qstart)[0]

    def any_overlap(self, qstart: int, qend: int) -> bool:
        self.index()
        if len(self._starts) == 0:
            return False
        hi = int(self._starts.searchsorted(qend, side="left"))
        return hi > 0 and int(self._run_max()[hi - 1]) > qstart

    def overlap_mask_points(self, points: np.ndarray) -> np.ndarray:
        """For each 0-based point p, whether some interval has start<=p<end.
        Vectorized replacement for per-site is_in_noisy_reg loops."""
        self.index()
        pts = np.asarray(points, dtype=np.int64)
        if len(self._starts) == 0:
            return np.zeros(pts.shape, dtype=bool)
        # max end among intervals with start <= p, via running max on sorted starts
        run_max_end = self._run_max()
        idx = np.searchsorted(self._starts, pts, side="right") - 1
        ok = idx >= 0
        res = np.zeros(pts.shape, dtype=bool)
        res[ok] = run_max_end[idx[ok]] > pts[ok]
        return res

    def overlap_mask_ranges(self, qstarts: np.ndarray, qends: np.ndarray) -> np.ndarray:
        """For each query range, whether any interval overlaps it."""
        self.index()
        qs = np.asarray(qstarts, dtype=np.int64)
        qe = np.asarray(qends, dtype=np.int64)
        if len(self._starts) == 0:
            return np.zeros(qs.shape, dtype=bool)
        run_max_end = self._run_max()
        idx = np.searchsorted(self._starts, qe, side="left") - 1
        ok = idx >= 0
        res = np.zeros(qs.shape, dtype=bool)
        res[ok] = run_max_end[idx[ok]] > qs[ok]
        return res

    def contained_in_any(self, qstart: int, qend: int) -> bool:
        """True if [qstart,qend) is fully inside one interval
        (cr_is_contained)."""
        self.index()
        if len(self._starts) == 0:
            return False
        hi = int(self._starts.searchsorted(qstart, side="right"))
        return hi > 0 and int(self._run_max()[hi - 1]) >= qend

    # --- merge (mirror cr_merge / cr_cluster0, cgranges.c:225-300) ---
    def merge(self, fixed_merge_win: int) -> "IntervalSet":
        """Iteratively cluster intervals.

        fixed_merge_win >= 0: merge when gap <= fixed_merge_win.
        fixed_merge_win < 0: dynamic window = min(label_i, label_j)
        (cgranges.c:248-255).  Runs to fixpoint like cr_merge."""
        self.index()
        cur = self
        while True:
            nxt = cur._cluster_once(fixed_merge_win)
            if len(nxt) == len(cur):
                return nxt
            cur = nxt

    def _cluster_once(self, fixed_merge_win: int) -> "IntervalSet":
        n = len(self)
        if n == 0:
            return IntervalSet()
        starts, ends, labels = self._starts, self._ends, self._labels
        merged_into = np.zeros(n, dtype=bool)
        out_s, out_e, out_l = [], [], []
        for j in range(n):
            if merged_into[j]:
                continue
            ms, me, ml = int(starts[j]), int(ends[j]), int(labels[j])
            for k in range(j + 1, n):
                if merged_into[k]:
                    continue
                win = (min(ml, int(labels[k])) if fixed_merge_win < 0
                       else fixed_merge_win)
                if me + win >= starts[k]:
                    ml = max(ml, int(labels[k]))
                    ms = min(ms, int(starts[k]))
                    me = max(me, int(ends[k]))
                    merged_into[k] = True
                elif me + (ml if fixed_merge_win < 0
                           else fixed_merge_win) < starts[k]:
                    # starts are sorted and the effective window never
                    # exceeds this bound, so no later k can merge either
                    break
            out_s.append(ms)
            out_e.append(me)
            out_l.append(ml)
        return IntervalSet.from_arrays(out_s, out_e, out_l)

    def union_with(self, other: "IntervalSet") -> "IntervalSet":
        return IntervalSet.from_arrays(
            np.concatenate([self.starts, other.starts]),
            np.concatenate([self.ends, other.ends]),
            np.concatenate([self.labels, other.labels]))

    def total_length(self) -> int:
        """Sum of (end-start+1) per interval — matches
        collect_noisy_region_len (src/bam_utils.c:631-638) which counts the
        cr_start..cr_end span inclusively."""
        self.index()
        return int((self._ends - self._starts + 1).sum()) if len(self) else 0
