"""Batched banded gap-affine-2p alignment on the device: the port of
longcalld_tpu/ops/wfa.py.

* ``align_device`` is the device program wfa.py:_align_device /
  _align_device_pallas (:242-256, :359-387): the forward DP kernel, then
  the traceback kernel, whose epilogue does _compact_events (:188-239) and
  the meta row (ops/band.py:backward_events); ``compact_events``, the
  compaction's torch form, is that kernel's plain version.  Outputs are
  bit-equal.
* ``BatchAligner``, ``get_aligner``, ``aligner_totals`` and
  ``calibrate_min_cells`` are wfa.py:505-962 carried over: the memo, size
  and band routing, buckets, the reversal trick for the left-gap
  convention, ``_reconstruct`` and the host C fallback are unchanged.
  Left behind: the shape-journal prewarm, the link trims (``_trim_*``),
  the per-round log, the asynchronous event-head copy and the VMEM
  chunking.  In place of the VMEM cap, ``align_device`` splits a batch
  so that one launch's traceback buffer stays under ``TB_BUDGET_BYTES``.
  Each host wait on the card (an upload, a copy back) is a
  ``device_wait`` span (utils/counters).
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from longcalld_torch.ops import band
from longcalld_torch.ops.affine_align import (AlnResult, _finish,
                                              align_affine2p,
                                              align_affine2p_many)
from longcalld_torch.ops.convert import from_numpy
from longcalld_torch.utils import counters
from longcalld_torch.utils.device import resolve_device

BIG = band.BIG
OP_EQ, OP_X, OP_I, OP_D = 7, 8, 1, 2
# one launch's traceback bytes, (Lp+1) x batch x B: larger batches are split
TB_BUDGET_BYTES = 1 << 30


def _copy_result(r: AlnResult) -> AlnResult:
    """Fresh arrays so memoized results can't be mutated through callers."""
    return AlnResult(r.cigar.copy(), r.pattern_alg.copy(),
                     r.text_alg.copy(), r.score)


# the compaction's torch form (the events kernel's plain version) and its
# buffer width live in ops/band.py beside the kernel; kept here by name
_event_k = band.event_k
compact_events = band.compact_events


def align_device(P, Tband, plen, tlen, dlo, B: int, Lp: int, x: int, o1: int,
                 e1: int, o2: int, e2: int, plen_host=None):
    """Forward DP, then the traceback walk with its event compaction, per
    chunk of the batch.  Returns (evs (batch, K) int32, meta (batch, 4)
    int32 = [score, b0, edge_min, n_ev]).  On CUDA that is two kernel
    launches a chunk; each chunk's walk writes its rows of the outputs.
    ``plen_host``, the pattern lengths as a host array, counts each
    forward launch's real rows into ``band.fwd_rows``."""
    batch, dev = P.shape[0], P.device
    step = max(1, TB_BUDGET_BYTES // ((Lp + 1) * B))
    evs = torch.empty((batch, band.event_k(Lp)), dtype=torch.int32,
                      device=dev)
    meta = torch.empty((batch, 4), dtype=torch.int32, device=dev)
    for k0 in range(0, batch, step):
        sl = slice(k0, min(k0 + step, batch))
        if plen_host is not None:
            band.count_fwd_rows((B, Lp, sl.stop - sl.start),
                                int(plen_host[sl].sum()))
        tbs, finals, edge_min = band.banded_dp(
            P[sl], Tband[sl], plen[sl], tlen[sl], dlo[sl], B, Lp, x, o1, e1,
            o2, e2)
        band.backward_events(tbs, plen[sl], tlen[sl], dlo[sl], finals,
                             edge_min, B, Lp, out=(evs[sl], meta[sl]))
        del tbs
    return evs, meta


_CALIBRATED_MIN_CELLS: dict = {}


def calibrate_min_cells(device, x: int = 6, o1: int = 6, e1: int = 2,
                        o2: int = 24, e2: int = 1) -> int:
    """Host/device routing threshold from this machine's measured numbers
    (wfa.py:270-345): a pair of c DP cells goes to the device only when
    its host cost c / H exceeds twice the device round trip L, so
    min_cells = 2·L·H, floored at 65,536.  L is a launch plus
    ``torch.cuda.synchronize``; H is the host C aligner's cells/s on a
    1%-divergent 2000 bp pair.  On CPU tensors the "device" is the host
    itself, so the legacy 25,000,000 threshold stays.  The environment
    variable LONGCALLD_DEVICE_MIN_CELLS overrides both."""
    env = os.environ.get("LONGCALLD_DEVICE_MIN_CELLS")
    if env:
        return max(1, int(env))
    dev = resolve_device(device)
    key = str(dev)
    got = _CALIBRATED_MIN_CELLS.get(key)
    if got is not None:
        return got
    if dev.type == "cpu":
        _CALIBRATED_MIN_CELLS[key] = 25_000_000
        return 25_000_000

    arr = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    arr.add_(1)
    torch.cuda.synchronize(dev)
    lats = []
    for _ in range(5):
        t0 = time.perf_counter()
        arr.add_(1)
        torch.cuda.synchronize(dev)
        lats.append(time.perf_counter() - t0)
    latency = sorted(lats)[len(lats) // 2]

    rng = np.random.default_rng(0)
    p = rng.integers(0, 4, 2000).astype(np.uint8)
    t = p.copy()
    mut = rng.choice(2000, 20, replace=False)
    t[mut] = (t[mut] + 1) % 4
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        align_affine2p(p, t, x, o1, e1, o2, e2, left_align=False)
    host_s = max((time.perf_counter() - t0) / reps, 1e-6)
    host_cells_per_s = len(p) * len(t) / host_s

    out = int(min(max(2.0 * latency * host_cells_per_s, 65_536), 2e9))
    _CALIBRATED_MIN_CELLS[key] = out
    from longcalld_torch.utils import log
    log.debug(1, "wfa",
              f"device routing threshold: {out} cells (round trip "
              f"{latency*1e6:.1f} us, host {host_cells_per_s/1e6:.0f} "
              "Mcells/s)")
    return out


# coarse buckets (wfa.py:497-502), kept so batches group as they did
LP_BUCKETS = (256, 1024, 2048, 4096, 32768, 131072)
BATCH_BUCKETS = (64, 512, 2048)
BAND_BUCKETS = (256, 1024, 4096)


def _bucket(n: int, opts=LP_BUCKETS) -> int:
    for o in opts:
        if n <= o:
            return o
    return n


class BatchAligner:
    """Pads pair batches to bucketed shapes, runs the device DP, expands
    the event-compacted walk on host, and falls back to the exact host
    aligner for pairs whose path touches the band edge.  ``device`` is the
    torch device of the kernels (None: cuda:0), resolved at the first
    device batch, so a host-only aligner touches no device."""

    def __init__(self, mismatch: int = 6, gap_open1: int = 6,
                 gap_ext1: int = 2, gap_open2: int = 24, gap_ext2: int = 1,
                 band_pad: int = 64, use_device: bool = True,
                 n_threads: int = 8, device=None,
                 device_min_cells: Optional[int] = None):
        self.x = mismatch
        self.o1, self.e1 = gap_open1, gap_ext1
        self.o2, self.e2 = gap_open2, gap_ext2
        self.band_pad = band_pad
        self.use_device = use_device
        self.n_threads = max(1, int(n_threads))
        self.device = device
        # pairs at or below this many DP cells go to the host C aligner
        # even in device mode; None = calibrate_min_cells at first use
        self.device_min_cells = device_min_cells
        self.n_fallback = 0
        self.n_aligned = 0
        # device dispatch audit: shape groups launched, submit() rounds that
        # reached the device, input bytes shipped host->device
        self.n_dispatch = 0
        self.n_dev_rounds = 0
        self.bytes_h2d = 0
        # DP cells (pattern_len x text_len per pair) by where the pair ran
        self.cells_host = 0
        self.cells_device = 0
        self.cells_memo = 0
        self.cells_retry_host = 0
        # of cells_host, those kept there by the band rule alone (above
        # device_min_cells, band bucket above 512); ns in the host C aligner
        self.cells_host_wide = 0
        self.host_align_ns = 0
        # reference-cost model accumulators (wfa.py:554-562)
        self.model_wf_cells = 0
        self.model_poa_cells = 0
        # (p bytes, t bytes, convention) -> AlnResult: retry waves re-request
        # identical pairs; alignment is deterministic
        self._memo: dict = {}
        self.n_memo_hit = 0

    def memo_clear(self) -> None:
        self._memo.clear()

    def align_many(self, pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                   left_align: bool = True) -> List[AlnResult]:
        return self.collect(self.submit(pairs, left_align))

    def submit(self, pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
               left_align=True):
        """Launch the batch on the device (asynchronously); pair with
        collect().  ``left_align`` is a bool or a per-pair list: both gap
        conventions share device batches (the reversal trick is per pair)."""
        if not pairs:
            return ("empty",)
        self.n_aligned += len(pairs)
        flags = ([bool(left_align)] * len(pairs)
                 if isinstance(left_align, (bool, int)) else
                 [bool(f) for f in left_align])
        keys = [(p.tobytes(), t.tobytes(), f)
                for (p, t), f in zip(pairs, flags)]
        hits = {}
        miss: List[int] = []
        for k, key in enumerate(keys):
            r = self._memo.get(key)
            if r is None:
                miss.append(k)
            else:
                hits[k] = r
                self.n_memo_hit += 1
                self.cells_memo += len(pairs[k][0]) * len(pairs[k][1])
        inner = (self._submit_work([pairs[k] for k in miss],
                                   [flags[k] for k in miss])
                 if miss else ("empty",))
        lens = {k: (len(p), len(t)) for k, (p, t) in enumerate(pairs)}
        return ("memo", len(pairs), keys, hits, miss, inner, lens)

    def collect(self, token) -> List[AlnResult]:
        if token[0] == "empty":
            return []
        _, n_all, keys, hits, miss, inner, lens = token
        sub = self._collect_work(inner)
        out: List[Optional[AlnResult]] = [None] * n_all
        for k, r in hits.items():
            out[k] = _copy_result(r)
            s = abs(int(r.score))
            n, m = lens[k]
            self.model_wf_cells += 5 * s * s
            self.model_poa_cells += n * m // 10
        for k, r in zip(miss, sub):
            out[k] = r
            s = abs(int(r.score))
            n, m = lens[k]
            self.model_wf_cells += 5 * s * s
            self.model_poa_cells += n * m // 10
            if len(self._memo) < 200_000:
                self._memo[keys[k]] = _copy_result(r)
        return out  # type: ignore[return-value]

    def _host_many(self, pairs, flags):
        """One GIL-released C call runs every pair over a worker pool
        (native/affine2p.c)."""
        t0 = time.perf_counter_ns()
        try:
            if len(pairs) > 1:
                out = align_affine2p_many(pairs, flags, self.x, self.o1,
                                          self.e1, self.o2, self.e2,
                                          n_threads=self.n_threads)
                if out is not None:
                    return out
            return [align_affine2p(p, t, self.x, self.o1, self.e1,
                                   self.o2, self.e2, f)
                    for (p, t), f in zip(pairs, flags)]
        finally:
            self.host_align_ns += time.perf_counter_ns() - t0

    def _submit_work(self, pairs, flags):
        if not pairs:
            return ("empty",)
        if not self.use_device:
            for p, t in pairs:
                self.cells_host += len(p) * len(t)
            return ("host", self._host_many(pairs, flags))
        self.device = resolve_device(self.device)
        if self.device_min_cells is None:
            self.device_min_cells = calibrate_min_cells(
                self.device, self.x, self.o1, self.e1, self.o2, self.e2)
        # size-based routing: small pairs run on the exact C aligner; pairs
        # needing a band bucket past 512 also stay on the host (wfa.py:
        # 659-671), so only B = 256 reaches the device from here (the
        # kernels take every B up to 4096: _align_batch reaches them)
        small = []
        for k, (p, t) in enumerate(pairs):
            if len(p) * len(t) <= self.device_min_cells:
                small.append(k)
            elif _bucket(abs(len(t) - len(p)) + 2 * self.band_pad,
                         BAND_BUCKETS) > 512:
                small.append(k)
                self.cells_host_wide += len(p) * len(t)
        if small:
            small_set = set(small)
            big = [k for k in range(len(pairs)) if k not in small_set]
            self.cells_host += sum(len(pairs[k][0]) * len(pairs[k][1])
                                   for k in small)
            # launch the device batches first (asynchronous), then overlap
            # the host C work with the device compute
            inner = (self._submit_work([pairs[k] for k in big],
                                       [flags[k] for k in big])
                     if big else ("empty",))
            host_sub = self._host_many([pairs[k] for k in small],
                                       [flags[k] for k in small])
            return ("split", len(pairs), small, host_sub, big, inner)
        # left-gap convention: reverse inputs, un-reverse outputs (the
        # reference's own trick, align.c:410-414)
        self.cells_device += sum(len(p) * len(t) for p, t in pairs)
        work_pairs = [(p[::-1], t[::-1]) if f else (p, t)
                      for (p, t), f in zip(pairs, flags)]
        # group by pattern-length bucket and band bucket
        groups: dict = {}
        for k, (p, t) in enumerate(work_pairs):
            key = (_bucket(max(1, len(p))),
                   _bucket(abs(len(t) - len(p)) + 2 * self.band_pad,
                           BAND_BUCKETS))
            groups.setdefault(key, []).append(k)
        self.n_dev_rounds += 1
        subs = [(idxs, self._submit_batch([work_pairs[k] for k in idxs]))
                for idxs in groups.values()]
        return ("dev", len(pairs), flags, subs)

    def _collect_work(self, token) -> List[AlnResult]:
        if token[0] == "empty":
            return []
        if token[0] == "host":
            return token[1]
        if token[0] == "split":
            _, n_all, small, host_sub, big, inner = token
            big_sub = self._collect_work(inner)
            out: List[Optional[AlnResult]] = [None] * n_all
            for k, r in zip(small, host_sub):
                out[k] = r
            for k, r in zip(big, big_sub):
                out[k] = r
            return out  # type: ignore[return-value]
        _, n_all, flags, subs = token
        out_all: List[Optional[AlnResult]] = [None] * n_all
        for idxs, handle in subs:
            sub = self._collect_batch(handle)
            for k, r in zip(idxs, sub):
                out_all[k] = r
        out_all = [AlnResult(r.cigar[::-1].copy(),
                             r.pattern_alg[::-1].copy(),
                             r.text_alg[::-1].copy(), r.score)
                   if f else r for r, f in zip(out_all, flags)]
        return out_all  # type: ignore[return-value]

    def _host_exact(self, p, t):
        return align_affine2p(p, t, self.x, self.o1, self.e1, self.o2,
                              self.e2, left_align=False)

    def _align_batch(self, pairs):
        return self._collect_batch(self._submit_batch(pairs))

    def _submit_batch(self, pairs: Sequence[Tuple[np.ndarray, np.ndarray]]):
        n_real = len(pairs)
        real_diff = max(abs(len(t) - len(p)) for p, t in pairs)
        pad = self.band_pad
        B = _bucket(real_diff + 2 * pad, BAND_BUCKETS)
        # pad the batch dimension to a bucket; wide-band groups get small
        # buckets because per-pair cost scales with B*Lp
        buckets = (8, 64, 512) if B >= 1024 else BATCH_BUCKETS
        n_pad = _bucket(n_real, buckets)
        if n_pad > n_real:
            dummy = (np.zeros(1, dtype=np.uint8), np.zeros(1, dtype=np.uint8))
            pairs = list(pairs) + [dummy] * (n_pad - n_real)
        n = len(pairs)
        plens = np.array([len(p) for p, _ in pairs], dtype=np.int32)
        tlens = np.array([len(t) for _, t in pairs], dtype=np.int32)
        Lp = _bucket(int(plens.max()))
        # degenerate/oversize pairs go straight to host (the 1<<17 row cap
        # is the event encoding's row<<14 int32 limit)
        host_mask = (plens == 0) | (tlens == 0) | (B > band.BAND_MAX) \
            | (plens > (1 << 17))
        if host_mask[:n_real].all():
            # nothing for the device (a group wider than the kernels
            # take): every pair takes the exact host aligner
            return (pairs, n_real, None, host_mask, Lp, None, None)
        m_n = tlens - plens
        dlo = np.minimum(0, m_n) - (B - np.abs(m_n)) // 2
        P = np.full((n, Lp), 4, dtype=np.int8)
        # pre-shifted text: Tband[k, c] = T[k, c + dlo_k] (sentinel 127)
        Tband = np.full((n, Lp + B), 127, dtype=np.int8)
        for k, (p, t) in enumerate(pairs):
            P[k, :len(p)] = p
            off = -int(dlo[k])
            end = min(off + len(t), Lp + B)
            if end > off >= 0:
                Tband[k, off:end] = t[:end - off]

        self.n_dispatch += 1
        self.bytes_h2d += P.nbytes + Tband.nbytes + 3 * 4 * n
        with counters.span("device_wait", dir="h2d"):
            args = from_numpy((P, Tband, plens, tlens, dlo.astype(np.int32)),
                              self.device)
        evs_d, meta_d = align_device(*args, B, Lp, self.x, self.o1, self.e1,
                                     self.o2, self.e2, plen_host=plens)
        return (pairs, n_real, dlo, host_mask, Lp, evs_d, meta_d)

    def _collect_batch(self, handle) -> List[AlnResult]:
        pairs, n_real, dlo, host_mask, Lp, evs_d, meta_d = handle
        if meta_d is None:
            return [self._host_exact(p, t) for p, t in pairs[:n_real]]
        with counters.span("device_wait", dir="d2h"):
            meta = meta_d[:n_real].cpu().numpy()
        # meta[:, 3] (n_ev) bounds the walk width; -1 marks unencodable
        # pairs, which take the host fallback anyway
        n_ev = meta[:, 3]
        width = int(n_ev.max(initial=0))
        with counters.span("device_wait", dir="d2h"):
            evs = evs_d[:n_real, :width].cpu().numpy()

        out: List[Optional[AlnResult]] = [None] * n_real
        retry: List[int] = []
        for k in range(n_real):
            if host_mask[k]:
                out[k] = self._host_exact(pairs[k][0], pairs[k][1])
                continue
            res = None
            if n_ev[k] >= 0:
                res = self._reconstruct(evs[k, :n_ev[k]],
                                        int(meta[k, 1]), int(meta[k, 0]),
                                        pairs[k][0], pairs[k][1],
                                        int(dlo[k]), int(meta[k, 2]), Lp)
            if res is None:
                retry.append(k)
            out[k] = res
        if retry:
            # band escape: the exact host C ladder (wfa.py:855-865)
            self.n_fallback += len(retry)
            self.cells_retry_host += sum(len(pairs[k][0]) * len(pairs[k][1])
                                         for k in retry)
            sub = self._host_many([pairs[k] for k in retry],
                                  [False] * len(retry))
            for k, r in zip(retry, sub):
                out[k] = r
        return out  # type: ignore[return-value]

    def _reconstruct(self, ev: np.ndarray, b0: int, score: int,
                     p: np.ndarray, t: np.ndarray, dlo: int, edge_min: int,
                     Lp: int) -> Optional[AlnResult]:
        """Expand the event-compacted walk (row<<14 | op<<12 | n_ins; only
        indel/D rows are events, every other active row is a plain M) into
        the op string; validate consumption; None -> host fallback."""
        n, m = len(p), len(t)
        if score >= BIG:
            return None
        if edge_min < score:
            return None  # an out-of-band path could beat the banded optimum
        j0 = dlo + b0
        if j0 < 0:
            return None
        # event rows index the i = Lp..1 emission order; pair rows are the
        # last n of those (i = n..1)
        ni = np.zeros(n, dtype=np.int64)
        op = np.ones(n, dtype=np.int64)
        if len(ev):
            local = (ev >> 14) - (Lp - n)
            op_e = (ev >> 12) & 3
            if (local < 0).any() or (local >= n).any() or (op_e == 0).any():
                return None  # corrupt walk (event outside the pair's rows)
            ni[local] = ev & 4095
            op[local] = op_e
        # reversed op string: per row n_ins I's then the M/D op
        counts = np.empty(2 * n, dtype=np.int64)
        vals = np.empty(2 * n, dtype=np.int64)
        counts[0::2] = ni
        counts[1::2] = 1
        vals[0::2] = OP_I
        vals[1::2] = np.where(op == 2, OP_D, 0)  # 0 = M placeholder
        rev = np.repeat(vals, counts)
        fwd = rev[::-1]
        if j0 > 0:
            fwd = np.concatenate([np.full(j0, OP_I, dtype=np.int64), fwd])
        consume_p = (fwd == 0) | (fwd == OP_D)
        consume_t = (fwd == 0) | (fwd == OP_I)
        if int(consume_p.sum()) != n or int(consume_t.sum()) != m:
            return None  # inconsistent walk (band corruption)
        ops = fwd.copy()
        mmask = fwd == 0
        if mmask.any():
            pi = np.cumsum(consume_p) - 1
            ti = np.cumsum(consume_t) - 1
            eq = p[pi[mmask]] == t[ti[mmask]]
            ops[mmask] = np.where(eq, OP_EQ, OP_X)
        return _finish(p, t, ops, score)


_ALIGNER_CACHE: dict = {}


def aligner_totals() -> dict:
    """Sum of the routing/audit counters over every aligner of this process
    (DP cells on device vs host vs memo, the host ones kept by the band
    rule, the host C aligner's ns, fallbacks, memo hits), plus the host C
    layer's executed-cell counters."""
    tot = {"cells_device": 0, "cells_host": 0, "cells_memo": 0,
           "n_memo_hit": 0, "n_fallback": 0, "n_dispatch": 0,
           "n_dev_rounds": 0, "bytes_h2d": 0, "model_wf_cells": 0,
           "model_poa_cells": 0, "cells_host_wide": 0, "host_align_ns": 0}
    for al in _ALIGNER_CACHE.values():
        for k in tot:
            tot[k] += int(getattr(al, k, 0))
    from longcalld_torch.ops.affine_align import native_cell_counters
    tot.update(native_cell_counters())
    return tot


def device_min_cells() -> Optional[int]:
    """The routing threshold of this process's device aligners (the
    calibrated one, unless an option set it); None before the first
    device batch."""
    got = [al.device_min_cells for al in _ALIGNER_CACHE.values()
           if al.use_device and al.device_min_cells is not None]
    return max(got) if got else None


def get_aligner(opt, device=None) -> BatchAligner:
    """Shared BatchAligner for the given scoring config (keyed on penalties
    + device flag + threads + routing threshold + device)."""
    use_device = bool(getattr(opt, "use_device", True))
    n_threads = int(getattr(opt, "n_threads", 8))
    key = (opt.mismatch, opt.gap_open1, opt.gap_ext1, opt.gap_open2,
           opt.gap_ext2, use_device, n_threads,
           getattr(opt, "device_min_cells", None),
           None if device is None else str(device))
    if key not in _ALIGNER_CACHE:
        _ALIGNER_CACHE[key] = BatchAligner(
            opt.mismatch, opt.gap_open1, opt.gap_ext1, opt.gap_open2,
            opt.gap_ext2, use_device=use_device, n_threads=n_threads,
            device=device,
            device_min_cells=getattr(opt, "device_min_cells", None))
    return _ALIGNER_CACHE[key]
