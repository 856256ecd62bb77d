"""Banded gap-affine-2p DP: forward pass and traceback walk.

Counterpart of longcalld_tpu/ops/pallas_band.py (the two Pallas kernels,
banded_dp_pallas :285-341 and backward_resolve_pallas :451-495) and of
their lax twins in longcalld_tpu/ops/wfa.py (_banded_dp :53-179,
_backward_resolve :403-494).  Same contracts, bit for bit.
``backward_events`` is the walk with the rest of the JAX package's device
program after it (wfa.py:_align_device_pallas :359-387: _compact_events
:188-239, the score and the meta row) done in the walk kernel's epilogue.

Each entry point has two forms:
* a hand-written CUDA kernel (csrc/band_fwd.cu, csrc/band_bwd.cu), built by
  utils/kbuild.py, launched for CUDA tensors at every band width the
  Pallas kernels take: B a multiple of 128 from 128 to 4096 (the
  aligner's routing sends only the B = 256 bucket from ``submit``;
  ``BatchAligner._align_batch`` reaches the others).  The forward kernel
  has two designs, configured by ``band_fwd_config``: warps per pair for
  B <= 512; above, one CTA per pair, or at B 2048 and 4096, when the
  pairs leave SMs idle, a pair split over the CTAs of a thread-block
  cluster (one seam exchange a row);
* a plain PyTorch version (``*_plain``), taken for CPU tensors only; it
  takes any B.
A CUDA tensor never falls back to the plain version: the wrapper launches
the kernel or raises (``ValueError`` for any other width, before the
launch).  Each launch adds one to ``launch_counts()``; both traceback
entries count under ``band_bwd``.

Source notes (what each kernel replaces, what bounds it on the card and
what its design does about it) head the .cu files.
"""

from __future__ import annotations

import collections
import threading

import torch

from longcalld_torch.utils import kbuild

BIG = 1 << 28
# the band widths of the CUDA kernels: multiples of BAND_STEP up to BAND_MAX
BAND_STEP, BAND_MAX = 128, 4096
OFF = -1                      # traceback position that fell off the band
OFF_LEFT, OFF_RIGHT = 1, 2    # the edge a plain walk fell off (off_edge)
# band_fwd's warp design (B <= 512): the warps-per-pair counts each width
# is built for (columns per lane C = B / (32 * wpp)), the ones that were
# fastest at some batch on the H100 (PERF.md)
WARP_CONFIGS = {128: (1,), 256: (1, 4), 384: (3,), 512: (1, 4)}
MAX_GROUP_WARPS = 8           # warps of one CTA of the warp design
# band_fwd's wide design (B > 512): the (columns per lane, CTAs per pair)
# each compiled width is built for (csrc/band_fwd.cu:launch_wide_cfg), the
# ones that were fastest at some batch on the H100 (PERF.md); every other
# width runs WIDE_RUNTIME, B read at run time
WIDE_CONFIGS = {1024: ((8, 1),), 2048: ((8, 1), (4, 8)),
                4096: ((8, 1), (8, 2), (4, 8))}
WIDE_RUNTIME = ((4, 1),)

_count_lock = threading.Lock()
_launches = {"band_fwd": 0, "band_bwd": 0}
# launches by (B, Lp, batch), beside the totals
_shapes = {name: collections.Counter() for name in _launches}
# band_fwd's real rows (the pairs' pattern lengths summed) by (B, Lp,
# batch), as the caller counts them (wfa.align_device)
_fwd_rows = collections.Counter()


def launch_counts() -> dict:
    with _count_lock:
        return dict(_launches)


def launch_shapes() -> dict:
    """{kernel: {"B,Lp,batch": launches}} since the last reset."""
    with _count_lock:
        return {name: {",".join(map(str, k)): n for k, n in sorted(c.items())}
                for name, c in _shapes.items()}


def fwd_rows() -> dict:
    """{(B, Lp, batch): (kernel launches, real rows)} of band_fwd since
    the last reset.  Rows are those ``count_fwd_rows`` was given, on CUDA
    tensors and CPU tensors alike; launches are the kernel's alone."""
    with _count_lock:
        shapes = _shapes["band_fwd"]
        return {k: (shapes.get(k, 0), _fwd_rows.get(k, 0))
                for k in sorted(set(shapes) | set(_fwd_rows))}


def reset_launch_counts() -> None:
    with _count_lock:
        for k in _launches:
            _launches[k] = 0
            _shapes[k].clear()
        _fwd_rows.clear()


def _count(name: str, shape) -> None:
    with _count_lock:
        _launches[name] += 1
        _shapes[name][shape] += 1


def count_fwd_rows(shape, rows: int) -> None:
    """Add a band_fwd call's real rows (its plen summed on the host, no
    read of the device) under its (B, Lp, batch)."""
    with _count_lock:
        _fwd_rows[shape] += rows


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_band(B: int) -> None:
    if not (BAND_STEP <= B <= BAND_MAX and B % BAND_STEP == 0):
        raise ValueError(f"the CUDA band kernels take B a multiple of "
                         f"{BAND_STEP} from {BAND_STEP} to {BAND_MAX}, "
                         f"got B={B}")


def wide_configs(B: int):
    """The (columns per lane, CTAs per pair) band_fwd takes at B > 512."""
    return WIDE_CONFIGS.get(B, WIDE_RUNTIME)


def _check_config(B: int, a: int, b: int) -> None:
    if B > 512:
        if (a, b) not in wide_configs(B):
            raise ValueError(f"band_fwd has no configuration of {a} columns "
                             f"per lane and {b} CTAs per pair at B={B}")
    elif not (a in WARP_CONFIGS[B] and 1 <= b
              and a * b <= MAX_GROUP_WARPS):
        raise ValueError(f"band_fwd has no configuration of {a} warps per "
                         f"pair and {b} pairs per CTA at B={B}")


# ---------------------------------------------------------------- forward


def band_fwd_config(B: int, batch: int, sms: int = 132):
    """The configuration of band_fwd at this width and batch on a card of
    ``sms`` SMs.

    B <= 512: (warps per pair, pairs per CTA).  Once the pairs outnumber
    the SMs, one warp per pair (no barrier in the row loop); below, each
    pair is split over 4 warps at B 256 and 512, so that the
    sub-partitions of its SM share it.  B 384 always takes 3 warps (one
    would need C = 12 columns per lane), B 128 always one.  Then as many
    pairs per CTA as keep at least one CTA on every SM.

    B > 512: (columns per lane, CTAs per pair).  The largest cluster the
    width is built for whose CTAs (batch x CTAs per pair) fit on the SMs
    in one wave, else one CTA per pair (8 columns a lane).  Widths
    without an instantiation run WIDE_RUNTIME.  On the H100 these rules
    took the fastest configuration at every shape timed (PERF.md, PR 5
    and PR 9)."""
    if B > 512:
        return _wide_config(B, batch, sms)
    wpps = WARP_CONFIGS[B]
    wpp = max(wpps) if batch <= sms else min(wpps)
    ppc = 1
    for p in (8, 4, 2):
        if p * wpp <= MAX_GROUP_WARPS and -(-batch // p) >= sms:
            ppc = p
            break
    return wpp, ppc


def _wide_config(B: int, batch: int, sms: int):
    # the largest cluster whose CTAs all fit on the SMs at once, else one
    # CTA per pair: a split pays only on SMs that would idle, and in a
    # second wave it would pay the seam exchange's latency a row for none
    cfgs = wide_configs(B)
    return max((c for c in cfgs if c[1] == 1 or batch * c[1] <= sms),
               key=lambda c: c[1])


def sm_count(dev) -> int:
    """The SM count of a CUDA device."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def banded_dp(P, Tband, plen, tlen, dlo, B: int, Lp: int, x: int, o1: int,
              e1: int, o2: int, e2: int, config=None):
    """Forward banded DP.  Returns (tbs (Lp+1, batch, B) uint8, finals
    (batch, 5) int32 in PERM order [I1, I2, D1, D2, M], edge_min (batch,)
    int32), exactly ops/wfa.py:_banded_dp's outputs.  ``config`` (a pair
    of ints as band_fwd_config gives) overrides band_fwd_config on CUDA
    tensors."""
    if P.device.type == "cpu":
        return banded_dp_plain(P, Tband, plen, tlen, dlo, B, Lp, x, o1, e1,
                               o2, e2)
    if P.device.type != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    _check_band(B)
    batch, dev = P.shape[0], P.device
    _check(P, "P", torch.int8, (batch, Lp), dev)
    _check(Tband, "Tband", torch.int8, (batch, Lp + B), dev)
    for name, t in (("plen", plen), ("tlen", tlen), ("dlo", dlo)):
        _check(t, name, torch.int32, (batch,), dev)
    cfg0, cfg1 = (config if config is not None
                  else band_fwd_config(B, batch, sm_count(dev)))
    _check_config(B, cfg0, cfg1)
    tbs = torch.empty((Lp + 1, batch, B), dtype=torch.uint8, device=dev)
    finals = torch.empty((batch, 5), dtype=torch.int32, device=dev)
    edge_min = torch.empty((batch,), dtype=torch.int32, device=dev)
    lib = kbuild.load()
    with torch.cuda.device(dev):
        err = lib.lcd_band_fwd(
            P.data_ptr(), Tband.data_ptr(), plen.data_ptr(), tlen.data_ptr(),
            dlo.data_ptr(), tbs.data_ptr(), finals.data_ptr(),
            edge_min.data_ptr(), batch, B, Lp, x, o1, e1, o2, e2, cfg0, cfg1,
            torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "band_fwd")
    _count("band_fwd", (B, Lp, batch))
    return tbs, finals, edge_min


def banded_dp_plain(P, Tband, plen, tlen, dlo, B: int, Lp: int, x: int,
                    o1: int, e1: int, o2: int, e2: int):
    """Plain PyTorch forward DP: one iteration per row over (batch, B)
    planes, the insertion prefix-min through torch.cummin."""
    dev = P.device
    batch = P.shape[0]
    i32 = torch.int32
    bb = torch.arange(B, dtype=i32, device=dev)[None, :]
    plen_c, tlen_c, dlo_c = plen[:, None], tlen[:, None], dlo[:, None]
    big = torch.full((batch, B), BIG, dtype=i32, device=dev)
    zero = torch.zeros_like(big)

    j0 = dlo_c + bb                                   # row 0: j = dlo + b
    M = torch.where(j0 == 0, zero, big)
    I1 = torch.where(j0 > 0, o1 + e1 * j0, big)
    I2 = torch.where(j0 > 0, o2 + e2 * j0, big)
    D1, D2 = big, big
    tbs = torch.empty((Lp + 1, batch, B), dtype=torch.uint8, device=dev)
    tbs[0] = torch.where(j0 > 1, 24, 0).to(torch.uint8)

    b_final = tlen - plen - dlo
    min_e = min(e1, e2)
    bl = b_final.abs() * min_e
    br = ((B - 1) - b_final).abs() * min_e
    at_b_final = bb == b_final[:, None]
    edge_min = torch.minimum(
        torch.minimum(torch.minimum(M[:, 0], I1[:, 0]), I2[:, 0]) + bl,
        torch.minimum(torch.minimum(M[:, -1], I1[:, -1]), I2[:, -1]) + br)
    # plen == 0 pairs finish on row 0
    finals = torch.full((batch, 5), BIG, dtype=i32, device=dev)
    row0 = (plen == 0)[:, None] & at_b_final
    for col, v in ((0, I1), (1, I2), (4, M)):
        finals[:, col] = torch.where(row0, v, big).amin(dim=1)

    bbe1, bbe2 = bb * e1, bb * e2

    def shl(a):          # a'[b] = a[b+1], BIG past the band
        return torch.cat([a[:, 1:], big[:, :1]], dim=1)

    def excl_prefix_min(a):
        run = torch.cummin(a, dim=1).values
        return torch.cat([big[:, :1], run[:, :-1]], dim=1)

    for i in range(1, Lp + 1):
        jv = i + dlo_c + bb
        valid = (jv >= 1) & (jv <= tlen_c) & (i <= plen_c)
        eq = P[:, i - 1:i] == Tband[:, i - 1:i - 1 + B]
        sub = torch.where(valid, torch.where(eq, 0, x), BIG).to(i32)

        # M from the diagonal (same b), first minimum in PERM order
        best = I1
        src = torch.ones_like(big)
        for v, s in ((I2, 2), (D1, 3), (D2, 4), (M, 0)):
            src = torch.where(v < best, s, src)
            best = torch.minimum(best, v)
        nM = (best + sub).clamp_max(BIG)

        Ms = shl(M)
        open1 = (Ms + (o1 + e1)).clamp_max(BIG)
        ext1 = (shl(D1) + e1).clamp_max(BIG)
        open2 = (Ms + (o2 + e2)).clamp_max(BIG)
        ext2 = (shl(D2) + e2).clamp_max(BIG)
        nD1 = torch.minimum(open1, ext1)
        nD2 = torch.minimum(open2, ext2)

        nI1 = (excl_prefix_min(nM - bbe1) + bbe1 + o1).clamp_max(BIG)
        nI2 = (excl_prefix_min(nM - bbe2) + bbe2 + o2).clamp_max(BIG)
        nMl = torch.cat([big[:, :1], nM[:, :-1]], dim=1)   # nM at b-1
        adj1 = (nMl + (o1 + e1)).clamp_max(BIG)
        adj2 = (nMl + (o2 + e2)).clamp_max(BIG)

        tb = (src | ((nI1 < adj1).to(i32) << 3) | ((nI2 < adj2).to(i32) << 4)
              | ((ext1 < open1).to(i32) << 5)
              | ((ext2 < open2).to(i32) << 6))
        tbs[i] = tb.to(torch.uint8)

        at_final = (i == plen_c) & at_b_final
        if bool(at_final.any()):
            for col, v in enumerate((nI1, nI2, nD1, nD2, nM)):
                finals[:, col] = torch.minimum(
                    finals[:, col], torch.where(at_final, v, big).amin(dim=1))

        planes = torch.stack([nM, nI1, nI2, nD1, nD2])
        act = torch.where(i <= plen, 0, BIG)
        edge = (torch.minimum(planes[:, :, 0].amin(dim=0) + bl,
                              planes[:, :, -1].amin(dim=0) + br)
                + act).clamp_max(BIG)
        edge_min = torch.minimum(edge_min, edge)
        M, I1, I2, D1, D2 = nM, nI1, nI2, nD1, nD2
    return tbs, finals, edge_min.to(i32)


# -------------------------------------------------------------- traceback


def backward_resolve(tbs, plen, tlen, dlo, finals, B: int, Lp: int,
                     reloads=None):
    """Traceback walk.  Returns (packed (Lp, batch) int32 = op<<14 |
    min(n_ins, 16383) for rows Lp..1, b0 (batch,) int32), exactly
    backward_resolve_pallas's outputs.  ``reloads``, a (1,) int32 tensor
    on the same CUDA device, gets the kernel's synchronous window reloads
    added to it (tools/time_band_bwd.py); the plain version has no
    windows and leaves it as it is."""
    if tbs.device.type == "cpu":
        packed, b0, _ = backward_resolve_plain(tbs, plen, tlen, dlo, finals,
                                               B, Lp)
        return packed, b0
    if tbs.device.type != "cuda":
        raise ValueError(f"unsupported device {tbs.device}")
    _check_band(B)
    batch, dev = tbs.shape[1], tbs.device
    _check(tbs, "tbs", torch.uint8, (Lp + 1, batch, B), dev)
    for name, t in (("plen", plen), ("tlen", tlen), ("dlo", dlo)):
        _check(t, name, torch.int32, (batch,), dev)
    _check(finals, "finals", torch.int32, (batch, 5), dev)
    if tbs.data_ptr() % 16:
        raise ValueError("tbs must be 16-byte aligned (the kernel copies "
                         "16-byte chunks of it)")
    if reloads is not None:
        _check(reloads, "reloads", torch.int32, (1,), dev)
    packed = torch.empty((Lp, batch), dtype=torch.int32, device=dev)
    b0 = torch.empty((batch,), dtype=torch.int32, device=dev)
    lib = kbuild.load()
    with torch.cuda.device(dev):
        err = lib.lcd_band_bwd(
            tbs.data_ptr(), plen.data_ptr(), tlen.data_ptr(), dlo.data_ptr(),
            finals.data_ptr(), packed.data_ptr(), b0.data_ptr(),
            None if reloads is None else reloads.data_ptr(), batch, B, Lp,
            torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "band_bwd")
    _count("band_bwd", (B, Lp, batch))
    return packed, b0


def backward_resolve_plain(tbs, plen, tlen, dlo, finals, B: int, Lp: int):
    """Plain PyTorch traceback: the CUDA kernel's scalar walk, vectorized
    over the batch (position and state per pair, ``OFF`` once the position
    has fallen off the band).  Returns (packed, b0, off_edge (batch,)
    int8: 0 for a walk that stayed in the band, OFF_LEFT for one that fell
    off column 0 (an I chain with no stop above it), OFF_RIGHT for one
    that stepped past column B-1 (a D step))."""
    dev = tbs.device
    batch = tbs.shape[1]
    i64 = torch.int64
    bb = torch.arange(B, dtype=i64, device=dev)[None, :]
    plen = plen.to(i64)
    b_final = (tlen - plen - dlo).to(i64)
    in_band = (b_final >= 0) & (b_final < B)
    first = torch.zeros(batch, dtype=i64, device=dev)
    fmin = finals[:, 0]
    for c in range(1, 5):                 # first minimum, PERM order
        lt = finals[:, c] < fmin
        first = torch.where(lt, c, first)
        fmin = torch.where(lt, finals[:, c], fmin)
    s_final = (first + 1) % 5             # PERM -> canonical state id

    pos = torch.full((batch,), OFF, dtype=i64, device=dev)
    s = torch.zeros(batch, dtype=i64, device=dev)
    off_edge = torch.zeros(batch, dtype=torch.int8, device=dev)
    packed = torch.zeros((Lp, batch), dtype=torch.int32, device=dev)

    def under(row, p):                    # byte under position p (0 if OFF)
        v = row.gather(1, p.clamp_min(0)[:, None])[:, 0]
        return torch.where(p == OFF, 0, v)

    for r in range(Lp):
        i = Lp - r
        act = i <= plen
        if not bool(act.any()):
            continue
        init = i == plen
        pos = torch.where(init, torch.where(in_band, b_final, OFF), pos)
        s = torch.where(init, s_final, s)
        row = tbs[i].to(i64)
        is_I = (s == 1) | (s == 2)
        is_D = (s == 3) | (s == 4)

        # I: highest b <= pos whose extension bit is 0; none -> stop at 0
        ext_I = (row >> torch.where(s == 1, 3, 4)[:, None]) & 1
        hit = (bb <= pos[:, None]) & (ext_I == 0)
        stop = torch.where(hit, bb, OFF).amax(dim=1)
        n_ins_I = torch.where(pos == OFF, 1, pos - stop.clamp_min(0) + 1)
        pos_I = torch.where(stop == OFF, OFF, stop - 1)
        pos1 = torch.where(is_I, pos_I, pos)
        src = under(row, pos1) & 7

        # D: the extension bit decides D chain vs back to M
        ext_D = (under(row, pos) >> torch.where(s == 3, 5, 6)) & 1
        s_D = torch.where(ext_D > 0, s, 0)
        pos_D = torch.where((pos == OFF) | (pos + 1 >= B), OFF, pos + 1)

        new_pos = torch.where(is_D, pos_D, pos1)
        fell = act & (pos != OFF) & (new_pos == OFF)
        off_edge = torch.where(fell, torch.where(is_D, OFF_RIGHT, OFF_LEFT),
                               off_edge).to(torch.int8)
        pos = torch.where(act, new_pos, pos)
        s = torch.where(act, torch.where(is_D, s_D, src), s)
        n_ins = torch.where(act & is_I, n_ins_I, 0)
        op = torch.where(act, torch.where(is_D, 2, 1), 0)
        packed[r] = ((op << 14) | n_ins.clamp_max((1 << 14) - 1)).to(
            torch.int32)
    b0 = torch.where(pos == OFF, 0, pos).to(torch.int32)
    return packed, b0, off_edge


# ----------------------------------------------------------------- events


def event_k(Lp: int) -> int:
    """Event-buffer width of the compacted traceback (wfa.py:182-185)."""
    return max(512, Lp // 8)


def compact_events(nins: torch.Tensor, ops: torch.Tensor, Lp: int):
    """Run-length compaction of the traceback walk: the event rows (op = D
    or n_ins > 0) of each pair, in row order, encoded row<<14 | op<<12 |
    min(n_ins, 4095) into a (batch, K) int32 array.  Returns (evs, n_ev)
    with n_ev = -1 for pairs that cannot be encoded (n_ins > 4095 or more
    than K events); their first K events are still written, as in
    wfa.py:_compact_events."""
    K = event_k(Lp)
    rows, batch = nins.shape
    i32 = torch.int32
    ops32 = ops.to(i32)
    ev = (ops32 == 2) | (nins > 0)
    row_ids = torch.arange(rows, dtype=i32, device=nins.device)[:, None]
    val = (row_ids << 14) | (ops32 << 12) | nins.clamp_max(4095).to(i32)
    ordv = torch.cumsum(ev.to(i32), dim=0, dtype=i32) - 1
    n_ev = ev.sum(dim=0, dtype=i32)
    bad = (nins > 4095).any(dim=0) | (n_ev > K)
    # non-events and events past K land in a spill column that is dropped
    slot = torch.where(ev & (ordv < K), ordv, K).to(torch.int64)
    evs = torch.zeros((batch, K + 1), dtype=i32, device=nins.device)
    evs.scatter_(1, slot.t(), val.t())
    return evs[:, :K].contiguous(), torch.where(bad, -1, n_ev)


def backward_events(tbs, plen, tlen, dlo, finals, edge_min, B: int, Lp: int,
                    out=None, reloads=None):
    """Traceback walk and its event compaction in one launch.  Returns
    (evs (batch, K) int32, K = event_k(Lp), meta (batch, 4) int32 =
    [score, b0, edge_min, n_ev]), exactly ops/wfa.py:_align_device's
    outputs after the forward DP (backward_events_plain spells them out).
    ``out``, a pair of contiguous int32 tensors of those shapes (rows of
    larger ones), receives them instead of new tensors; ``reloads`` is as
    in backward_resolve."""
    K = event_k(Lp)
    if tbs.device.type == "cpu":
        evs, meta = backward_events_plain(tbs, plen, tlen, dlo, finals,
                                          edge_min, B, Lp)
        if out is None:
            return evs, meta
        out[0].copy_(evs)
        out[1].copy_(meta)
        return out
    if tbs.device.type != "cuda":
        raise ValueError(f"unsupported device {tbs.device}")
    _check_band(B)
    batch, dev = tbs.shape[1], tbs.device
    _check(tbs, "tbs", torch.uint8, (Lp + 1, batch, B), dev)
    for name, t in (("plen", plen), ("tlen", tlen), ("dlo", dlo),
                    ("edge_min", edge_min)):
        _check(t, name, torch.int32, (batch,), dev)
    _check(finals, "finals", torch.int32, (batch, 5), dev)
    if tbs.data_ptr() % 16:
        raise ValueError("tbs must be 16-byte aligned (the kernel copies "
                         "16-byte chunks of it)")
    if reloads is not None:
        _check(reloads, "reloads", torch.int32, (1,), dev)
    if out is None:
        out = (torch.empty((batch, K), dtype=torch.int32, device=dev),
               torch.empty((batch, 4), dtype=torch.int32, device=dev))
    evs, meta = out
    _check(evs, "evs", torch.int32, (batch, K), dev)
    _check(meta, "meta", torch.int32, (batch, 4), dev)
    lib = kbuild.load()
    with torch.cuda.device(dev):
        err = lib.lcd_band_bwd_events(
            tbs.data_ptr(), plen.data_ptr(), tlen.data_ptr(), dlo.data_ptr(),
            finals.data_ptr(), edge_min.data_ptr(), evs.data_ptr(),
            meta.data_ptr(), None if reloads is None else reloads.data_ptr(),
            batch, B, Lp, K, torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "band_bwd")
    _count("band_bwd", (B, Lp, batch))
    return evs, meta


def backward_events_plain(tbs, plen, tlen, dlo, finals, edge_min, B: int,
                          Lp: int):
    """Plain PyTorch form of backward_events: backward_resolve_plain, then
    compact_events over its walk and the meta row, as wfa.py:_align_device
    chains _backward_resolve, _compact_events and the stack."""
    packed, b0, _ = backward_resolve_plain(tbs, plen, tlen, dlo, finals, B,
                                           Lp)
    evs, n_ev = compact_events(packed & ((1 << 14) - 1), packed >> 14, Lp)
    meta = torch.stack([finals.amin(dim=1), b0, edge_min, n_ev], dim=1)
    return evs, meta.to(torch.int32)
