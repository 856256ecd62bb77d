"""The readers of the repeat cell's per-layer metrics on hand-made run
contexts: aligner.wide_host_cell_share, aligner.host_s_per_mb and
band_fwd.roofline_share, each against the value worked out by hand, and
None where the program ships none of its counters (as a program before
them does)."""

import numpy as np
import pytest

from perfbench import roofline, trace
from perfbench.spec import Spec

# the pool's counters as the run's process holds them: the sums over the
# workers, and each worker's own (the _w<k> keys), which a reader leaves
POOL = {"aln_cells_host": 600, "aln_cells_device": 400,
        "aln_cells_host_wide": 150,
        "aln_cells_host_wide_w0": 150, "aln_host_align_ns": 3_000_000_000,
        "aln_host_align_ns_w1": 1_000_000_000,
        "aln_band_fwd_256x1024x64_launches": 3,
        "aln_band_fwd_256x1024x64_rows": 90_000,
        "aln_band_fwd_256x1024x64_rows_w2": 50_000,
        "aln_band_fwd_256x256x512_launches": 2,
        "aln_band_fwd_256x256x512_rows": 200_000,
        "aln_band_fwd_launches": 5}


def _events(ns_in, ns_out):
    """band_fwd kernels: ns_in inside the window [1e9, 1e12), ns_out
    (under 1e9) before it; one EM kernel inside."""
    dev = np.array([[0, 2 * 10**9, ns_in], [0, 0, ns_out],
                    [1, 3 * 10**9, 777]],
                   dtype=np.int64)
    return trace.Events(["band_fwd_warp<1,4>", "phase_em_kernel"], dev,
                        np.zeros((0, 3), np.int64))


def _ctx(counters, events=None, mb=4.0, in_process=False, aligner=None):
    return {"events": events, "t0_ns": 10**9, "t1_ns": 10**12,
            "mb_called": mb, "in_process": in_process,
            "aligner": aligner or {}, "counters": counters, "stages": {},
            "band_fwd_launches": []}


def _read(name):
    return Spec().reader(name)


def test_wide_host_cell_share():
    read = _read("aligner.wide_host_cell_share")
    assert read(_ctx(POOL)) == pytest.approx(150 / 1000)
    # no wide pair in the window (its 0 is not shipped): 0, where the
    # program counts the host aligner's time beside it
    no_wide = {k: v for k, v in POOL.items() if "wide" not in k}
    assert read(_ctx(no_wide)) == 0.0
    # before these counters: nothing to read
    before = {k: v for k, v in POOL.items()
              if "wide" not in k and "host_align" not in k}
    assert read(_ctx(before)) is None
    assert read(_ctx({"aln_cells_host_wide": 0})) is None
    assert read(_ctx({}, in_process=True, aligner={
        "cells_host": 10, "cells_device": 30, "cells_host_wide": 4,
        "host_align_ns": 9})) == pytest.approx(0.1)


def test_host_seconds_per_mb():
    read = _read("aligner.host_s_per_mb")
    assert read(_ctx(POOL, mb=4.0)) == pytest.approx(3.0 / 4.0)
    assert read(_ctx({k: v for k, v in POOL.items()
                      if "host_align" not in k})) is None
    assert read(_ctx(POOL, mb=0.0)) is None
    assert read(_ctx({}, in_process=True, mb=2.0,
                     aligner={"host_align_ns": 500_000_000})) == \
        pytest.approx(0.25)


def test_band_fwd_roofline_share_of_shipped_shapes():
    read = _read("band_fwd.roofline_share")
    ns = 4_000_000
    ev = _events(ns, 9_000_000)
    # the launches as the shipped totals give them: a shape's launches x
    # its batch pairs, and its rows
    launches = [(256, 256, 2 * 512, 200_000), (256, 1024, 3 * 64, 90_000)]
    want = roofline.band_fwd_least_seconds(launches) / (ns / 1e9)
    assert read(_ctx(POOL, events=ev)) == pytest.approx(want)
    # by hand: both shapes bound by their int32 operations
    ops = 19 * 256 * (200_000 + 90_000)
    assert want == pytest.approx(ops / roofline.INT32_OPS_PER_S / 4e-3)
    # no shapes shipped, no trace, or no band_fwd time in the window
    shapes = {k: v for k, v in POOL.items()
              if not k.startswith("aln_band_fwd_256x")}
    assert read(_ctx(shapes, events=ev)) is None
    assert read(_ctx(POOL, events=None)) is None
    assert read(_ctx(POOL, events=_events(0, 5))) is None
    # in-process: the run's recorded launches, the shipped shapes unread
    assert read(_ctx(POOL, events=ev, in_process=True)) is None
    ctx = _ctx({}, events=ev, in_process=True)
    ctx["band_fwd_launches"] = launches
    assert read(ctx) == pytest.approx(want)
    assert read(ctx) * 100 == pytest.approx(
        _read("band_fwd_roofline")(ctx))
