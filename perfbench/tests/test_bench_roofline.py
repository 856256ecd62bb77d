"""The roofline arithmetic and the trace reductions on hand-made launch
lists and event intervals."""

import numpy as np
import pytest

from perfbench import roofline, trace


def test_peaks():
    assert roofline.INT32_OPS_PER_S == pytest.approx(132 * 64 * 1.98e9)
    assert roofline.HBM_BYTES_PER_S == 3.35e12


def test_band_fwd_launch_counts():
    ops, nbytes = roofline.band_fwd_launch(256, 1024, 64, 40_000)
    assert ops == 19 * 256 * 40_000
    read = 40_000 + (40_000 + 256 * 64) + 12 * 64
    written = 256 * (40_000 + 64) + 24 * 64
    assert nbytes == read + written
    # 1.9e8 ops over 1.67e13/s binds over 1.2e7 bytes over 3.35e12/s
    assert roofline.least_seconds(ops, nbytes) == pytest.approx(
        ops / roofline.INT32_OPS_PER_S)


def test_least_seconds_sums_launches_and_takes_the_larger_bound():
    launches = [(256, 256, 64, 10_000), (256, 1024, 512, 300_000)]
    want = sum(max(o / roofline.INT32_OPS_PER_S,
                   b / roofline.HBM_BYTES_PER_S)
               for o, b in (roofline.band_fwd_launch(*l) for l in launches))
    assert roofline.band_fwd_least_seconds(launches) == pytest.approx(want)
    assert roofline.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)


def _events():
    names = ["band_fwd_warp<1>", "phase_em_kernel", "Memcpy HtoD",
             "aten::copy_", "python_stage"]
    dev = np.array([[0, 100, 50], [0, 120, 50], [1, 300, 100],
                    [2, 390, 20], [1, 900, 200]], dtype=np.int64)
    host = np.array([[3, 150, 200], [4, 500, 380]], dtype=np.int64)
    return trace.Events(names, dev, host)


def test_union_and_busy():
    u = trace.union(np.array([[5, 9], [0, 3], [2, 4], [9, 10]]))
    assert u.tolist() == [[0, 4], [5, 10]]
    ev = _events()
    # [100, 170) + [300, 410) + [900, 1000) clipped to [0, 1000)
    assert trace.busy_ns(ev, 0, 1000) == 70 + 110 + 100
    assert trace.busy_ns(ev, 150, 350) == 20 + 50


def test_kernel_time_and_breakdown():
    ev = _events()
    assert trace.kernel_ns(ev, 0, 2000, "band_fwd") == 100
    assert trace.kernel_ns(ev, 0, 1000, "phase_em") == 100 + 100
    b = trace.breakdown(ev, 0, 1000)
    assert b["device_ops"][0] == ["phase_em_kernel", 200 / 1e9]
    gaps = b["idle_gaps"]
    # the gaps: [410, 900) 490 ns, [170, 300) 130, [0, 100) 100
    assert [g[1] for g in gaps] == [490 / 1e9, 130 / 1e9, 100 / 1e9]
    assert gaps[0][0] == "host: python_stage"
    assert gaps[1][0] == "host: aten::copy_"
    assert gaps[2][0] == "host: no profiled operation"


def test_merge_remaps_names(tmp_path):
    a = _events()
    b = trace.Events(["phase_em_kernel", "x"],
                     np.array([[1, 2000, 10], [0, 2100, 5]]),
                     np.zeros((0, 3), np.int64))
    b.save(str(tmp_path / "b.npz"))
    m = trace.Events.merge([a, trace.Events.load(str(tmp_path / "b.npz"))])
    assert trace.kernel_ns(m, 0, 3000, "phase_em") == 300 + 5
    assert trace.kernel_ns(m, 0, 3000, "x") == 10
