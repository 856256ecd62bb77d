"""The port's span recorder (longcalld_torch/utils/counters.py) and the
spans the program records at its layer boundaries.

* A span's record: nesting (the enclosing span's id), the window id
  inherited by child spans, self time = duration less the children's,
  added to the stage table under the span's name; window_span's attrs.
* The stack is per thread: spans opened at once on the threads of a
  ThreadPoolExecutor nest under their own thread's spans only.
* The store keeps at most MAX_SPANS records and counts the rest;
  take_spans / absorb carry records and the count to another store;
  spans_between cuts records to an interval, and refuses after a drop.
* The clock is kineto's: a CPU torch.profiler event of an op inside a
  span lies within the span's start and end.
* A 2-worker host-only pool call (tests/torch_helpers.py's contig, four
  25 kb windows): the run's process holds each window's ``window`` span,
  from two worker pids, with ``load`` and stage children, the ``range``
  spans tagged with their worker, the run's own ``call``, ``plan``,
  ``pool_wait``, ``stitch`` and ``vcf`` spans, and the workers' stage
  times in summary_lines().  The CLI's --profile export
  (cli._start_profiler / _stop_profiler around the same call) writes the
  workers' spans into trace.json under their own pids, and a span nests
  the torch op it encloses there.

Tolerance: exact (ids, counts, names); times by their order only.
"""

import io
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from longcalld_torch import cli
from longcalld_torch.config import CallOpts
from longcalld_torch.core import pipeline
from longcalld_torch.utils import counters

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import build_contig, pool_calls  # noqa: E402

STAGES = ("digar", "sites", "classify")


@pytest.fixture(autouse=True)
def clean_store():
    counters.reset()
    yield
    counters.reset()


def _by_name(recs, name):
    return [s for s in recs if s.name == name]


def test_nesting_self_time_and_window_id():
    with counters.span("outer", window=7, tag="a") as attrs:
        attrs["late"] = 1
        with counters.span("inner"):
            time.sleep(0.02)
            with counters.span("leaf", window=9):
                time.sleep(0.01)
        time.sleep(0.01)
    recs = counters.spans()
    (outer,), (inner,), (leaf,) = (_by_name(recs, n)
                                   for n in ("outer", "inner", "leaf"))
    assert outer.parent == 0 and inner.parent == outer.id
    assert leaf.parent == inner.id
    assert len({outer.id, inner.id, leaf.id}) == 3
    assert outer.id >> 32 == os.getpid() == outer.pid
    # the window id is inherited where not given, and overridden where it is
    assert (outer.window, inner.window, leaf.window) == (7, 7, 9)
    assert outer.attrs == {"tag": "a", "late": 1} and inner.attrs is None
    assert outer.t0 <= inner.t0 <= leaf.t0 <= leaf.t1 <= inner.t1 <= outer.t1
    assert leaf.self_ns == leaf.t1 - leaf.t0
    assert inner.self_ns == (inner.t1 - inner.t0) - (leaf.t1 - leaf.t0)
    assert outer.self_ns == (outer.t1 - outer.t0) - (inner.t1 - inner.t0)
    assert inner.self_ns >= 15_000_000 and outer.self_ns >= 5_000_000
    assert {s.tid for s in recs} == {threading.get_native_id()}
    stage = {ln.split(":")[0]: ln for ln in counters.summary_lines()}
    assert stage["stage inner"].startswith(
        f"stage inner: {inner.self_ns / 1e9:.3f} s over 1 calls")


def test_span_closes_on_error():
    with pytest.raises(ValueError):
        with counters.span("outer"):
            with counters.span("inner"):
                raise ValueError("x")
    outer, = _by_name(counters.spans(), "outer")
    inner, = _by_name(counters.spans(), "inner")
    assert inner.parent == outer.id
    # the stack unwound: a new span is at the top again
    with counters.span("after"):
        pass
    assert _by_name(counters.spans(), "after")[0].parent == 0


def test_window_span_attrs():
    with counters.window_span(3) as attrs:
        attrs["n_reads"] = 5
        with counters.span("load"):
            sum(range(200_000))
    win, = _by_name(counters.spans(), "window")
    load, = _by_name(counters.spans(), "load")
    assert win.window == load.window == 3 and load.parent == win.id
    assert win.attrs["n_reads"] == 5
    assert 0 < win.attrs["cpu_ns"] <= win.t1 - win.t0 + 10_000_000
    q = win.attrs["runq_ns"]
    if os.path.exists("/proc/thread-self/schedstat"):
        assert q is not None and q >= 0
    else:
        assert q is None


def test_thread_local_stacks():
    """Eight threads at once, each opening outer/inner pairs: every inner
    nests under the outer of its own thread and window."""
    barrier = threading.Barrier(8)

    def work(k):
        barrier.wait(timeout=30)
        for j in range(50):
            with counters.span("outer", window=100 * k + j):
                with counters.span("inner"):
                    time.sleep(0.0001)
        return threading.get_native_id()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=8) as ex:
            tids = list(ex.map(work, range(8), timeout=60))
    finally:
        sys.setswitchinterval(old)
    recs = counters.spans()
    outers = {s.id: s for s in _by_name(recs, "outer")}
    inners = _by_name(recs, "inner")
    assert len(outers) == len(inners) == 400
    assert {s.tid for s in outers.values()} == set(tids)
    for s in inners:
        up = outers[s.parent]
        assert (up.tid, up.window) == (s.tid, s.window)
        assert up.t0 <= s.t0 <= s.t1 <= up.t1
    assert all(s.parent == 0 for s in outers.values())


def test_bounded_store_drop_count_and_shipping(monkeypatch):
    monkeypatch.setattr(counters, "MAX_SPANS", 5)
    for k in range(8):
        with counters.span("s", window=k):
            pass
    assert len(counters.spans()) == 5 and counters.dropped() == 3
    assert [s.window for s in counters.spans()] == [0, 1, 2, 3, 4]
    # every closed span's self time reaches the stage table, kept or not
    assert any(ln.startswith("stage s:") and ln.endswith("over 8 calls")
               for ln in counters.summary_lines())
    assert counters.spans_between(0, 2 ** 63) is None
    recs, n = counters.take_spans()
    assert len(recs) == 5 and n == 3
    assert counters.spans() == [] and counters.dropped() == 0
    counters.absorb(recs[:4], 0, worker=1)
    assert [s.worker for s in counters.spans()] == [1] * 4
    counters.absorb(recs, n, worker=2)   # one fits: 4 + 4 more dropped
    assert len(counters.spans()) == 5 and counters.dropped() == 7
    counters.reset()
    assert counters.spans() == [] and counters.dropped() == 0


def test_spans_between_cuts_to_the_interval():
    with counters.span("outer"):
        with counters.span("inner"):
            time.sleep(0.01)
        time.sleep(0.01)
    outer, = _by_name(counters.spans(), "outer")
    inner, = _by_name(counters.spans(), "inner")
    mid = (outer.t0 + outer.t1) // 2
    cut = {s.name: s for s in counters.spans_between(outer.t0, mid)}
    assert cut["outer"].t0 == outer.t0 and cut["outer"].t1 == mid
    assert cut["outer"].self_ns == (outer.self_ns * (mid - outer.t0)
                                    // (outer.t1 - outer.t0))
    if inner.t1 <= mid:
        assert cut["inner"] == inner
    assert counters.spans_between(outer.t1, outer.t1 + 10) == []


def test_span_clock_is_the_profilers():
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with counters.span("mm"):
            torch.mm(x, x)
    sp, = _by_name(counters.spans(), "mm")
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert ev
    for e in ev:
        assert sp.t0 <= e.start_ns() <= e.start_ns() + e.duration_ns() \
            <= sp.t1


@pytest.fixture(scope="module")
def contig(tmp_path_factory):
    return build_contig(tmp_path_factory.mktemp("torch_spans"), 21,
                        100_000)[:2]


@pytest.fixture(scope="module")
def pool_run(contig, tmp_path_factory):
    """A host-only call on 2 workers (four 25 kb windows) under the CLI's
    profiler; returns (the run's spans, its stage lines, trace.json)."""
    counters.reset()
    fa, bam = contig
    opt = CallOpts.hifi(ref_fa_fn=fa, in_bam_fns=[bam], window_size=25_000,
                        host_procs=2, n_threads=2, use_device=False)
    d = tmp_path_factory.mktemp("profile")
    prof = cli._start_profiler()
    with pool_calls(pipeline) as calls:
        with counters.span("marker"):
            torch.mm(torch.ones(64, 64), torch.ones(64, 64))
        pipeline.run_call(opt, io.StringIO(), "t")
    path = cli._stop_profiler(prof, str(d))
    assert calls == [(4, 2)]
    with open(path) as fh:
        trace = json.load(fh)
    out = counters.spans(), counters.summary_lines(), trace
    counters.reset()
    return out


def test_pool_call_ships_every_windows_spans(pool_run):
    recs, _, _ = pool_run
    me = os.getpid()
    wins = _by_name(recs, "window")
    assert sorted(s.window for s in wins) == [0, 1, 2, 3]
    assert len({s.pid for s in wins}) == 2 and me not in {s.pid for s in wins}
    ranges = {s.id: s for s in _by_name(recs, "range")}
    assert {s.worker for s in ranges.values()} == {0, 1}
    for w in wins:
        assert ranges[w.parent].pid == w.pid and w.worker in (0, 1)
        assert w.attrs["n_reads"] > 0 and w.attrs["cpu_ns"] > 0
        kids = {s.name for s in recs if s.parent == w.id}
        assert {"load", "genotype", *STAGES} <= kids, kids
        assert all(s.window == w.window for s in recs
                   if s.parent == w.id)
    mine = {s.name for s in recs if s.pid == me}
    assert {"call", "plan", "pool_wait", "vcf", "stitch"} <= mine, mine
    call, = _by_name(recs, "call")
    for s in recs:
        if s.pid == me and s.name != "marker":
            assert call.t0 <= s.t0 <= s.t1 <= call.t1


def test_pool_call_summary_shows_worker_stages(pool_run):
    recs, lines, _ = pool_run
    stage = {ln.split(":")[0][len("stage "):]: float(ln.split()[2])
             for ln in lines if ln.startswith("stage ")}
    for name in ("window", "load", "genotype", "range") + STAGES:
        want = sum(s.self_ns for s in recs if s.name == name) / 1e9
        assert stage[name] == pytest.approx(want, abs=2e-3), name
    assert stage["digar"] > 0


def test_profile_writes_worker_spans_and_nests_ops(pool_run):
    recs, _, trace = pool_run
    spans = [e for e in trace["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "span"]
    assert len(spans) == len(recs)
    wins = [e for e in spans if e["name"] == "window"]
    assert {e["pid"] for e in wins} == {s.pid for s in recs
                                        if s.name == "window"}
    named = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert all(named[e["pid"]].startswith("pool worker ") for e in wins)
    marker, = [e for e in spans if e["name"] == "marker"]
    mm = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"
          and e.get("ph") == "X" and e.get("pid") == marker["pid"]]
    assert mm
    inside = [e for e in mm if marker["ts"] - 1e-3 <= e["ts"]
              and e["ts"] + e["dur"] <= marker["ts"] + marker["dur"] + 1e-3]
    assert len(inside) == 1, (marker, mm)
