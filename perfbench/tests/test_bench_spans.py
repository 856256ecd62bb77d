"""The six readers of the program's spans (perfbench/metrics/pool.*,
load.*, reads.*, noisy.*, device.*): each on a hand-built span list
against its value worked out by hand, None where its spans are missing
or one was dropped, None on a program without the span recorder (the
parent of the change that added it), and all six read by a traced tiny
run of the pool cell on the CPU."""

import pytest

from longcalld_torch.utils import counters
from perfbench import run
from perfbench.spec import Spec
from perfbench.tests.test_bench_harness import TINY, TinySpec, tiny_constants

READERS = ("pool.busy_share", "pool.offcore_share", "load.s_per_mb",
           "reads.s_per_mb", "noisy.s_per_mb", "device.wait_s_per_mb")
U = 1_000_000                       # one ms in ns
T0, T1 = 1000 * U, 2000 * U         # the run's window
MB = 2.0


def _span(name, a, b, pid, self_u=None, sid=0, parent=0, **attrs):
    return counters.Span(name, a * U, b * U, sid, parent, 0, pid, pid,
                         (b - a if self_u is None else self_u) * U,
                         attrs or None)


# (span, worker): the window [1000, 2000) ms; worker 0 is pid 11, worker 1
# pid 12, the run's own process pid 10
SPANS = [
    # pid 11: [1000, 1400) + [1500, 2000) of the window = 900
    (_span("range", 900, 1400, 11), 0),
    (_span("range", 1500, 2100, 11), 0),
    # pid 12: the union [1100, 1600) = 500
    (_span("range", 1100, 1300, 12), 1),
    (_span("range", 1200, 1600, 12), 1),
    # on a core 300 of 400, 150 of 200, and half of [1900, 2100): 80 of
    # 100; one window outside
    (_span("window", 1000, 1400, 11, runq_ns=None, cpu_ns=300 * U), 0),
    (_span("window", 1100, 1300, 12, runq_ns=None, cpu_ns=150 * U), 1),
    (_span("window", 1900, 2100, 12, runq_ns=None, cpu_ns=160 * U), 1),
    (_span("window", 2100, 2200, 12, runq_ns=None, cpu_ns=99 * U), 1),
    # load: 100 + half of 100
    (_span("load", 1000, 1100, 11), 0),
    (_span("load", 1950, 2050, 12), 1),
    (_span("load", 500, 600, 12), 1),
    # read stages: 30 + 20 + 10 + 5 (self times); phase is not one
    (_span("digar", 1100, 1140, 11, self_u=30), 0),
    (_span("sites", 1140, 1160, 11), 0),
    (_span("classify", 1160, 1170, 11), 0),
    (_span("profile", 1170, 1175, 11), 0),
    (_span("phase", 1175, 1225, 11), 0),
    # noisy: 100 less its 20 of device_wait
    (_span("noisy", 1400, 1500, 11, self_u=80, sid=7), 0),
    (_span("device_wait", 1420, 1440, 11, sid=8, parent=7, dir="d2h"), 0),
    # a device wait of the run's own process, half inside
    (_span("device_wait", 1990, 2010, 10, dir="h2d"), None),
]
WANT = {
    "pool.busy_share": (900 + 500) / (2 * 1000),
    "pool.offcore_share": 1 - (300 + 150 + 80) / (400 + 200 + 100),
    "load.s_per_mb": 0.150 / MB,
    "reads.s_per_mb": 0.065 / MB,
    "noisy.s_per_mb": 0.080 / MB,
    "device.wait_s_per_mb": 0.030 / MB,
}


@pytest.fixture(autouse=True)
def clean_store():
    counters.reset()
    yield
    counters.reset()


def _ctx():
    return {"t0_ns": T0, "t1_ns": T1, "mb_called": MB, "events": None,
            "in_process": False, "aligner": {}, "counters": {},
            "stages": {}, "band_fwd_launches": []}


def _fill(spans, dropped=0):
    for s, w in spans:
        counters.absorb([s], 0, worker=w)
    if dropped:
        counters.absorb([], dropped, worker=0)


@pytest.mark.parametrize("name", READERS)
def test_reader_by_hand(name):
    _fill(SPANS)
    assert Spec().reader(name)(_ctx()) == pytest.approx(WANT[name],
                                                        rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_none_without_its_spans_or_after_a_drop(name):
    read = Spec().reader(name)
    assert read(_ctx()) is None
    _fill([(_span("phase", 1175, 1225, 11), 0),
           (_span("call", 1000, 1900, 10), None)])
    assert read(_ctx()) is None
    counters.reset()
    _fill(SPANS, dropped=1)
    assert read(_ctx()) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_none_on_a_program_without_spans(name, monkeypatch):
    _fill(SPANS)
    for attr in ("spans", "spans_between", "dropped"):
        monkeypatch.delattr(counters, attr)
    assert Spec().reader(name)(_ctx()) is None


def test_traced_tiny_pool_run_reads_all_six(monkeypatch):
    # the pairs past 20000 DP cells to the kernels' plain versions, so
    # that the run has device-routed pairs to judge (calibrated routing
    # sends none on the CPU; test_bench_harness.py's pool test sends all)
    monkeypatch.setitem(TINY, "genome", dict(
        TINY["genome"],
        cli=["--host-procs", "2", "--device-min-cells", "20000"]))
    s = TinySpec()
    with tiny_constants():
        res, checks = run.run_cell(s, s.cell("hifi.genome"), 4_000_000_017,
                                   0.5, True, device="cpu")
    assert res["correct"], checks
    got = res["metrics"]
    assert set(READERS) <= set(got), got
    assert 0 < got["pool.busy_share"]["value"] <= 1
    assert 0 <= got["pool.offcore_share"]["value"] < 1
    for name in READERS[2:]:
        assert got[name]["value"] > 0, name
        assert got[name]["unit"] == "s/Mb"
