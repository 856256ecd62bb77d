"""Per-stage runtime counters (the SURVEY section-5 tracing surface).

Thread-safe accumulators for stage wall time and event counts across
windows; run_call prints the table with the exit summary under -V.
Complements the reference's per-run realtime/cputime/peakrss line
(reference/src/call_var_main.c:1030) with the per-stage breakdown
the C tool lacks — on this backend the split between host stages and
device waits is the first thing every perf question needs.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

_lock = threading.Lock()
_times: dict = {}
_counts: dict = {}


def reset() -> None:
    with _lock:
        _times.clear()
        _counts.clear()


def add_time(name: str, dt: float) -> None:
    with _lock:
        e = _times.get(name)
        if e is None:
            _times[name] = [1, dt]
        else:
            e[0] += 1
            e[1] += dt


def inc(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


@contextmanager
def timed(name: str):
    t0 = time.time()
    try:
        yield
    finally:
        add_time(name, time.time() - t0)


def snapshot() -> dict:
    """Copy of the event-count table (tests and bench audit trails)."""
    with _lock:
        return dict(_counts)


def summary_lines() -> list:
    with _lock:
        lines = [f"stage {name}: {e[1]:.3f} s over {e[0]} calls"
                 for name, e in sorted(_times.items(), key=lambda kv: -kv[1][1])]
        lines += [f"count {name}: {v}"
                  for name, v in sorted(_counts.items())]
    return lines
