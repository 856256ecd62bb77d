"""Per-stage runtime counters and the program's span recorder (the SURVEY
section-5 tracing surface).

Thread-safe accumulators for stage wall time and event counts across
windows; run_call prints the table with the exit summary under -V.
Complements the reference's per-run realtime/cputime/peakrss line
(reference/src/call_var_main.c:1030) with the per-stage breakdown
the C tool lacks — on this backend the split between host stages and
device waits is the first thing every perf question needs.

``span(name, window=None, **attrs)`` times one piece of work at a layer
boundary.  Its record (``Span``) holds start and end as ``time.time_ns()``
(the Unix-ns clock that kineto stamps, so spans and a torch.profiler
trace of any process of the machine line up), the id of the span and of
the enclosing one (a stack per thread), the window's plan index (the
request id every span of that window carries, in any process: inherited
from the enclosing span where not given), the pid, the native thread id,
the self time (the duration less what child spans cover) and a few
attributes.  A closing span adds its self time to the stage table under
its name.  Records go to a store of at most ``MAX_SPANS`` a process; the
spans past it are counted (``dropped()``) and not kept.  A pool worker
ships its records to the run's process (``take_spans`` / ``absorb``).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from contextlib import contextmanager
from typing import List, NamedTuple, Optional

MAX_SPANS = 1 << 17

_lock = threading.Lock()
_times: dict = {}
_counts: dict = {}
_spans: list = []
_dropped = 0
_serial = itertools.count(1)
_tls = threading.local()


class Span(NamedTuple):
    name: str
    t0: int                 # time.time_ns() at the start
    t1: int                 # ... and at the end
    id: int                 # pid << 32 | serial: unique across processes
    parent: int             # id of the enclosing span, 0 at the top
    window: Optional[int]   # the window's plan index (request id)
    pid: int
    tid: int                # native thread id
    self_ns: int            # t1 - t0 less what child spans cover
    attrs: Optional[dict]
    worker: Optional[int] = None  # pool worker index, set by absorb()


def reset() -> None:
    global _dropped
    with _lock:
        _times.clear()
        _counts.clear()
        _spans.clear()
        _dropped = 0


def inc(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def _keep(rec: Span) -> None:
    """Store ``rec`` and add its self time to the stage table (under
    _lock)."""
    global _dropped
    e = _times.setdefault(rec.name, [0, 0.0])
    e[0] += 1
    e[1] += rec.self_ns / 1e9
    if len(_spans) < MAX_SPANS:
        _spans.append(rec)
    else:
        _dropped += 1


@contextmanager
def span(name: str, window: Optional[int] = None, **attrs):
    """Record the enclosed work as a span named ``name``.  Yields the
    span's attribute dict, which the block may fill in."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    up = stack[-1] if stack else None
    if window is None and up is not None:
        window = up[2]
    # [serial, start ns, window, ns covered by child spans]
    frame = [next(_serial), time.time_ns(), window, 0]
    stack.append(frame)
    try:
        yield attrs
    finally:
        t1 = time.time_ns()
        stack.pop()
        dur = t1 - frame[1]
        if up is not None:
            up[3] += dur
        pid = os.getpid()
        rec = Span(name, frame[1], t1, pid << 32 | frame[0],
                   pid << 32 | up[0] if up is not None else 0, window, pid,
                   threading.get_native_id(), dur - frame[3], attrs or None)
        with _lock:
            _keep(rec)


def _runq_ns() -> Optional[int]:
    """This thread's time runnable but waiting for a core (the second
    field of /proc/thread-self/schedstat); None where the kernel has no
    such file."""
    try:
        with open("/proc/thread-self/schedstat") as fh:
            return int(fh.read().split()[1])
    except (OSError, IndexError, ValueError):
        return None


@contextmanager
def window_span(window: int):
    """The ``window`` span of one window, with ``runq_ns`` (the growth of
    the thread's run-queue wait over the span, None where the kernel does
    not report it) and ``cpu_ns`` (the thread's CPU time over the span)."""
    q0, c0 = _runq_ns(), time.thread_time_ns()
    with span("window", window=window) as attrs:
        try:
            yield attrs
        finally:
            q1 = _runq_ns()
            attrs["runq_ns"] = None if q0 is None or q1 is None else q1 - q0
            attrs["cpu_ns"] = time.thread_time_ns() - c0


def spans() -> List[Span]:
    """Copy of this process's span store (the workers' shipped spans
    included)."""
    with _lock:
        return list(_spans)


def dropped() -> int:
    """Spans not kept because the store was full (a worker's included)."""
    with _lock:
        return _dropped


def take_spans() -> tuple:
    """(records, dropped count) of this process, taken out of the store:
    what a pool worker ships with each range."""
    global _dropped
    with _lock:
        out, n = list(_spans), _dropped
        _spans.clear()
        _dropped = 0
    return out, n


def absorb(records, n_dropped: int, worker: int) -> None:
    """Add a worker's shipped spans to this process's store, tagged with
    the worker index, and their self times to the stage table."""
    global _dropped
    with _lock:
        _dropped += n_dropped
        for rec in records:
            _keep(rec._replace(worker=worker))


def spans_between(t0_ns: int, t1_ns: int) -> Optional[List[Span]]:
    """The stored spans that overlap [t0_ns, t1_ns), cut to it: start and
    end clipped, the self time scaled by the share of the span kept.
    None if any span was dropped, since the rest do not add up then."""
    with _lock:
        if _dropped:
            return None
        recs = list(_spans)
    out = []
    for s in recs:
        lo, hi = max(s.t0, t0_ns), min(s.t1, t1_ns)
        if hi <= lo:
            continue
        self_ns = s.self_ns
        if hi - lo < s.t1 - s.t0:
            self_ns = self_ns * (hi - lo) // (s.t1 - s.t0)
        out.append(s._replace(t0=lo, t1=hi, self_ns=self_ns))
    return out


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
