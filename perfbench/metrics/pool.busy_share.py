"""pool.busy_share (ratio): how much of the window the pool's workers
spent inside a range.  For each worker pid, the union of its ``range``
spans (core/pipeline.py:_range_worker, shipped to the run's process with
each range), cut to the window; their sum over (worker pids x window
length).  The workers are the pids of the ``range`` spans in the window.
None without range spans, or where a span was dropped."""

from longcalld_torch.utils import counters


def read(ctx):
    between = getattr(counters, "spans_between", None)
    if between is None:
        return None
    t0, t1 = ctx["t0_ns"], ctx["t1_ns"]
    spans = between(t0, t1)
    if not spans or t1 <= t0:
        return None
    by_pid = {}
    for s in spans:
        if s.name == "range":
            by_pid.setdefault(s.pid, []).append((s.t0, s.t1))
    if not by_pid:
        return None
    busy = 0
    for ivs in by_pid.values():
        end = t0
        for a, b in sorted(ivs):
            a = max(a, end)
            if b > a:
                busy += b - a
                end = b
    return busy / (len(by_pid) * (t1 - t0))
