"""pool.offcore_share (ratio): the share of the windows' wall in which the
thread that ran them was off a core.  1 less the sum of ``cpu_ns`` of the
``window`` spans (the thread's CPU time over the span, utils/counters.
window_span) over the sum of their wall, each cut to the run's window in
proportion.  Off a core is waiting for one (the run queue) or blocked:
on the card (device.wait_s_per_mb reads that part), on the aligner's C
threads, on I/O.  It bounds the run-queue wait from above where the
kernel reports no per-thread run-queue time (the spans' ``runq_ns`` is
None there).  None without window spans, or where a span was dropped."""

from longcalld_torch.utils import counters


def read(ctx):
    if getattr(counters, "spans", None) is None or counters.dropped():
        return None
    t0, t1 = ctx["t0_ns"], ctx["t1_ns"]
    cpu = wall = 0.0
    for s in counters.spans():
        c = (s.attrs or {}).get("cpu_ns") if s.name == "window" else None
        kept = min(s.t1, t1) - max(s.t0, t0)
        if c is None or kept <= 0:
            continue
        cpu += c * kept / (s.t1 - s.t0)
        wall += kept
    return 1.0 - cpu / wall if wall > 0 else None
