"""band_fwd.roofline_share (ratio): the least time of the window's
band_fwd launches (perfbench/roofline.py:band_fwd_least_seconds: each
launch's operations over the card's int32 rate or its bytes over HBM
bandwidth, whichever is larger) over the device time of the kernels
named band_fwd in the trace of every process of the run.

In-process the launches are those the run recorded (as band_fwd_roofline
reads them, ``ctx["band_fwd_launches"]``).  On the pool they are the
workers' shipped totals by shape, aln_band_fwd_<B>x<Lp>x<batch>_launches
and _rows (launches and the pairs' real rows summed, ops/band.py:
fwd_rows), taken as one launch of ``launches`` x batch pairs a shape:
the operations and bytes add up alike, only the larger of the two bounds
is taken a shape and not a launch.  Real rows, not the Lp rows a padded
pair is run to: the share counts what the inputs need.  None where there
are no launches (a pool program that ships no launch shapes) or the
trace holds no band_fwd time."""

import re

from perfbench import roofline, trace

SHAPE = re.compile(r"^aln_band_fwd_(\d+)x(\d+)x(\d+)_(launches|rows)$")


def shipped_launches(counters):
    """[(B, Lp, launches x batch, rows)] of the shipped shape counters."""
    shapes = {}
    for name, v in counters.items():
        m = SHAPE.match(name)
        if m:
            key = tuple(int(g) for g in m.groups()[:3])
            shapes.setdefault(key, {})[m.group(4)] = v
    return [(b, lp, n * got.get("launches", 0), got.get("rows", 0))
            for (b, lp, n), got in sorted(shapes.items())
            if got.get("launches", 0) > 0]


def read(ctx):
    ev = ctx["events"]
    if ev is None:
        return None
    launches = (ctx["band_fwd_launches"] if ctx["in_process"]
                else shipped_launches(ctx["counters"]))
    if not launches:
        return None
    ns = trace.kernel_ns(ev, ctx["t0_ns"], ctx["t1_ns"], "band_fwd")
    if ns <= 0:
        return None
    return roofline.band_fwd_least_seconds(launches) / (ns / 1e9)
