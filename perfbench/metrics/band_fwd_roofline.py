"""band_fwd_roofline (%): the least time of the window's band_fwd
launches (perfbench/roofline.py: each launch's operations over the
card's int32 rate or its bytes over HBM bandwidth, whichever is larger)
as a share of the device time of the band_fwd kernels in the trace."""

from perfbench import roofline, trace


def read(ctx):
    ev, launches = ctx["events"], ctx["band_fwd_launches"]
    if ev is None or not launches:
        return None
    ns = trace.kernel_ns(ev, ctx["t0_ns"], ctx["t1_ns"], "band_fwd")
    if ns <= 0:
        return None
    return 100.0 * roofline.band_fwd_least_seconds(launches) / (ns / 1e9)
