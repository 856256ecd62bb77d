"""phase_em.ms_per_mb (ms/Mb): device milliseconds of the phasing EM's
kernel (csrc/phase_em.cu, kernels named phase_em*) in the traced window,
per Mb of contig called."""

from perfbench import trace


def read(ctx):
    ev = ctx["events"]
    if ev is None or ctx["mb_called"] <= 0:
        return None
    ns = trace.kernel_ns(ev, ctx["t0_ns"], ctx["t1_ns"], "phase_em")
    return None if ns <= 0 else ns / 1e6 / ctx["mb_called"]
