"""device.wait_s_per_mb (s/Mb): seconds the host waited on the card, the
duration of the ``device_wait`` spans of every process cut to the
window (the aligner's uploads and its two copies back, ops/wfa.py; the
phasing EM's upload and its one copy back, ops/phase_kernel.py), per Mb
of contig called.  None without such spans, or where a span was
dropped."""

from longcalld_torch.utils import counters


def read(ctx):
    between = getattr(counters, "spans_between", None)
    if between is None or ctx["mb_called"] <= 0:
        return None
    spans = [s for s in between(ctx["t0_ns"], ctx["t1_ns"]) or ()
             if s.name == "device_wait"]
    if not spans:
        return None
    return sum(s.t1 - s.t0 for s in spans) / 1e9 / ctx["mb_called"]
