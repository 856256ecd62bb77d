"""reads.s_per_mb (s/Mb): seconds of the host read stages (core/digar.py,
sites.py, classify.py, profile.py), the self time of the ``digar``,
``sites``, ``classify`` and ``profile`` spans of every process cut to the
window, per Mb of contig called.  None without such spans, or where a
span was dropped."""

from longcalld_torch.utils import counters

NAMES = ("digar", "sites", "classify", "profile")


def read(ctx):
    between = getattr(counters, "spans_between", None)
    if between is None or ctx["mb_called"] <= 0:
        return None
    spans = [s for s in between(ctx["t0_ns"], ctx["t1_ns"]) or ()
             if s.name in NAMES]
    if not spans:
        return None
    return sum(s.self_ns for s in spans) / 1e9 / ctx["mb_called"]
