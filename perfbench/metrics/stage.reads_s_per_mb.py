"""stage.reads_s_per_mb (s/Mb): seconds of the host read stages' timers
(digar, sites, classify, profile: core/digar.py, sites.py, classify.py,
profile.py) over the window, per Mb of contig called; in-process only."""

STAGES = ("digar", "sites", "classify", "profile")


def read(ctx):
    if not ctx["in_process"] or ctx["mb_called"] <= 0:
        return None
    s = sum(ctx["stages"].get(k, 0.0) for k in STAGES)
    return None if s <= 0 else s / ctx["mb_called"]
