"""stage.noisy_s_per_mb (s/Mb): seconds of the utils/counters stage timer
``noisy`` (noisy-region re-assembly: core/noisy.py, core/consensus.py)
over the window, per Mb of contig called.  The timers are the run's own
process's: this reads nothing on the pool."""


def read(ctx):
    if not ctx["in_process"] or ctx["mb_called"] <= 0:
        return None
    s = ctx["stages"].get("noisy")
    return None if not s else s / ctx["mb_called"]
