"""aligner.wide_host_cell_share (ratio): the share of the window's
alignment DP cells that the aligner kept on the host by the band rule
alone (above its routing threshold, band bucket above 512:
ops/wfa.py:BatchAligner's ``cells_host_wide``), of all the cells it
aligned, host and card: cells_host_wide / (cells_host + cells_device).
On the pool from the aln_* counters the workers ship to the run's
process (a counter that stayed 0 is not shipped), in-process from
ops/wfa.py:aligner_totals().  None where the program counts no such
cells: it has neither ``cells_host_wide`` nor ``host_align_ns``, the
counter that came with it and grows in every window."""

WIDE, SIGN = "cells_host_wide", "host_align_ns"


def read(ctx):
    if ctx["in_process"]:
        got = ctx["aligner"]
    else:
        got = {k[4:]: v for k, v in ctx["counters"].items()
               if k.startswith("aln_")}
    if WIDE not in got and SIGN not in got:
        return None
    total = got.get("cells_host", 0) + got.get("cells_device", 0)
    if total <= 0:
        return None
    return got.get(WIDE, 0) / total
