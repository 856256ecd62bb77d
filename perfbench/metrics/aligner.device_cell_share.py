"""aligner.device_cell_share (ratio): the share of the window's alignment
DP cells that ran on the card, cells_device / (cells_device +
cells_host).  In-process from ops/wfa.py:aligner_totals(); on the pool
from the aln_cells_device / aln_cells_host counters the workers ship to
the run's process."""


def read(ctx):
    if ctx["in_process"]:
        dev = ctx["aligner"].get("cells_device", 0)
        host = ctx["aligner"].get("cells_host", 0)
    else:
        dev = ctx["counters"].get("aln_cells_device", 0)
        host = ctx["counters"].get("aln_cells_host", 0)
    if dev + host <= 0:
        return None
    return dev / (dev + host)
