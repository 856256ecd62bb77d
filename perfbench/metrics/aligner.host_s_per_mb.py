"""aligner.host_s_per_mb (s/Mb): seconds the aligner spent in the host C
aligner (ops/wfa.py:BatchAligner._host_many, its ``host_align_ns``) in
the window, per Mb of contig called, summed over the pool's workers
(the aln_host_align_ns counter they ship; in-process from
ops/wfa.py:aligner_totals()).  None where the program has no such
counter."""

KEY = "host_align_ns"


def read(ctx):
    got = ctx["aligner"] if ctx["in_process"] else {
        k[4:]: v for k, v in ctx["counters"].items() if k.startswith("aln_")}
    if KEY not in got or ctx["mb_called"] <= 0:
        return None
    return got[KEY] / 1e9 / ctx["mb_called"]
