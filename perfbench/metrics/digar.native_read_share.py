"""digar.native_read_share (ratio): the share of the window's reads whose
digar native/digar.c computed in one pass a window
(core/digar.py:collect_window_digars), native / (native + python).  On
the pool from the digar_native_reads / digar_python_reads counters the
workers ship to the run's process; in-process from
core/digar.py:read_counts(), the process's counts since it started.
None where the program has no such counters (before the native pass)."""

NATIVE, PYTHON = "digar_native_reads", "digar_python_reads"


def read(ctx):
    if ctx["in_process"]:
        from longcalld_torch.core import digar
        counts = getattr(digar, "read_counts", None)
        got = counts() if counts is not None else {}
    else:
        got = {k: ctx["counters"].get("aln_" + k, 0) for k in (NATIVE,
                                                               PYTHON)}
    native, python = got.get(NATIVE, 0), got.get(PYTHON, 0)
    if native + python <= 0:
        return None
    return native / (native + python)
