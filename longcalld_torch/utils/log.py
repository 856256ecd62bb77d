"""Leveled colored stderr logging + process resource accounting.

Mirror of the reference's logging surface (reference/src/utils.h:56-63
err_func_format_color / _err_info/_err_warning/_err_error macros and
reference/src/utils.c:350-374 realtime/cputime/peakrss): [I/W/E]
prefixed, function-tagged, colored when stderr is a tty, plus a global
verbosity level driving the -V debug dumps (LONGCALLD_VERBOSE,
reference/src/call_var_main.c:984).
"""

from __future__ import annotations

import resource
import sys
import time

# global verbosity (the LONGCALLD_VERBOSE analog); set by the CLI -V flag
VERBOSE = 0

_START_REAL = time.time()

_COLORS = {"I": "\033[32m", "W": "\033[33m", "E": "\033[31m"}


def set_verbose(level: int) -> None:
    global VERBOSE
    VERBOSE = int(level)


def _emit(level: str, func: str, msg: str) -> None:
    color = sys.stderr.isatty()
    ts = time.strftime("%H:%M:%S")
    if color:
        c = _COLORS.get(level, "")
        sys.stderr.write(f"[{c}{level}\033[0m::{ts}::{func}] {msg}\n")
    else:
        sys.stderr.write(f"[{level}::{ts}::{func}] {msg}\n")
    sys.stderr.flush()


def info(func: str, msg: str) -> None:
    _emit("I", func, msg)


def warning(func: str, msg: str) -> None:
    _emit("W", func, msg)


def error(func: str, msg: str) -> None:
    _emit("E", func, msg)


def error_exit(func: str, msg: str) -> None:
    _emit("E", func, msg)
    raise SystemExit(1)


def debug(level: int, func: str, msg: str) -> None:
    """Verbose debug dump, emitted only when VERBOSE >= level (the
    reference's `if (LONGCALLD_VERBOSE >= n)` stderr dumps)."""
    if VERBOSE >= level:
        _emit("D", func, msg)


def realtime() -> float:
    """Wall seconds since process start (utils.c:350-356)."""
    return time.time() - _START_REAL


def cputime() -> float:
    """User+system CPU seconds (utils.c:358-364)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def peakrss() -> float:
    """Peak RSS in bytes (utils.c:366-374; Linux reports KB)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    mult = 1024 if sys.platform != "darwin" else 1
    return ru.ru_maxrss * mult


def exit_summary(prog: str = "longcalld-tpu") -> None:
    """The reference's exit line (call_var_main.c:1030)."""
    info(prog, "Real time: %.3f sec; CPU: %.3f sec; Peak RSS: %.3f GB"
         % (realtime(), cputime(), peakrss() / 1024.0 ** 3))
