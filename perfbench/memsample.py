"""Host and card memory of a process tree, sampled in a process of its own
so the sampling takes no time from the measured one.

``python3 -m perfbench.memsample <root pid> <interval s> [<card uuid>]``:
waits for a line ``go`` on standard input, then samples every interval.
A line ``host`` ends the host samples, the card's go on; a line ``stop``
(or the end of its input) ends both.  It prints one JSON line: the host
samples as [Unix time, bytes], and the card's peak bytes in use (null
where NVML cannot be loaded).

A host sample sums, over the root and every descendant but this sampler,
the anonymous memory of /proc/<pid>/smaps (``Anonymous:``), which
belongs to that process alone (the pool's workers are started with exec,
not forked), and adds the largest file-backed resident set of them once
(``Rss:`` less ``Anonymous:``: the shared libraries every process maps).
It does not use PSS: on the card's host /proc/<pid>/smaps_rollup is
absent and smaps reports Pss equal to Rss, with no page counted as
shared, so summed PSS would count each library once a process; nor
/proc/<pid>/status, which has no RssAnon or RssFile there.

The card is read through NVML (``nvmlDeviceGetMemoryInfo``: memory in use
by every process on the card), by the card's UUID, else the first index
of CUDA_VISIBLE_DEVICES, else 0."""

from __future__ import annotations

import ctypes
import json
import os
import select
import sys
import time
from typing import Dict, List, Optional, Tuple


def _children() -> Dict[int, List[int]]:
    kids: Dict[int, List[int]] = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                stat = fh.read()
        except OSError:
            continue
        ppid = int(stat.rsplit(")", 1)[1].split()[1])
        kids.setdefault(ppid, []).append(int(name))
    return kids


def tree(root: int) -> List[int]:
    """The root and its descendants, but not this process."""
    kids = _children()
    out, todo = [], [root]
    while todo:
        pid = todo.pop()
        if pid != os.getpid():
            out.append(pid)
        todo.extend(kids.get(pid, ()))
    return out


def smaps_kb(pid: int) -> Tuple[int, int]:
    """(Rss, Anonymous) kB of one process; (0, 0) once it has gone."""
    rss = anon = 0
    try:
        with open(f"/proc/{pid}/smaps") as fh:
            for line in fh:
                if line.startswith("Rss:"):
                    rss += int(line.split()[1])
                elif line.startswith("Anonymous:"):
                    anon += int(line.split()[1])
    except OSError:
        return 0, 0
    return rss, anon


def sample(root: int) -> int:
    """Bytes of one sample of the tree under ``root``."""
    parts = [smaps_kb(p) for p in tree(root)]
    anon = sum(a for _, a in parts)
    shared = max((r - a for r, a in parts), default=0)
    return (anon + shared) * 1024


class _NvmlMemory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class Card:
    """Bytes in use on one card, through NVML; ``read()`` is None where
    NVML or the card cannot be had."""

    def __init__(self, uuid: str = ""):
        self.lib = self.handle = None
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
            if lib.nvmlInit_v2() != 0:
                return
        except (OSError, AttributeError):
            return
        handle = ctypes.c_void_p()
        ok = bool(uuid) and lib.nvmlDeviceGetHandleByUUID(
            uuid.encode(), ctypes.byref(handle)) == 0
        if not ok:
            first = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")[0]
            index = int(first) if first.strip().isdigit() else 0
            ok = lib.nvmlDeviceGetHandleByIndex_v2(
                ctypes.c_uint(index), ctypes.byref(handle)) == 0
        if ok:
            self.lib, self.handle = lib, handle

    def read(self) -> Optional[int]:
        if self.lib is None:
            return None
        mem = _NvmlMemory()
        if self.lib.nvmlDeviceGetMemoryInfo(self.handle,
                                            ctypes.byref(mem)) != 0:
            return None
        return int(mem.used)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root, interval = int(argv[0]), float(argv[1])
    card = Card(argv[2] if len(argv) > 2 else "")
    line = sys.stdin.readline().strip()
    samples = []
    card_peak = None
    host = line == "go"
    while line in ("go", "host"):
        if host:
            samples.append((time.time(), sample(root)))
        used = card.read()
        if used is not None:
            card_peak = max(card_peak or 0, used)
        ready, _, _ = select.select([sys.stdin], [], [], interval)
        if ready:
            line = sys.stdin.readline().strip() or "stop"
            host = host and line == "go"
    print(json.dumps({"samples": samples, "card_peak": card_peak}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
