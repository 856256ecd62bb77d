"""Device activity from torch.profiler's kineto events: the busy union,
time by device operation, the longest idle gaps named by what the host
was doing, and the time of the kernels whose names hold a given string.

Events are kept as numpy arrays of (name index, start ns, duration ns),
split into device events (kernels, copies, sets) and host events; the
clocks of every process on a machine agree (kineto stamps Unix ns), so
the events of the pool's workers and of the run's own process go into
one timeline of the card."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# host events shorter than this cannot name an idle gap worth listing
_MIN_HOST_NS = 20_000
# host events of the measurement itself, not of the program: the
# profiler's own buffer requests
OWN_HOST = ("Activity Buffer Request",)


class Events:
    def __init__(self, names: Sequence[str], dev: np.ndarray,
                 host: np.ndarray):
        self.names = list(names)
        self.dev = np.asarray(dev, dtype=np.int64).reshape(-1, 3)
        self.host = np.asarray(host, dtype=np.int64).reshape(-1, 3)

    @classmethod
    def of_profiler(cls, prof) -> "Events":
        """The profiler's events, but the host events of OWN_HOST."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        index: Dict[str, int] = {}
        dev: List[tuple] = []
        host: List[tuple] = []
        for e in prof.profiler.kineto_results.events():
            dur = int(e.duration_ns())
            is_dev = e.device_type() == cuda
            if not is_dev and (dur < _MIN_HOST_NS or e.name() in OWN_HOST):
                continue
            k = index.setdefault(e.name(), len(index))
            (dev if is_dev else host).append((k, int(e.start_ns()), dur))
        return cls(list(index), np.array(dev, dtype=np.int64),
                   np.array(host, dtype=np.int64))

    @classmethod
    def merge(cls, parts: Sequence["Events"]) -> "Events":
        index: Dict[str, int] = {}
        dev, host = [], []
        for p in parts:
            remap = np.array([index.setdefault(n, len(index))
                              for n in p.names] or [0], dtype=np.int64)
            for src, dst in ((p.dev, dev), (p.host, host)):
                if len(src):
                    a = src.copy()
                    a[:, 0] = remap[a[:, 0]]
                    dst.append(a)
        cat = (lambda xs: np.concatenate(xs) if xs
               else np.zeros((0, 3), np.int64))
        return cls(list(index), cat(dev), cat(host))

    def save(self, path: str) -> None:
        np.savez(path, names=np.array(self.names, dtype=object),
                 dev=self.dev, host=self.host)

    @classmethod
    def load(cls, path: str) -> "Events":
        z = np.load(path, allow_pickle=True)
        return cls([str(n) for n in z["names"]], z["dev"], z["host"])


def save_events(prof, path: str) -> None:
    Events.of_profiler(prof).save(path)


def clip(iv: np.ndarray, t0: int, t1: int) -> np.ndarray:
    """(start, end) rows of (name, start, duration) events, cut to
    [t0, t1); empty ones dropped."""
    s = np.maximum(iv[:, 1], t0)
    e = np.minimum(iv[:, 1] + iv[:, 2], t1)
    keep = e > s
    return np.stack([s[keep], e[keep]], axis=1)


def union(iv: np.ndarray) -> np.ndarray:
    """The disjoint intervals covering (start, end) rows."""
    if not len(iv):
        return np.zeros((0, 2), np.int64)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], axis=1)


def busy_ns(ev: Events, t0: int, t1: int) -> int:
    """Nanoseconds of [t0, t1) in which some device operation ran."""
    u = union(clip(ev.dev, t0, t1))
    return int((u[:, 1] - u[:, 0]).sum())


def time_by_name(ev: Events, t0: int, t1: int, substr: Optional[str] = None
                 ) -> Dict[str, int]:
    """Device ns inside [t0, t1) by operation name (only names holding
    ``substr``, if given)."""
    out: Dict[str, int] = {}
    s = np.maximum(ev.dev[:, 1], t0)
    e = np.minimum(ev.dev[:, 1] + ev.dev[:, 2], t1)
    for k, d in zip(ev.dev[:, 0], e - s):
        if d <= 0:
            continue
        name = ev.names[int(k)]
        if substr is None or substr in name:
            out[name] = out.get(name, 0) + int(d)
    return out


def kernel_ns(ev: Events, t0: int, t1: int, substr: str) -> int:
    return sum(time_by_name(ev, t0, t1, substr).values())


def breakdown(ev: Events, t0: int, t1: int, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the card, each named by the host event that overlaps it
    most ("host: no profiled operation" where none does)."""
    ops = sorted(time_by_name(ev, t0, t1).items(), key=lambda kv: -kv[1])
    u = union(clip(ev.dev, t0, t1))
    edges = np.concatenate([[t0], u.ravel(), [t1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")][:top]
    hs = ev.host[:, 1]
    he = ev.host[:, 1] + ev.host[:, 2]
    named = []
    for g0, g1 in gaps:
        ov = np.minimum(he, g1) - np.maximum(hs, g0)
        name = "host: no profiled operation"
        if len(ov) and ov.max() > 0:
            name = "host: " + ev.names[int(ev.host[int(np.argmax(ov)), 0])]
        named.append([name, (int(g1) - int(g0)) / 1e9])
    return {"device_ops": [[n, d / 1e9] for n, d in ops[:top]],
            "idle_gaps": named}
