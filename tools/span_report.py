"""One traced run of a benchmark cell (``python3 -m perfbench.run ...
--trace 1``, in this process), then what the program's spans say of its
window: where the pool workers' time went, and what they were doing in
the card's longest idle gaps.

    python3 tools/span_report.py --workload hifi.genome --seed N \
        [--seconds 51] [--out FILE]

Prints the run's result line, then one JSON line (appended to ``--out``
too) with:

* ``metrics``: the traced run's per-layer metrics;
* ``self_s``: self seconds and count of each span name in the window
  (utils/counters.spans_between), the workers' apart from the run's own
  process's;
* ``range_uncovered_share``: the ``range`` spans' self time over their
  wall, the part of a worker's range that no window or stage span covers;
* ``window_cpu_share``: the ``window`` spans' thread CPU time over
  their wall, and ``window_runq_share``, their run-queue wait over it;
* ``device_min_cells``: each pool worker's aligner routing threshold
  (its calibrated one, unless an option set it), from the attribute of
  its ``range`` spans: {worker: [thresholds]}, printed on standard error
  too;
* ``gaps``: the 10 longest idle gaps of the card (perfbench/trace.py's
  breakdown, on the same events), each with the worker-seconds spent in
  it by the innermost span of each worker (a span's part of the gap less
  its children's), and the workers inside a ``device_wait`` there.

The spans and the device events share one clock (Unix ns), so a gap is
put down to the spans that covered it by time alone.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _inner_overlap(spans, g0, g1):
    """{name: ns} of [g0, g1) spent in each span as the innermost open
    one: its overlap with the gap less its children's."""
    ov = {}
    for s in spans:
        o = min(s.t1, g1) - max(s.t0, g0)
        if o > 0:
            ov[s.id] = o
    out = collections.Counter()
    by_id = {s.id: s for s in spans}
    for sid, o in ov.items():
        out[by_id[sid].name] += o
        parent = by_id[sid].parent
        if parent in ov:
            out[by_id[parent].name] -= o
    return {k: v for k, v in out.items() if v > 0}


def report(events, t0, t1, metrics) -> dict:
    from longcalld_torch.utils import counters
    from perfbench import trace

    spans = counters.spans_between(t0, t1)
    if spans is None:
        return {"error": f"{counters.dropped()} spans dropped"}
    me = os.getpid()
    self_s = {"workers": collections.defaultdict(lambda: [0.0, 0]),
              "run": collections.defaultdict(lambda: [0.0, 0])}
    for s in spans:
        e = self_s["run" if s.pid == me else "workers"][s.name]
        e[0] += s.self_ns / 1e9
        e[1] += 1
    ranges = [s for s in spans if s.name == "range"]
    wins = [s for s in spans if s.name == "window"
            and s.t0 >= t0 and s.t1 <= t1]
    win_wall = sum(s.t1 - s.t0 for s in wins)
    runq = [s.attrs["runq_ns"] for s in wins
            if s.attrs.get("runq_ns") is not None]
    thresholds = collections.defaultdict(set)
    for s in ranges:
        v = (s.attrs or {}).get("device_min_cells")
        if v is not None:
            thresholds[s.worker].add(int(v))

    # the card's idle gaps, as perfbench/trace.py:breakdown finds them
    import numpy as np
    u = trace.union(trace.clip(events.dev, t0, t1))
    edges = np.concatenate([[t0], u.ravel(), [t1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")][:10]
    workers = collections.defaultdict(list)
    for s in counters.spans():
        if s.pid != me:
            workers[s.pid].append(s)
    rows = []
    for g0, g1 in gaps:
        g0, g1 = int(g0), int(g1)
        tot = collections.Counter()
        waiting = 0
        for recs in workers.values():
            got = _inner_overlap(recs, g0, g1)
            tot.update(got)
            waiting += "device_wait" in got
        rows.append({"t0_s": (g0 - t0) / 1e9, "gap_s": (g1 - g0) / 1e9,
                     "worker_s": {k: v / 1e9 for k, v in tot.most_common()},
                     "workers_in_device_wait": waiting})
    return {
        "metrics": metrics,
        "window_s": (t1 - t0) / 1e9,
        "n_spans": len(spans),
        "self_s": {k: {n: v for n, v in sorted(d.items(),
                                               key=lambda kv: -kv[1][0])}
                   for k, d in self_s.items()},
        "range_uncovered_share": (
            sum(s.self_ns for s in ranges)
            / max(1, sum(s.t1 - s.t0 for s in ranges))),
        "window_cpu_share": (sum(s.attrs["cpu_ns"] for s in wins)
                             / max(1, win_wall)),
        "window_runq_share": (sum(runq) / max(1, win_wall)
                              if runq else None),
        "n_windows": len(wins),
        "device_min_cells": {str(w): sorted(v) for w, v in
                             sorted(thresholds.items(),
                                    key=lambda kv: (kv[0] is None, kv[0]))},
        "gaps": rows,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from perfbench import run, trace
    seen = {}
    real_breakdown, real_run_cell = trace.breakdown, run.run_cell

    def breakdown(ev, t0, t1, *a, **k):
        seen["window"] = (ev, t0, t1)
        return real_breakdown(ev, t0, t1, *a, **k)

    def run_cell(*a, **k):
        seen["result"] = real_run_cell(*a, **k)
        return seen["result"]

    trace.breakdown, run.run_cell = breakdown, run_cell
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc != 0 or "window" not in seen:
        return rc or 1
    result, _ = seen["result"]
    line = report(*seen["window"], result["metrics"])
    for w, v in line.get("device_min_cells", {}).items():
        print(f"worker {w}: device_min_cells {', '.join(map(str, v))}",
              file=sys.stderr, flush=True)
    line.update(workload=args.workload, seed=args.seed,
                card=result.get("card", run.power_limit()),
                correct=result["correct"])
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
