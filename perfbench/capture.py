"""What the benchmark reads of the program while a window runs: a sample
of the answers of its two device layers, and, in a traced run, the pool
workers' device activity.

``BenchOpts`` is the program's ``CallOpts`` with a few fields of the
benchmark's own.  The pool sends a call's options to every worker, so a
worker that unpickles them installs the same hooks as the run's own
process (``install``).  The hooks wrap the aligner's public batch entry
(``BatchAligner.submit`` / ``collect``) and the phasing EM's entries
(``phase_em`` on the card, ``phase_fixpoint_plain`` on CPU tensors); each
keeps a systematic sample of what it saw, from the seed: aligner pairs in
proportion to their DP cells, those the aligner routed to the band
kernels on a finer stride than those it kept on the host, and every
``em_every``-th EM.  The sample stays in memory while the window runs
and is written to the run's capture directory after it (``flush``: the
run's own process calls it, a worker runs it as it exits).  Nothing is
captured in set-up (``bench_call`` < 0).  ``bench_fault`` plants a fault
under the timed path; only the fault tests set it."""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import itertools
import os
import threading
from typing import List

import numpy as np

from longcalld_torch.config import CallOpts


@dataclasses.dataclass
class BenchOpts(CallOpts):
    bench_dir: str = ""          # capture directory ("": capture nothing)
    bench_call: int = -1         # window call index; < 0 in set-up
    bench_seed: int = 0
    bench_trace: int = 0         # 1: the workers trace their device
    bench_root_pid: int = 0      # the run's own process
    bench_em_every: int = 4      # keep every n-th EM
    bench_host_pair_cells: int = 0    # keep a host-routed pair every n DP
    bench_device_pair_cells: int = 0  # cells, and a device-routed one
    bench_fault: str = ""

    def __setstate__(self, state):
        self.__dict__.update(state)
        install(self)


def bench_opts(opt: CallOpts, **kw) -> BenchOpts:
    """``opt`` as BenchOpts with the benchmark's fields ``kw``."""
    vals = {f.name: getattr(opt, f.name) for f in dataclasses.fields(opt)
            if f.init}
    vals.update(kw)
    return BenchOpts(**vals)


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.opts = None
        self.n_em = 0
        # [cells seen, next cut] of host- and device-routed pairs
        self.cuts = {}
        self.seq = itertools.count()
        self.kept = []          # (file name, arrays) not yet written
        self.flush_at_exit = False
        self.prof = None
        self.installed = False


_S = _State()


def install(opts: BenchOpts) -> None:
    """Make ``opts`` the current call's and wrap the program's entries
    (once a process)."""
    with _S.lock:
        _S.opts = opts
        if not _S.installed:
            _wrap()
            _S.installed = True
        for dev, stride in ((False, opts.bench_host_pair_cells),
                            (True, opts.bench_device_pair_cells)):
            if dev not in _S.cuts and stride > 0:
                _S.cuts[dev] = [0, 1 + opts.bench_seed % stride]
    # a worker's profiler starts in set-up: started with the window, its
    # start-up left the first ~12 s of the window without device events
    if (opts.bench_trace and _S.prof is None and opts.bench_dir
            and os.getpid() != opts.bench_root_pid):
        _start_worker_trace(opts.bench_dir)


def _active():
    o = _S.opts
    return o if (o is not None and o.bench_call >= 0 and o.bench_dir) else None


def _keep(kind: str, o: BenchOpts, **arrays) -> None:
    name = f"{kind}_{os.getpid()}_{next(_S.seq):05d}.npz"
    arrays["call"] = np.int64(o.bench_call)
    with _S.lock:
        _S.kept.append((os.path.join(o.bench_dir, name), arrays))
        if not _S.flush_at_exit and os.getpid() != o.bench_root_pid:
            _S.flush_at_exit = True
            atexit.register(flush)


def flush() -> None:
    """Write the kept sample to the capture directory and forget it."""
    with _S.lock:
        kept, _S.kept = _S.kept, []
    for path, arrays in kept:
        tmp = os.path.join(os.path.dirname(path),
                           "." + os.path.basename(path))
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)


def _device_rows(self, token) -> List[int]:
    """Indices of the submitted pairs that ``submit`` sent to the band
    kernels: the memo's misses, all of them on a device round, the
    ``big`` part of a split one (ops/wfa.py:BatchAligner._submit_work)."""
    if token[0] != "memo" or not self.use_device:
        return []
    miss, inner = token[4], token[5]
    if inner[0] == "dev":
        return list(miss)
    if inner[0] == "split":
        return [miss[k] for k in inner[4]]
    return []


def _wrap() -> None:
    from longcalld_torch.ops import phase_kernel, wfa

    real_em = phase_kernel.phase_em
    real_plain = phase_kernel.phase_fixpoint_plain
    real_submit = wfa.BatchAligner.submit
    real_collect = wfa.BatchAligner.collect
    pending = {}

    def em_out(args, kw, out, packed):
        o = _active()
        if o is None:
            return out
        fault = o.bench_fault
        with _S.lock:
            n = _S.n_em
            _S.n_em += 1
        keep = (n + o.bench_seed) % max(1, o.bench_em_every) == 0
        if not keep and fault not in ("em_unchanged", "answer_altered"):
            return out
        import torch
        ins = [a.detach().cpu().numpy() for a in args[:11]]
        buf = (out if packed else phase_kernel.pack_phase_out(out))
        got = buf.detach().cpu().numpy().copy()
        R, V = ins[0].shape
        if fault == "em_unchanged":
            # the step returns the state it was given, as an EM of no
            # round would: the starting consensus and haplotypes, no
            # phase set, no counts, n_iter 0
            got[:] = 0
            got[:2 * V] = ins[3].reshape(-1)
            got[2 * V:2 * V + R] = ins[4]
            got[2 * V + R:3 * V + R] = -1
        elif fault == "answer_altered":
            got[2 * V] = 3 - got[2 * V] if got[2 * V] in (1, 2) else 1
        if fault:
            t = torch.from_numpy(got).to(buf.device)
            out = t if packed else phase_kernel.unpack_phase_out(t, R, V)
        if keep:
            _keep("em", o, out=got, max_iter=np.int64(
                kw.get("max_iter", args[11] if len(args) > 11 else 10)),
                **{f"in{k}": a for k, a in enumerate(ins)})
        return out

    def phase_em(*args, **kw):
        return em_out(args, kw, real_em(*args, **kw), True)

    def phase_fixpoint_plain(*args, **kw):
        return em_out(args, kw, real_plain(*args, **kw), False)

    def submit(self, pairs, left_align=True):
        token = real_submit(self, pairs, left_align)
        o = _active()
        if o is not None and _S.cuts and len(pairs):
            pending[id(token)] = (list(pairs), set(_device_rows(self, token)))
        return token

    def collect(self, token):
        out = real_collect(self, token)
        got = pending.pop(id(token), None)
        o = _active()
        if got is None or o is None:
            return out
        pairs, dev_rows = got
        strides = {False: o.bench_host_pair_cells,
                   True: o.bench_device_pair_cells}
        keep: List[int] = []
        with _S.lock:
            for k, (p, t) in enumerate(pairs):
                cut = _S.cuts.get(k in dev_rows)
                if cut is None:
                    continue
                cut[0] += len(p) * len(t)
                if cut[0] >= cut[1]:
                    keep.append(k)
                    while cut[1] <= cut[0]:
                        cut[1] += strides[k in dev_rows]
        if o.bench_fault == "answer_altered":
            out = [r._replace(score=int(r.score) + 1) for r in out]
        for k in keep:
            p, t = pairs[k]
            r = out[k]
            _keep("pair", o, p=np.asarray(p, np.uint8),
                  t=np.asarray(t, np.uint8),
                  cigar=np.asarray(r.cigar, np.int64).reshape(-1, 2),
                  score=np.int64(r.score), device=np.int64(k in dev_rows))
        return out

    phase_kernel.phase_em = phase_em
    phase_kernel.phase_fixpoint_plain = phase_fixpoint_plain
    wfa.BatchAligner.submit = submit
    wfa.BatchAligner.collect = collect


def reset() -> None:
    """Capture nothing more in this process (the hooks stay, inert), and
    drop what was kept."""
    with _S.lock:
        _S.opts = None
        _S.kept = []


@contextlib.contextmanager
def half_windows():
    """The fault "half of the batch left out": every other window's
    records are dropped where the call writes them."""
    from longcalld_torch.core import pipeline
    real = pipeline.write_var_records
    n = itertools.count()

    def write_var_records(out, tname, variants, opt):
        return real(out, tname, variants if next(n) % 2 else [], opt)
    pipeline.write_var_records = write_var_records
    try:
        yield
    finally:
        pipeline.write_var_records = real


# ---------------- the workers' device trace ----------------

def _start_worker_trace(d: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        return              # a host-only worker has no device to trace
    # the device only: recording every host operation of a worker slowed
    # its windows 2.5x
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    _S.prof = prof
    atexit.register(_dump_worker_trace, d)


def _dump_worker_trace(d: str) -> None:
    """Device intervals of this worker's window, to ``d/trace_<pid>.npz``:
    read by perfbench/trace.py."""
    from perfbench import trace
    prof = _S.prof
    if prof is None:
        return
    prof.__exit__(None, None, None)
    trace.save_events(prof, os.path.join(d, f"trace_{os.getpid()}.npz"))
