"""Persistent subprocess worker pool for window-range parallelism: the
port's copy of longcalld_tpu/core/procpool.py.

The kt_for analog that scales the interpreted host stages past the GIL:
run_call hands many-window streams to worker PROCESSES
(core/procworker.py).  Workers are plain ``python -m`` subprocesses
talking pickles over pipes: no fork of a process that may hold a CUDA
context, no ``__main__`` re-execution.

What differs from the JAX pool:

* workers run ``longcalld_torch.core.procworker``, with the repo root
  first on ``PYTHONPATH`` so ``python -m`` resolves wherever the parent
  was started;
* host-only workers (the default) get ``CUDA_VISIBLE_DEVICES=""`` in
  place of ``JAX_PLATFORMS=cpu``: a host-only worker cannot open a CUDA
  context;
* per-worker-device workers (``worker_env_fn``) launch with their env
  overrides (``CUDA_VISIBLE_DEVICES`` naming their card) and run on the
  torch ``device`` of the run's context.  Pools are keyed by the env
  signature AND the device string, so host and device pools, or pools for
  two devices, never share workers.

Workers persist across runs (module-level pools), so repeated run_call
invocations in one process pay the worker-import cost once.  The ordered
yield, the backlog cap and the join-on-exit of ``imap_ranges`` are the
JAX pool's.
"""

from __future__ import annotations

import atexit
import itertools
import os
import pickle
import subprocess
import sys
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

_CTX_IDS = itertools.count(1)
# the checkout that holds longcalld_torch
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def worker_environ(env_overrides: Optional[dict] = None) -> dict:
    """The environment a worker starts with: the parent's, the repo root
    first on PYTHONPATH, and either the host-only isolation or the
    per-worker overrides (a None value unsets the variable)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO_ROOT, env.get("PYTHONPATH")) if p)
    if env_overrides is None:
        env["CUDA_VISIBLE_DEVICES"] = ""   # host-only by contract
    else:
        for k, v in env_overrides.items():
            if v is None:
                env.pop(k, None)
            else:
                env[k] = str(v)
    return env


class _Worker:
    def __init__(self, idx: int = 0,
                 env_overrides: Optional[dict] = None) -> None:
        self.idx = idx
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "longcalld_torch.core.procworker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            env=worker_environ(env_overrides))
        self.ctx_id = -1
        self._send(("warm",))          # import the package in parallel

    def _send(self, msg) -> None:
        pickle.dump(msg, self.proc.stdin, protocol=pickle.HIGHEST_PROTOCOL)
        self.proc.stdin.flush()

    def run(self, ctx_id: int, ctx_msg, first_k: int, count: int):
        if self.ctx_id != ctx_id:
            self._send(ctx_msg)
            self.ctx_id = ctx_id
        self._send(("run", ctx_id, first_k, count))
        res = pickle.load(self.proc.stdout)
        if res[0] == "err":
            raise RuntimeError(f"range worker failed:\n{res[1]}")
        return res[1]

    def alive(self) -> bool:
        return self.proc.poll() is None

    def stop(self) -> None:
        try:
            if self.alive():
                self._send(("exit",))
                self.proc.wait(timeout=5)
        except Exception:
            self.proc.kill()
            self.proc.wait()
        for f in (self.proc.stdin, self.proc.stdout):
            try:
                f.close()
            except OSError:
                pass


# pools keyed by the worker-env signature and the torch device: host-only
# workers and device-owning workers must never be interchanged
_POOLS: Dict[tuple, List[_Worker]] = {}
_LOCK = threading.Lock()


def _get_workers(n: int, worker_env_fn: Optional[Callable[[int, int],
                                                          dict]] = None,
                 device: Optional[str] = None) -> List[_Worker]:
    if worker_env_fn is None:
        key: tuple = ("host", device)
        env_of = None
    else:
        envs = [worker_env_fn(k, n) for k in range(n)]
        key = ("dev", device) + tuple(tuple(sorted(e.items())) for e in envs)
        env_of = envs
    with _LOCK:
        pool = _POOLS.setdefault(key, [])
        pool[:] = [w for w in pool if w.alive()]
        while len(pool) < n:
            k = len(pool)
            pool.append(_Worker(
                idx=k, env_overrides=None if env_of is None else env_of[k]))
        return pool[:n]


def shutdown() -> None:
    with _LOCK:
        for pool in _POOLS.values():
            for w in pool:
                w.stop()
        _POOLS.clear()


atexit.register(shutdown)


def imap_ranges(opt, wins, ranges: Sequence[Tuple[int, int]],
                n_workers: int,
                worker_env_fn: Optional[Callable[[int, int], dict]] = None,
                range_worker_out: Optional[Dict[int, int]] = None,
                order: Optional[Sequence[int]] = None,
                max_backlog: int = 0,
                device: Optional[str] = None) -> Iterator[list]:
    """Run each (first_k, count) window range on a pool worker; yield the
    per-range result lists strictly in ``ranges`` order while later ranges
    keep executing (the ordered hand-off of kt_pipeline).

    ``worker_env_fn(k, n)`` -> env-override dict switches the pool to
    per-worker-device mode, and ``device`` is the torch device string the
    workers run on (None for host-only workers).  ``range_worker_out``,
    when given, is filled with range-index -> worker-index so the caller
    can attribute each range's counter deltas to the worker that produced
    them.  ``order``, when given, is the EXECUTION priority (a permutation
    of range indices); the yield order is unchanged.

    Backpressure: the completed-but-unyielded backlog is BOUNDED at
    ``max_backlog`` ranges (default 2*workers+2); the range the consumer
    needs next is always runnable, so parking never deadlocks the stream.
    (longcalld_tpu/core/procpool.py:imap_ranges has the full argument.)"""
    workers = _get_workers(n_workers, worker_env_fn, device)
    ctx_id = next(_CTX_IDS)
    ctx_msg = ("ctx", ctx_id, opt, wins, device)
    cap = max_backlog or (2 * n_workers + 2)
    pending: List[int] = list(order if order is not None
                              else range(len(ranges)))
    results: dict = {}
    state = {"yield_ptr": 0, "stop": False}
    cond = threading.Condition()

    def _take_task() -> Optional[tuple]:
        """Next range for a worker under the backlog cap; None = done."""
        with cond:
            while True:
                if state["stop"] or not pending:
                    return None
                backlog = len(results)
                if backlog < cap:
                    i = pending.pop(0)
                    return i, ranges[i]
                need = state["yield_ptr"]
                if need in pending:
                    # the consumer's next range is still queued: run it
                    # now so parking can never deadlock the stream
                    pending.remove(need)
                    return need, ranges[need]
                cond.wait(timeout=0.2)

    def drive(w: _Worker) -> None:
        while True:
            task = _take_task()
            if task is None:
                return
            idx, (first_k, count) = task
            try:
                out = ("ok", w.run(ctx_id, ctx_msg, first_k, count))
            except BaseException as e:     # noqa: BLE001 — relayed to consumer
                out = ("raise", e)
            with cond:
                results[idx] = out
                if range_worker_out is not None:
                    range_worker_out[idx] = w.idx
                cond.notify_all()
            if out[0] == "raise":
                return

    threads = [threading.Thread(target=drive, args=(w,), daemon=True)
               for w in workers]
    for t in threads:
        t.start()
    try:
        for i in range(len(ranges)):
            with cond:
                state["yield_ptr"] = i
                cond.notify_all()
                while i not in results:
                    if not any(t.is_alive() for t in threads):
                        raise RuntimeError(
                            f"all range workers exited before producing "
                            f"range {i}/{len(ranges)}")
                    cond.wait(timeout=0.5)
                status, payload = results.pop(i)
                cond.notify_all()          # backlog shrank: unpark workers
            if status == "raise":
                raise payload
            yield payload
    finally:
        # on early exit, stop handing out new tasks AND wait for in-flight
        # ranges to finish on their workers before returning: a consumer
        # that raises mid-stream (checkpoint kill, write error) would
        # otherwise leave drive threads blocked in pickle.load on worker
        # stdouts while the NEXT run reuses the same pool
        with cond:
            state["stop"] = True
            pending.clear()
            cond.notify_all()
        for t in threads:
            t.join()
