"""Worker-process main for the port's window-range pool (core/procpool.py):
the counterpart of longcalld_tpu/core/procworker.py, with the same pickle
protocol and the same fd-1 redirect.

Runs as ``python -m longcalld_torch.core.procworker``.  Each worker owns
its file-handle set and processes contiguous window ranges.  A host-only
worker is launched with ``CUDA_VISIBLE_DEVICES=""`` and can open no CUDA
context; a device worker is launched with ``CUDA_VISIBLE_DEVICES`` naming
its card and runs the band kernels and the phasing EM on the torch device
its context names (``"cuda:0"``: the one card it sees).

Protocol (one pickled tuple per message):
  ("warm",)                        -> no reply; pre-imports the pipeline so
                                      the first range doesn't pay import
                                      latency
  ("ctx", cid, opt, wins, device)  -> no reply; installs the shared per-run
                                      context (options, full window plan,
                                      torch device string or None)
  ("run", cid, first_k, count)     -> ("ok", per-window results) or
                                      ("err", traceback string)
  ("exit",)                        -> worker exits
"""

from __future__ import annotations

import os
import pickle
import sys
import traceback


def main() -> None:
    # Claim the protocol channel, then point fd 1 at stderr so any stray
    # print from library code cannot corrupt the pickle stream.
    proto_fd = os.dup(1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    inp = os.fdopen(0, "rb")
    outp = os.fdopen(proto_fd, "wb")

    ctxs: dict = {}
    while True:
        try:
            msg = pickle.load(inp)
        except EOFError:
            return
        kind = msg[0]
        if kind == "warm":
            try:
                import longcalld_torch.core.pipeline  # noqa: F401
            except Exception:
                pass          # the first "run" re-imports and reports it
            continue
        if kind == "ctx":
            _, cid, opt, wins, device = msg
            ctxs.clear()           # one live run per worker
            ctxs[cid] = (opt, wins, device)
            continue
        if kind == "run":
            _, cid, first_k, count = msg
            try:
                from longcalld_torch.core.pipeline import _range_worker
                opt, wins, device = ctxs[cid]
                res = ("ok", _range_worker((opt, wins, first_k, count,
                                            device)))
            except BaseException:
                # SystemExit / KeyboardInterrupt from a range too: reply and
                # stay in the pool, as the reference worker does
                res = ("err", traceback.format_exc())
            pickle.dump(res, outp, protocol=pickle.HIGHEST_PROTOCOL)
            outp.flush()
            continue
        if kind == "exit":
            return


if __name__ == "__main__":
    main()
