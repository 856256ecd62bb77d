"""On-demand C builds for the native fast paths.

Compiles into a per-thread temp file and os.replace's it into place:
concurrent loader threads (the stage-0 window pool warms several native
paths at once on a fresh checkout) must never ctypes.CDLL a partially
written library.
"""

from __future__ import annotations

import os
import subprocess
import threading


def build_so(src: str, so: str, flags=("-O3", "-march=native")) -> bool:
    """Ensure ``so`` is up to date with ``src`` and the requested flags
    (a .flags stamp forces a rebuild when the flag set changes).  Builds
    happen on the machine that runs the library, so -march=native is safe
    and lets the compiler vectorize the DP row passes.  Falls back to a
    flagless build if the toolchain rejects the flags; returns False when
    no usable library could be produced (callers fall back to Python)."""
    stamp = so + ".flags"
    want = " ".join(flags)
    try:
        if (os.path.exists(so)
                and os.path.getmtime(so) >= os.path.getmtime(src)):
            try:
                with open(stamp) as f:
                    if f.read() == want:
                        return True
            except OSError:
                pass
    except OSError:
        return False
    tmp = f"{so}.tmp{os.getpid()}.{threading.get_ident()}"
    for use in (flags, ("-O3",)):
        try:
            subprocess.run(["gcc", *use, "-fPIC", "-shared", "-o", tmp,
                            src], check=True, capture_output=True)
            os.replace(tmp, so)
            try:
                # record the REQUESTED flag set even after a fallback
                # build, so a toolchain that rejects -march=native is not
                # re-probed on every call
                with open(stamp + f".tmp{os.getpid()}", "w") as f:
                    f.write(want)
                os.replace(stamp + f".tmp{os.getpid()}", stamp)
            except OSError:
                pass
            return True
        except Exception:
            continue
    try:
        os.unlink(tmp)
    except OSError:
        pass
    return os.path.exists(so)
