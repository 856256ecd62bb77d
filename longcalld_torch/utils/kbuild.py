"""On-demand nvcc build of the port's CUDA kernels (counterpart of
longcalld_tpu/utils/cbuild.py, which does the same for the host C paths).

At first use every ``longcalld_torch/csrc/*.cu`` is compiled by nvcc into
one shared library with a plain C interface, bound with ctypes (no
PyTorch headers, so a build takes seconds, not minutes).  The library
lives under ``<checkout>/build/longcalld_torch/`` and its name carries a
hash of the sources and flags, so any source or flag change rebuilds.  The
compiler writes to a per-process temp file that is ``os.replace``d into
place, so concurrent loaders never open a partial library.  A failed build
raises; so does a launch whose ``cudaError_t`` is not 0 (see ``check``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "longcalld_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (all return int, a cudaError_t)
SIGNATURES = {
    # P, Tband, plen, tlen, dlo, tbs, finals, edge_min,
    # batch, B, Lp, x, o1, e1, o2, e2, wpp, ppc, stream
    "lcd_band_fwd": [_P] * 8 + [_I] * 10 + [_P],
    # tbs, plen, tlen, dlo, finals, packed, b0, reload_count (nullable),
    # batch, B, Lp, stream
    "lcd_band_bwd": [_P] * 8 + [_I] * 3 + [_P],
}

_lock = threading.Lock()
_lib = None
build_log = ""           # nvcc's output (-Xptxas -v: registers, spills)


def _nvcc() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return cand


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"liblongcalld_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless an up-to-date library exists; return its
    path.  Raises RuntimeError with nvcc's output on failure."""
    global build_log
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{build_log}")
    os.replace(tmp, so)
    with open(so + ".log", "w") as f:
        f.write(build_log)
    return so


def load():
    """The ctypes handle of the kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch wrapper."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
