"""Build the CUDA kernels of ``csrc/`` at first use and load them.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface, for Hopper (``sm_90a``), into ``_kernels/`` beside this package
(git-ignored).  The library's name carries a hash of the sources and flags,
so an edited source is rebuilt and a stale build is never loaded.  The
library is loaded with ``ctypes``; pointers and the stream are passed as
``c_void_p``, and every entry point returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# what the last build printed (ptxas register/shared-memory report) and took
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                           "of clair3_tpu_torch build only on a CUDA host")
    return path


def _sources(ext: str):
    return sorted(glob.glob(os.path.join(CSRC, f"*.{ext}")))


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources("cu") + _sources("cuh"):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    return os.path.join(BUILD_DIR, f"libclair3t_torch_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless this exact build exists; returns its path."""
    global build_log, build_seconds
    path = _library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.time()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources("cu")],
                          capture_output=True, text=True)
    build_seconds = time.time() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, path)  # never load a half-written library
    return path


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernel library, with its C signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.clair3t_pileup_full.argtypes = (
                [i, i] + [vp] * 15 + [i] * 8 + [i] * 5 + [vp])
            lib.clair3t_pileup_full.restype = i
            lib.clair3t_cuda_error_string.argtypes = [i]
            lib.clair3t_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero CUDA error code from an entry point."""
    if rc != 0:
        msg = load_library().clair3t_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
