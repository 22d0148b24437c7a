"""Build and load the port's CUDA kernels at first use.

Each `csrc/*.cu` source compiles with `nvcc` for `sm_90a` into a shared
library with a plain C interface, which `ctypes` loads. The library lands
in `shifu_tpu_torch/_build/` (listed in .gitignore), named by a hash of
its source and flags, so a changed source rebuilds and an unchanged one
loads at once. Nothing is compiled when a module is imported: the CPU
tests import every module on machines without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # keep a*b+c as two rounded ops, like the plain version's separate
    # elementwise ops (bit-equal gains on integer-valued planes)
    "-fmad=false",
    "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# wall seconds and compiler output of the builds this process ran
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            p = os.path.join(cand, "bin", "nvcc")
            if os.path.exists(p):
                return p
    p = shutil.which("nvcc")
    if p is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return p


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def compile_source(name: str, out: Optional[str] = None) -> str:
    """nvcc csrc/<name>.cu -> out (default: the hashed path in _build/).
    Writes to a temporary file first and renames, so a concurrent or cut
    build never leaves a half-written library behind."""
    out = out or _lib_path(name)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    src = os.path.join(CSRC, name + ".cu")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = proc.stdout + proc.stderr
    return out


def load(name: str, rebuild: bool = False) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use (and
    compiled again when `rebuild`, before the process first loads it)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if rebuild or not os.path.exists(path):
                compile_source(name, path)
            lib = ctypes.CDLL(path)
            _LIBS[name] = lib
        return lib
