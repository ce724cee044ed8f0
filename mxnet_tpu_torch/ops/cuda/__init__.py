"""Hand-written CUDA kernels: build and load.

Each kernel's source lives under ``mxnet_tpu_torch/csrc/``. At first use
``load_library`` compiles it with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface under ``build/`` at the root of the
checkout, and loads it with ``ctypes``. A library is rebuilt when one of its
sources, or any header ``csrc/*.cuh`` (which the sources include), is newer
than it. Nothing is compiled when a module is imported, so the
CPU tests import every module on a host without ``nvcc``; there a kernel's
wrapper only ever takes its plain PyTorch version, for CPU tensors.

``build_info`` keeps, for each library built in this process, the seconds
``nvcc`` took and what ``ptxas -v`` printed (registers, shared memory and
spills of every kernel).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

from ...base import MXNetError

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise MXNetError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                     "the CUDA kernels are built at first use on the GPU host")


def build(name: str, sources: Sequence[str]) -> Path:
    """Compile ``csrc/<sources>`` into ``build/lib<name>.so`` if stale: if a
    source or any ``csrc/*.cuh`` header is newer than the library."""
    srcs = [CSRC_DIR / s for s in sources]
    so = BUILD_DIR / f"lib{name}.so"
    inputs = srcs + sorted(CSRC_DIR.glob("*.cuh"))
    if so.exists() and so.stat().st_mtime >= max(f.stat().st_mtime for f in inputs):
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise MXNetError(f"nvcc failed building {name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builders never load a torn file
    build_info[name] = {"seconds": seconds, "ptxas": proc.stderr}
    return so


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """The loaded library ``name``, built from ``sources`` at first use.
    Different libraries build concurrently when loaded from several threads."""
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, sources)))
            _libs[name] = lib
        return lib
