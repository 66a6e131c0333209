"""Build and load the port's CUDA kernels (``openpvsg_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ctypes. Libraries land in the
git-ignored ``openpvsg_torch/build/kernels/``, named by a hash of the source
and flags, so an edited source is rebuilt and a stale library is never
loaded. Nothing is built at import: the first launch builds its library, and
``build()`` compiles several sources at once, one ``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build", "kernels")
SOURCES = ("fpn", "fusion", "window_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of openpvsg_torch "
                       "are built on a machine with the CUDA toolkit")


def _source(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    with open(_source(name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, all nvcc
    processes at once. Returns {name: ptxas report}; raises with the
    compiler's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, _source(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate(timeout=900)
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib

