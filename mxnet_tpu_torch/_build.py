"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` for ``sm_90a`` from the sources
under ``mxnet_tpu_torch/csrc/`` into a plain-C-interface ``.so`` and
loaded with ``ctypes``.  Nothing is built when a module is imported:
the first launch builds, so the CPU test run, which never launches a
kernel, needs no ``nvcc``.

Keep the ``a`` in ``sm_90a``: ``wgmma`` and ``setmaxnreg`` exist only
for that target, and plain ``sm_90`` refuses them.

Libraries land in ``MXTPU_TORCH_BUILD_DIR`` (default ``build/`` at the
root of the checkout, which ``.gitignore`` lists), named by a hash of
their sources and flags, so a changed source rebuilds and an unchanged
one loads the existing library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["build_dir", "build_library", "load_library", "BUILD_SECONDS",
           "BUILD_LOGS"]

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# seconds each library took to build in this process (absent: loaded
# from an earlier build), and nvcc's output (ptxas register/smem report)
BUILD_SECONDS = {}
BUILD_LOGS = {}
_LOADED = {}
_LOCK = threading.Lock()
_LIB_LOCKS = {}     # one per library, so two libraries build in parallel


def build_dir():
    return os.environ.get("MXTPU_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(PKG_DIR), "build", "mxnet_tpu_torch")


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH): the CUDA kernels are built at first use")


def build_library(name, sources):
    """Path of ``lib<name>-<hash>.so`` built from ``sources`` (file
    names under ``csrc/``), compiling it if it does not exist yet."""
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    out_dir = build_dir()
    lib = os.path.join(out_dir, f"lib{name}-{h.hexdigest()[:12]}.so")
    if os.path.isfile(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name} "
                           f"(rc {res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOGS[name] = res.stdout + res.stderr
    return lib


def load_library(name, sources):
    """The ``ctypes.CDLL`` of library ``name``, built on first call.
    Different libraries may build at once from different threads."""
    with _LOCK:
        lock = _LIB_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_library(name, sources))
            _LOADED[name] = lib
        return lib
