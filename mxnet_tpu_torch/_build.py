"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` for ``sm_90a`` from the sources
under ``mxnet_tpu_torch/csrc/`` into a plain-C-interface ``.so`` and
loaded with ``ctypes``: one ``nvcc -c`` per ``.cu`` source, all started
together, then one link (headers listed among the sources are hashed,
not compiled).  Nothing is built when a module is imported:
the first launch builds, so the CPU test run, which never launches a
kernel, needs no ``nvcc``.

Keep the ``a`` in ``sm_90a``: ``wgmma`` and ``setmaxnreg`` exist only
for that target, and plain ``sm_90`` refuses them.

Libraries land in ``MXTPU_TORCH_BUILD_DIR`` (default ``build/`` at the
root of the checkout, which ``.gitignore`` lists), or, with
``MXTPU_COMPILE_CACHE`` set, in the toolkit's namespace of that managed
cache (``aot/cache.py``; setting both raises).  A library is named by a
hash of its sources and flags and by the toolkit (:func:`toolkit_tag`),
so a changed source or another nvcc rebuilds and an unchanged one loads
the existing library; a load touches its mtime, the cache's access
stamp.  A machine without nvcc loads the library of the same sources
and flags used last, whatever toolkit built it, and cannot build.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = ["build_dir", "build_library", "load_library", "toolkit_tag",
           "namespace", "BUILD_SECONDS", "BUILD_LOGS", "ENV_BUILD_DIR"]

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
TARGET = "sm_90a"
ENV_BUILD_DIR = "MXTPU_TORCH_BUILD_DIR"

# seconds each library took to build in this process (absent: loaded
# from an earlier build), and nvcc's output (ptxas register/smem report)
BUILD_SECONDS = {}
BUILD_LOGS = {}
_LOADED = {}
_LOCK = threading.Lock()
_LIB_LOCKS = {}     # one per library, so two libraries build in parallel


def build_dir():
    """Where libraries are built and found: the active compile cache's
    namespace, else ``MXTPU_TORCH_BUILD_DIR``, else the checkout's
    ``build/mxnet_tpu_torch``."""
    from .aot import cache

    mgr = cache.active()
    if mgr is not None:
        cache.check_env()
        return mgr.dir
    return os.environ.get(ENV_BUILD_DIR) or os.path.join(
        os.path.dirname(PKG_DIR), "build", "mxnet_tpu_torch")


def _find_nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    return None


def _nvcc():
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels are built at first use")
    return nvcc


def toolkit_tag(nvcc=None):
    """The release of the toolkit ``nvcc`` belongs to (default: the one
    a build would run), as ``"12.9"``: from its ``version.json``, else
    the ``CUDA_VERSION`` its ``include/cuda.h`` defines (a toolkit
    installed without the version file); one with neither is told apart
    by the binary's size and mtime (``"x<hash>"``).  ``"none"`` without
    nvcc.  Reads files only: no process is started."""
    nvcc = nvcc or _find_nvcc()
    if nvcc is None:
        return "none"
    root = os.path.dirname(os.path.dirname(os.path.realpath(nvcc)))
    try:
        with open(os.path.join(root, "version.json")) as f:
            meta = json.load(f)
        ver = (meta.get("cuda_nvcc") or meta.get("cuda") or {})["version"]
        return ".".join(str(ver).split(".")[:2])
    except (OSError, ValueError, KeyError, TypeError):
        pass
    try:
        with open(os.path.join(root, "include", "cuda.h")) as f:
            m = re.search(r"#define\s+CUDA_VERSION\s+(\d+)", f.read())
        if m:
            v = int(m.group(1))                 # 12090 -> "12.9"
            return f"{v // 1000}.{v % 1000 // 10}"
    except OSError:
        pass
    st = os.stat(nvcc)
    return "x" + hashlib.sha1(
        f"{os.path.realpath(nvcc)}:{st.st_size}:{st.st_mtime_ns}".encode()
    ).hexdigest()[:8]


def namespace(nvcc=None):
    """The compile cache's subdirectory for this toolkit and target,
    e.g. ``nvcc-12.9-sm_90a``: a toolkit upgrade starts a fresh one."""
    return f"nvcc-{toolkit_tag(nvcc)}-{TARGET}"


def _touch(path):
    """Stamp a library's access (its mtime: the cache evicts
    oldest-access-first); False when it is gone (pruned meanwhile)."""
    try:
        os.utime(path)
        return True
    except OSError:
        return False


def _stem(name, sources):
    """``lib<name>-<hash of the sources and flags>``: the toolkit's tag
    follows as a suffix, so a machine without nvcc can still find what
    a toolkit built."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        with open(os.path.join(CSRC_DIR, s), "rb") as f:
            h.update(f.read())
    return f"lib{name}-{h.hexdigest()[:12]}"


def _built(out_dir, stem, nvcc):
    """The library to load for ``stem``, touched, or None: this
    toolkit's, or without nvcc the one used last of any toolkit's."""
    if nvcc is not None:
        cands = [os.path.join(out_dir, f"{stem}-{toolkit_tag(nvcc)}.so")]
    else:
        cands = sorted(glob.glob(os.path.join(glob.escape(out_dir),
                                              f"{stem}-*.so")),
                       key=os.path.getmtime, reverse=True)
    for lib in cands:
        if os.path.isfile(lib) and _touch(lib):
            return lib
    return None


def build_library(name, sources):
    """Path of ``lib<name>-<hash>-<toolkit>.so`` built from ``sources``
    (file names under ``csrc/``), compiling it if it does not exist yet.
    Loading a library already built needs no nvcc."""
    from .telemetry import cudamon

    nvcc = _find_nvcc()
    out_dir = build_dir()
    stem = _stem(name, sources)
    lib = _built(out_dir, stem, nvcc)
    if lib is not None:
        cudamon.note_build(name, hit=True)
        return lib
    nvcc = _nvcc()
    lib = os.path.join(out_dir, f"{stem}-{toolkit_tag(nvcc)}.so")
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    units = [os.path.join(CSRC_DIR, s) for s in sources if s.endswith(".cu")]
    objs = [f"{tmp}.{i}.o" for i in range(len(units))]
    runs = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, u] for u, o in zip(units, objs)]
    results = [None] * len(runs)

    def run(i):
        results[i] = subprocess.run(runs[i], capture_output=True, text=True)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(runs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    try:
        if all(r.returncode == 0 for r in results):
            results.append(subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                          capture_output=True, text=True))
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    for res in results:
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name} "
                               f"(rc {res.returncode}):\n{res.stderr}")
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOGS[name] = "".join(r.stdout + r.stderr for r in results)
    cudamon.note_build(name, hit=False, seconds=BUILD_SECONDS[name])
    os.replace(tmp, lib)
    from .aot import cache

    mgr = cache.active()
    if mgr is not None:
        mgr.prune()
    return lib


def load_library(name, sources):
    """The ``ctypes.CDLL`` of library ``name``, built on first call.
    Different libraries may build at once from different threads.  A
    library pruned between its hit and its load is built again."""
    with _LOCK:
        lock = _LIB_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LOADED.get(name)
        if lib is None:
            path = build_library(name, sources)
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                if os.path.exists(path):
                    raise
                path = build_library(name, sources)
                lib = ctypes.CDLL(path)
            _LOADED[name] = lib
        return lib
