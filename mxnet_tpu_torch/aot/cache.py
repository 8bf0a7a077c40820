"""Compile-cache manager over the port's nvcc build directory.

The port of ``mxnet_tpu/aot/cache.py``.  The reference wires jax's
persistent XLA cache; the port's compile step is its own nvcc build of
each kernel library (``_build.build_library``: one hash-named ``.so`` a
library, found again by name), so the cache is that directory and this
module is its policy, behind the reference's env var::

  MXTPU_COMPILE_CACHE=/var/cache/mxtpu   # auto-enabled at import

- libraries land under a ``nvcc-<release>-<target>/`` subdirectory
  (``_build.namespace()``, e.g. ``nvcc-12.9-sm_90a``), the counterpart
  of the reference's ``jax-<version>/``: a toolkit upgrade starts a
  fresh namespace and :meth:`prune` drops the stale one wholesale once
  it has been idle for :data:`STALE_NAMESPACE_DAYS`;
- entries are libraries, evicted oldest-access-first down to
  ``MXTPU_COMPILE_CACHE_MAX_BYTES`` / ``MXTPU_COMPILE_CACHE_MAX_ENTRIES``
  at enable time and after every put; a library's access stamp is its
  mtime, which a hit in ``build_library`` touches (jax's ``-atime``
  companion's role);
- ``MXTPU_COMPILE_CACHE_MIN_COMPILE_SECS`` stays 0: a value above it
  raises (:data:`MIN_SECS_REASON`);
- cache traffic shows as ``mxtpu_compile_cache_{hits,misses,puts}``
  (``telemetry/cudamon.py``), :meth:`statusz` as ``aot.compile_cache``
  on ``/statusz``, and :meth:`snapshot_to` writes a
  ``metrics.jsonl``-shaped line.

``MXTPU_TORCH_BUILD_DIR`` names a plain, unmanaged build directory;
setting it beside ``MXTPU_COMPILE_CACHE`` raises (no silent precedence).
Enabling reads a few files and builds nothing, so import needs no nvcc;
on a machine without nvcc the namespace is the one used last under the
directory, whose libraries load (they cannot be built there).
A library pruned while another process is about to load it is built
again by that process (``_build.load_library``); one already loaded
stays mapped.
"""

from __future__ import annotations

import json
import os
import time

from .. import _build
from ..base import env_int

__all__ = ["CompileCacheManager", "enable", "enable_from_env", "active",
           "check_env", "ENV_DIR", "ENV_MAX_BYTES", "ENV_MAX_ENTRIES",
           "ENV_MIN_SECS"]

ENV_DIR = "MXTPU_COMPILE_CACHE"
ENV_MAX_BYTES = "MXTPU_COMPILE_CACHE_MAX_BYTES"
ENV_MAX_ENTRIES = "MXTPU_COMPILE_CACHE_MAX_ENTRIES"
ENV_MIN_SECS = "MXTPU_COMPILE_CACHE_MIN_COMPILE_SECS"
# the reference keeps XLA compiles faster than the threshold out of its
# cache; every entry here is a whole nvcc library, seconds to build
MIN_SECS_REASON = (
    f"{ENV_MIN_SECS} above 0 is not supported by the port: every cache "
    "entry is an nvcc kernel library that takes seconds to build, so "
    "keeping fast builds out would only turn loads into rebuilds")

_active = None


def active():
    """The process-wide manager installed by :func:`enable`, or None."""
    return _active


def check_env():
    """Raise when ``MXTPU_TORCH_BUILD_DIR`` is set beside the managed
    cache: both would name where the kernel libraries go."""
    if os.environ.get(_build.ENV_BUILD_DIR):
        raise ValueError(
            f"{ENV_DIR} (the managed compile cache) and "
            f"{_build.ENV_BUILD_DIR} (a plain build directory) are both "
            "set: each names where the kernel libraries go; set one")


def _is_entry(name):
    return name.startswith("lib") and name.endswith(".so")


def _namespace(base_dir):
    """This toolkit's namespace under ``base_dir``; without nvcc, which
    can load but not build, the namespace of this target used last."""
    if _build._find_nvcc() is None:
        suffix = f"-{_build.TARGET}"
        try:
            names = [n for n in os.listdir(base_dir)
                     if n.startswith("nvcc-") and n.endswith(suffix)
                     and os.path.isdir(os.path.join(base_dir, n))]
        except OSError:
            names = []
        if names:
            return max(names, key=lambda n: CompileCacheManager._newest_mtime(
                os.path.join(base_dir, n)))
    return _build.namespace()


class CompileCacheManager:
    """Polices the nvcc build directory as a compile cache.

    Construction only records the policy; :meth:`enable` makes the
    managed namespace the process's build directory (idempotent).
    """

    # how long an unused sibling toolkit namespace survives: a rolling
    # deploy / rollback window keeps BOTH toolkits' libraries warm
    # (their files keep getting touched); only a namespace nothing has
    # written or read for this long is truly retired
    STALE_NAMESPACE_DAYS = 14

    def __init__(self, dir, max_bytes=-1, max_entries=0,
                 min_compile_secs=0.0):
        if float(min_compile_secs) > 0:
            raise ValueError(MIN_SECS_REASON)
        self.base_dir = str(dir)
        self.namespace = _namespace(self.base_dir)
        self.dir = os.path.join(self.base_dir, self.namespace)
        self.max_bytes = int(max_bytes)      # -1 = unlimited
        self.max_entries = int(max_entries)  # 0  = unlimited
        self.min_compile_secs = float(min_compile_secs)
        self.enabled = False

    # -- wiring ------------------------------------------------------------
    def enable(self):
        """Make the managed namespace the build directory of this
        process (``_build.build_dir()``), prune it, and register the
        ``/statusz`` provider."""
        global _active

        check_env()
        os.makedirs(self.dir, exist_ok=True)
        self.enabled = True
        _active = self
        self.prune()
        # a strong ref is deliberate: the active manager is a process
        # singleton (enable() replaces _active AND, via the fixed name
        # here, the provider)
        from ..telemetry import statusz

        statusz.register("aot.compile_cache", self.statusz)
        return self

    # -- inspection --------------------------------------------------------
    def _entries(self):
        """[(library_path, mtime, bytes)] oldest-access first (a hit
        touches the library's mtime)."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        out = []
        for n in names:
            if not _is_entry(n):
                continue
            path = os.path.join(self.dir, n)
            try:
                st = os.stat(path)
            except OSError:
                continue               # raced with another prune
            out.append((path, st.st_mtime, st.st_size))
        out.sort(key=lambda t: t[1])
        return out

    def stats(self):
        entries = self._entries()
        return {"dir": self.dir, "entries": len(entries),
                "bytes": sum(s for _, _, s in entries),
                "max_bytes": self.max_bytes,
                "max_entries": self.max_entries}

    def statusz(self):
        """/statusz provider: on-disk stats plus the
        ``mxtpu_compile_cache_{hits,misses,puts}`` counters (zero when
        telemetry is disabled), read family by family."""
        from .. import telemetry

        out = dict(self.stats(), enabled=self.enabled)
        reg = telemetry.registry()
        for short, help in (("hits", "persistent compile-cache hits"),
                            ("misses", "persistent compile-cache misses"),
                            ("puts", "persistent compile-cache writes")):
            out[short] = reg.counter(f"mxtpu_compile_cache_{short}",
                                     help).labels().value
        return out

    # -- eviction ----------------------------------------------------------
    def prune(self):
        """Evict oldest-access-first down to the entry/byte budgets and
        drop ``nvcc-*`` toolkit namespaces idle for
        :data:`STALE_NAMESPACE_DAYS`.  Returns the number of files
        removed."""
        removed = 0
        # compared against filesystem mtimes, which are wall-clock
        cutoff = time.time() - self.STALE_NAMESPACE_DAYS * 86400
        try:
            for n in os.listdir(self.base_dir):
                p = os.path.join(self.base_dir, n)
                if (n.startswith("nvcc-") and os.path.isdir(p)
                        and p != self.dir
                        and self._newest_mtime(p) < cutoff):
                    removed += self._drop_tree(p)
        except OSError:
            pass
        entries = self._entries()
        total = sum(s for _, _, s in entries)
        over_count = (len(entries) - self.max_entries
                      if self.max_entries else 0)
        for path, _, size in entries:
            over_bytes = self.max_bytes > 0 and total > self.max_bytes
            if over_count <= 0 and not over_bytes:
                break
            try:
                os.remove(path)        # a mapped library stays mapped
            except OSError:
                pass
            total -= size
            over_count -= 1
            removed += 1
        return removed

    @staticmethod
    def _newest_mtime(path):
        """Most recent mtime under ``path`` (the dir itself counts —
        an empty namespace still ages out)."""
        newest = 0.0
        try:
            newest = os.path.getmtime(path)
            for root, _, files in os.walk(path):
                for f in files:
                    try:
                        newest = max(newest, os.path.getmtime(
                            os.path.join(root, f)))
                    except OSError:
                        pass
        except OSError:
            pass
        return newest

    @staticmethod
    def _drop_tree(path):
        removed = 0
        for root, dirs, files in os.walk(path, topdown=False):
            for f in files:
                try:
                    os.remove(os.path.join(root, f))
                    removed += 1
                except OSError:
                    pass
            for d in dirs:
                try:
                    os.rmdir(os.path.join(root, d))
                except OSError:
                    pass
        try:
            os.rmdir(path)
        except OSError:
            pass
        return removed

    # -- telemetry snapshot ------------------------------------------------
    def snapshot_to(self, path=None):
        """Append one ``metrics.jsonl``-shaped line (the registry
        snapshot schema ``tools/metrics_report.py`` reads) describing
        the cache: on-disk entry/byte gauges plus the
        ``mxtpu_compile_cache_*`` counters collected so far.  Default
        path: ``<cache dir>/cache_stats.jsonl``."""
        from .. import telemetry

        st = self.stats()
        metrics = {
            "mxtpu_compile_cache_dir_entries": {
                "kind": "gauge", "help": "persistent cache entries on disk",
                "label_names": [],
                "samples": [{"labels": {}, "value": st["entries"]}]},
            "mxtpu_compile_cache_dir_bytes": {
                "kind": "gauge", "help": "persistent cache bytes on disk",
                "label_names": [],
                "samples": [{"labels": {}, "value": st["bytes"]}]},
        }
        snap = telemetry.registry().snapshot()
        for name in ("mxtpu_compile_cache_hits", "mxtpu_compile_cache_misses",
                     "mxtpu_compile_cache_puts"):
            if name in snap:
                metrics[name] = snap[name]
        path = path or os.path.join(self.dir, "cache_stats.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps({"ts": round(time.time(), 3),
                                "metrics": metrics}) + "\n")
        return path


def enable(dir, **kw):
    """Install and enable a process-wide manager (idempotent per dir)."""
    if _active is not None and _active.base_dir == str(dir):
        return _active
    return CompileCacheManager(dir, **kw).enable()


def enable_from_env():
    """``MXTPU_COMPILE_CACHE=<dir>`` auto-enable hook (package import).
    Returns the manager, or None when the env var is unset; raises
    ``ValueError`` when ``MXTPU_TORCH_BUILD_DIR`` is set too."""
    d = os.environ.get(ENV_DIR)
    if not d:
        return None
    min_secs = os.environ.get(ENV_MIN_SECS)
    return enable(
        d,
        max_bytes=env_int(ENV_MAX_BYTES, -1),
        max_entries=env_int(ENV_MAX_ENTRIES, 0),
        min_compile_secs=float(min_secs) if min_secs else 0.0,
    )
