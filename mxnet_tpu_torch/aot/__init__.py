"""AOT startup: make a process restart cheap.

The port of ``mxnet_tpu/aot/``, in two layers:

- :mod:`cache` — the compile-cache manager over the nvcc build
  directory behind ``MXTPU_COMPILE_CACHE=<dir>`` (auto-enabled at
  import): kernel builds become library loads across processes, under
  a toolkit namespace, with eviction and ``aot.compile_cache`` on
  ``/statusz``.
- :mod:`warmup` — records the (kind, bucket) programs live traffic hit
  (``MXTPU_WARMUP_MANIFEST``); ``serve.Engine.warmup()`` replays them
  before traffic, building (on CUDA, capturing as a CUDA graph) every
  program ahead of the first request.  :func:`fingerprint` and
  :func:`digest` stamp each line with the recording engine's program
  key, torch version and card.

Not ported (ROADMAP §A item 12): the export store, since a CUDA graph is
bound to its process's device addresses and cannot be stored.
"""

from __future__ import annotations

from . import cache, warmup
from .cache import CompileCacheManager
from .warmup import (ENV_MANIFEST, ManifestRecorder, digest, fingerprint,
                     load_manifest)

__all__ = ["cache", "warmup", "CompileCacheManager", "ManifestRecorder",
           "load_manifest", "fingerprint", "digest", "ENV_MANIFEST",
           "enable_from_env"]


def enable_from_env():
    """Apply the env-var wiring (called from ``mxnet_tpu_torch/__init__``):
    ``MXTPU_COMPILE_CACHE`` enables the compile-cache manager.  The
    manifests resolve their env var lazily at use."""
    return cache.enable_from_env()
