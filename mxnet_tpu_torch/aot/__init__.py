"""AOT startup: make a process restart cheap.

The port of ``mxnet_tpu/aot/``, in two layers:

- :mod:`cache` — the compile-cache manager over the nvcc build
  directory behind ``MXTPU_COMPILE_CACHE=<dir>`` (auto-enabled at
  import): kernel builds become library loads across processes, under
  a toolkit namespace, with eviction and ``aot.compile_cache`` on
  ``/statusz``.
- :mod:`export_store` — serialized ``torch.export`` programs on disk
  (``MXTPU_AOT_DIR``): a restarted serving engine loads its bucket
  programs instead of tracing them (on CUDA it then captures the loaded
  program as a CUDA graph; the graph, bound to its process's device
  addresses, is never stored).
- :mod:`warmup` — records the (kind, bucket) programs live traffic hit
  (``MXTPU_WARMUP_MANIFEST``); ``serve.Engine.warmup()`` replays them
  before traffic, building (on CUDA, capturing as a CUDA graph) every
  program ahead of the first request.  :func:`fingerprint` and
  :func:`digest` stamp each line with the recording engine's program
  key, torch version and card.
"""

from __future__ import annotations

from . import cache, export_store, warmup
from .cache import CompileCacheManager
from .export_store import ENV_DIR, ExportStore, default_store
from .warmup import (ENV_MANIFEST, ManifestRecorder, digest, fingerprint,
                     load_manifest)

__all__ = ["cache", "export_store", "warmup", "CompileCacheManager",
           "ExportStore", "default_store", "ENV_DIR", "ManifestRecorder",
           "load_manifest", "fingerprint", "digest", "ENV_MANIFEST",
           "enable_from_env"]


def enable_from_env():
    """Apply the env-var wiring (called from ``mxnet_tpu_torch/__init__``):
    ``MXTPU_COMPILE_CACHE`` enables the compile-cache manager.  The
    manifests resolve their env var lazily at use."""
    return cache.enable_from_env()
