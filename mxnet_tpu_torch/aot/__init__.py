"""Warm start for the serving engine's bucketed programs.

The port of ``mxnet_tpu/aot/``'s manifest layer: :mod:`warmup` records
the (kind, bucket) programs live traffic hit (``MXTPU_WARMUP_MANIFEST``)
and ``serve.Engine.warmup()`` replays them before traffic, building (on
CUDA, capturing as a CUDA graph) every program ahead of the first
request.  :func:`fingerprint` and :func:`digest` stamp each line with the
recording engine's program key, torch version and card.

Not ported (ROADMAP §A item 12): the export store, since a CUDA graph is
bound to its process's device addresses and cannot be stored, and the
compile-cache manager over the nvcc build directory
(``_build.build_dir()``).
"""

from __future__ import annotations

from . import warmup
from .warmup import (ENV_MANIFEST, ManifestRecorder, digest, fingerprint,
                     load_manifest)

__all__ = ["warmup", "ManifestRecorder", "load_manifest", "fingerprint",
           "digest", "ENV_MANIFEST"]
