"""Traffic-replay warmup manifests.

A bucketed engine runs one program per (kind, bucket) it actually
serves: which shapes those are is a property of the *traffic*, not the
config.  The manifest captures it: one JSONL line per distinct program
the engine executed, appended live while serving (opt-in via
``MXTPU_WARMUP_MANIFEST=<path>``)::

  {"kind": "prefill", "bucket": 32}
  {"kind": "decode", "bucket": 4}

A restarted process replays it through ``Engine.warmup(manifest)`` before
admitting traffic, so the first unlucky request never pays a program
build (on CUDA, a graph capture).  Lines also carry a ``spec`` digest of
the recording engine's program key (:func:`digest` of
:func:`fingerprint`); replay ignores entries recorded by an
incompatibly-configured engine, or by another torch or card, instead of
building programs the new config can never serve.

The port of ``mxnet_tpu/aot/warmup.py``: the same lines, dedup, torn-line
skip and env resolution, so a manifest written by either package's
recorder loads in the other's :func:`load_manifest`.
"""

from __future__ import annotations

import hashlib
import json
import os

__all__ = ["ManifestRecorder", "load_manifest", "fingerprint", "digest",
           "ENV_MANIFEST", "FORMAT"]

ENV_MANIFEST = "MXTPU_WARMUP_MANIFEST"
FORMAT = "mxtpu_torch.program.v1"


def fingerprint(device="cpu", **fields):
    """Canonical fingerprint dict of a program family: caller fields
    plus format, ``torch.__version__`` and ``device`` as its CUDA name
    and compute capability, or ``"cpu"``.  Everything must be
    JSON-stable (tuples arrive as lists, which is fine as long as
    producers and consumers build the dict the same way)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        cap = torch.cuda.get_device_capability(idx)
        name = f"{torch.cuda.get_device_name(idx)} sm_{cap[0]}{cap[1]}"
    else:
        name = "cpu"
    fp = {"format": FORMAT, "torch_version": torch.__version__,
          "device": name}
    fp.update(fields)
    return fp


def digest(fp):
    """Stable hex digest of a fingerprint dict (manifest ``spec``
    stamps)."""
    return hashlib.sha256(
        json.dumps(fp, sort_keys=True, default=str).encode()).hexdigest()


class ManifestRecorder:
    """Dedup-and-append recorder for one engine's program hits.

    In-memory always (``entries()`` feeds ``Engine.save_manifest``);
    mirrored to ``path`` as JSONL when one is given.  Append-per-line
    keeps concurrent engines on one file safe: dedup is per recorder,
    replay dedups again on load.
    """

    def __init__(self, spec_digest, path=None):
        self.spec = spec_digest
        self.path = path
        self._seen = {}

    def record(self, kind, bucket):
        key = (str(kind), int(bucket))
        if key in self._seen:
            return False
        entry = {"kind": key[0], "bucket": key[1], "spec": self.spec}
        self._seen[key] = entry
        if self.path:
            try:
                with open(self.path, "a") as f:
                    f.write(json.dumps(entry) + "\n")
            except OSError:
                self.path = None       # never let recording break serving
        return True

    def entries(self):
        return list(self._seen.values())


def load_manifest(source, spec_digest=None):
    """Normalize a manifest ``source`` into deduped (kind, bucket)
    entries.

    ``source`` may be a path (JSONL file), an iterable of entry dicts
    (e.g. another engine's ``manifest()``), or None, which resolves
    ``MXTPU_WARMUP_MANIFEST`` and yields [] when unset/absent.  Entries
    recorded under a different ``spec`` digest are skipped when the
    caller passes its own (an old manifest must not force programs the
    current engine cannot serve); entries with no spec are trusted
    (hand-written grids).
    """
    if source is None:
        source = os.environ.get(ENV_MANIFEST)
        if not source:
            return []
    if isinstance(source, (str, os.PathLike)):
        try:
            with open(source) as f:
                lines = f.readlines()
        except OSError:
            return []
        raw = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                raw.append(json.loads(line))
            except ValueError:
                continue               # torn tail line of a live file
    else:
        raw = list(source)
    out, seen = [], set()
    for e in raw:
        try:
            kind = str(e["kind"])
            bucket = int(e["bucket"])
        except (TypeError, KeyError, ValueError):
            continue
        if (spec_digest is not None and e.get("spec") is not None
                and e["spec"] != spec_digest):
            continue
        if (kind, bucket) in seen:
            continue
        seen.add((kind, bucket))
        out.append({"kind": kind, "bucket": bucket})
    return out
