"""Exported-program store: serialized ``torch.export`` programs on disk.

The port of ``mxnet_tpu/aot/export_store.py``.  The compile cache
(cache.py) removes the *nvcc build* from a restart; this store removes
the *trace*.  An artifact is one file holding a JSON fingerprint header
plus the ``torch.export.save`` bytes of an ``ExportedProgram`` (the
serve engine's bucketed program bodies, with parameters, caches and
adapter stacks as inputs: an artifact holds no weights).  A restarted
process that finds a matching artifact loads it and runs its
``.module()``: no Python re-trace of the model.  On CUDA that module is
then captured as a CUDA graph, as a traced body is; the graph itself
is bound to its process's device addresses and is never stored.

Staleness is fingerprint-keyed, never versioned by hand: the
fingerprint folds in the artifact format, the torch version, the
device (card name and ``sm_XY``, or ``"cpu"``) and the caller's own
program key.  Any mismatch (moved checkpoint, dtype change, torch
upgrade, truncated file) makes :meth:`ExportStore.load` return None and
the caller traces fresh, counted by kind in ``mxtpu_aot_errors_total``:
a stale artifact can delay a start, never corrupt one.

Layout under ``MXTPU_AOT_DIR``::

  <dir>/<label>-<fp16>.ptexport     # magic, header length, header, blob
"""

from __future__ import annotations

import io
import json
import os

from .. import telemetry
from .warmup import digest
from .warmup import fingerprint as _program_fingerprint

__all__ = ["ExportStore", "fingerprint", "digest", "default_store",
           "ENV_DIR", "FORMAT", "cache_copies"]

ENV_DIR = "MXTPU_AOT_DIR"
FORMAT = "mxtpu_torch.aot.v1"
SUFFIX = ".ptexport"

_MAGIC = b"MXTTAOT1"


def fingerprint(device="cpu", **fields):
    """Canonical fingerprint dict for an artifact: the caller's fields
    plus this store's format, ``torch.__version__`` and ``device`` as
    ``aot.fingerprint`` names it.  Everything must be JSON-stable."""
    fp = _program_fingerprint(device)
    fp["format"] = FORMAT
    fp.update(fields)
    return fp


def _counter(name, help):
    # fetched per call (not cached at construction) so stores built
    # before telemetry.enable() still record afterwards
    return telemetry.counter(name, help, ("kind",))


def _error(kind):
    _counter("mxtpu_aot_errors_total",
             "AOT artifact failures").labels(kind=kind).inc()


class ExportStore:
    """Directory of fingerprint-keyed serialized ``ExportedProgram``s."""

    def __init__(self, dir):
        self.dir = str(dir)

    def path_for(self, fp, label="program"):
        return os.path.join(self.dir, f"{label}-{digest(fp)[:16]}{SUFFIX}")

    # -- write -------------------------------------------------------------
    def save(self, fp, exported, label="program"):
        """Serialize ``exported`` under fingerprint ``fp``; an atomic
        rename, so a crashed writer cannot leave a torn artifact.
        Returns the path, or None when serialization or the write failed
        (saving is an optimization, never a hard failure; counted)."""
        import torch

        buf = io.BytesIO()
        try:
            torch.export.save(exported, buf)
        except Exception:
            _error("serialize")
            return None
        header = json.dumps({"fingerprint": fp}, sort_keys=True,
                            default=str).encode()
        path = self.path_for(fp, label)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            os.makedirs(self.dir, exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(_MAGIC + len(header).to_bytes(8, "little"))
                f.write(header)
                f.write(buf.getvalue())
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            _error("write")
            return None
        _counter("mxtpu_aot_saves_total",
                 "AOT artifacts written").labels(kind=label).inc()
        return path

    # -- read --------------------------------------------------------------
    def load(self, fp, label="program"):
        """The ``ExportedProgram`` stored for fingerprint ``fp``, or None:
        missing (the common miss, not counted), stale (a header whose
        fingerprint differs) or corrupt (bad magic, truncation, a blob
        ``torch.export.load`` refuses), each counted by kind."""
        import torch

        path = self.path_for(fp, label)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return None
        try:
            if raw[:len(_MAGIC)] != _MAGIC:
                raise ValueError("bad magic")
            n = int.from_bytes(raw[len(_MAGIC):len(_MAGIC) + 8], "little")
            header_end = len(_MAGIC) + 8 + n
            header = json.loads(raw[len(_MAGIC) + 8:header_end])
            # digests, not dict equality: the header went through JSON
            # (tuples are lists now), which digest() canonicalizes
            if digest(header.get("fingerprint", {})) != digest(fp):
                _error("stale")
                return None
            exported = torch.export.load(io.BytesIO(raw[header_end:]))
        except Exception:
            _error("corrupt")
            return None
        _counter("mxtpu_aot_loads_total",
                 "AOT artifacts loaded").labels(kind=label).inc()
        return exported

    def entries(self):
        """[(path, bytes)] of the artifacts in the store."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        out = []
        for n in sorted(names):
            if n.endswith(SUFFIX):
                p = os.path.join(self.dir, n)
                try:
                    out.append((p, os.path.getsize(p)))
                except OSError:
                    pass
        return out


def default_store():
    """The env-configured store (``MXTPU_AOT_DIR``), or None; resolved
    per call so tests and late exports can flip the env var."""
    d = os.environ.get(ENV_DIR)
    return ExportStore(d) if d else None


_COPIES = ("copy_", "copy", "clone", "_to_copy", "index_put",
           "index_copy")


def cache_copies(module, cache_numel):
    """The nodes of an exported program's graph module that copy a
    tensor of at least ``cache_numel`` elements: ``aten.copy_``,
    ``clone``, ``_to_copy`` and the out-of-place ``index_put``/
    ``index_copy`` that a functionalized cache write becomes.  A
    program that writes its caches in place has none (its writes are
    ``index_put_``/``index_copy_`` on the inputs themselves); an
    exported program run through ``run_decompositions()`` writes a new
    cache and copies it back, and shows here.  Returns the offending
    node names."""
    import torch

    bad = []
    for node in module.graph.nodes:
        if node.op != "call_function":
            continue
        name = getattr(node.target, "__name__", str(node.target))
        base = name.split(".")[0]
        if base not in _COPIES:
            continue
        vals = [node.meta.get("val")]
        vals += [getattr(a, "meta", {}).get("val") for a in node.args
                 if hasattr(a, "meta")]
        if any(torch.is_tensor(v) and v.numel() >= cache_numel
               for v in vals):
            bad.append(node.name)
    return bad
