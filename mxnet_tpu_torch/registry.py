"""Generic named registries (the port's copy of ``mxnet_tpu/registry.py``).

Rebuild of dmlc-core's registry facility (used by the reference for
operators, NDArray functions, data iterators, optimizers and kvstores —
e.g. src/operator/operator.cc:11-22).  Registries are what make the op
surface *runtime-discoverable*: the Python NDArray/Symbol modules generate
their functions by enumerating a registry, exactly as the reference's
frontends enumerate ``MXSymbolListAtomicSymbolCreators``.
"""

from __future__ import annotations

__all__ = ["Registry"]


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict = {}

    def register(self, name=None, entry=None, aliases=()):
        """Register an entry, usable directly or as a decorator."""

        def _do(entry, name=name):
            key = name if name is not None else getattr(entry, "__name__", None)
            if key is None:
                raise ValueError(f"{self.kind} registry: cannot infer name")
            lname = key.lower()
            if lname in self._entries and self._entries[lname] is not entry:
                raise ValueError(f"{self.kind} registry: duplicate entry {key!r}")
            self._entries[lname] = entry
            for alias in aliases:
                self._entries[alias.lower()] = entry
            return entry

        if entry is not None:
            return _do(entry)
        if callable(name) and not isinstance(name, str):
            entry, name = name, None
            return _do(entry, None)
        return _do

    def get(self, name: str):
        key = name.lower()
        if key not in self._entries:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: {sorted(set(self._entries))}"
            )
        return self._entries[key]

    def remove(self, name: str):
        """Drop an entry (used to evict transient process-local ops)."""
        self._entries.pop(name.lower(), None)

    def find(self, name: str):
        return self._entries.get(name.lower())

    def __contains__(self, name):
        return name.lower() in self._entries

    def list(self):
        return sorted(self._entries)

    def items(self):
        return self._entries.items()
