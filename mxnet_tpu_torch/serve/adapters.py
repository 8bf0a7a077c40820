"""Paged multi-tenant LoRA adapter store (S-LoRA / Punica style).

The port of ``mxnet_tpu/serve/adapters.py``.  Each adapter is a set of
low-rank ``(A, B)`` delta pairs per projection matmul, and every
projection adds ``scale * x @ A.T @ B.T`` on top of the frozen base
weight.  The deltas live in engine-owned **paged device stacks** (one
``(S, r_max, d_in)`` A-stack and one ``(S, d_out, r_max)`` B-stack per
projection stem plus an ``(S,)`` float32 scale vector), indexed by a
per-request *slot* input of the bucketed programs, so ONE program (on
CUDA one captured graph) per (kind, bucket) serves any mix of adapters:
a slot is an input, never a capture key.

The stacks are allocated once, at construction, and a load writes a
slot's rows in place (``copy_``): every program binds the stack tensors
when it is built (a graph records their addresses), so a stack must
never be rebound.  A load overwrites only a cold slot (refcount 0): no
live row reads it, and it is ordered on the stream after every program
already launched.

Slot discipline (BlockManager-style accounting):

* **slot 0 is the base model**: its A/B rows and scale are true zeros,
  so a base row's logits are ``base + 0.0``, token-identical to an
  adapters-off engine;
* slots are **content-addressed** by the sha1 digest of the adapter's
  arrays (ids are aliases onto digests: two tenants uploading the same
  weights share one slot);
* **refcounted** while any queued or running request pins them (a
  preempted request keeps its pin);
* **LRU-evicted** when cold; the host tier (numpy arrays, so digests
  and wire payloads are the reference's bytes) has its own byte budget
  and evicts registrations that are not device-resident;
* loadable at run time from **disk** (``save_file``/``load_file``, an
  ``np.savez`` container) or **over the wire**
  (``export_records``/``import_records``: base64 with a sha1 a array,
  corrupt payloads rejected).

``acquire`` raises :class:`NoAdapterSlots` when every slot is pinned,
which the engine maps to the retriable ``adapter_slots`` rejection.
Under tensor parallelism (the reference's ``shardings=``) a stack named
in ``split`` is a list of one tensor a shard, split on that dim; a load
writes each shard its piece of the slot's rows.
"""

from __future__ import annotations

import base64
import collections
import hashlib
import threading

import numpy as np
import torch

__all__ = ["AdapterStore", "NoAdapterSlots", "gpt_stems"]


class NoAdapterSlots(RuntimeError):
    """Every adapter slot is pinned by a running request (transient:
    retry once some request finishes and drops its refcount)."""


def gpt_stems(name, n_layers, swiglu, tied, params):
    """Projection-stem map ``stem -> (d_out, d_in)`` for a GPT tower,
    read from the checkpoint's ``*_weight`` shapes: the quantizer's stem
    enumeration minus the head and embedding (adapters never touch the
    tied embedding or the logits head)."""
    props = ["q", "k", "v", "proj", "ff_up", "ff_down"]
    if swiglu:
        props.append("ff_gate")
    stems = collections.OrderedDict()
    for i in range(n_layers):
        for p in props:
            stem = f"{name}_l{i}_{p}"
            w = params.get(f"{stem}_weight")
            if w is None:
                raise ValueError(f"missing projection weight: {stem}")
            stems[stem] = (int(w.shape[0]), int(w.shape[1]))
    return stems


def _digest(arrays, alpha):
    """Content address: sha1 over the sorted (stem, shape, bytes) stream
    plus the scaling alpha: byte-identical uploads under different ids
    collapse onto one digest (and one device slot)."""
    h = hashlib.sha1()
    h.update(f"alpha={float(alpha)}".encode())
    for stem in sorted(arrays):
        a, b = arrays[stem]
        for tag, arr in (("A", a), ("B", b)):
            arr = np.ascontiguousarray(arr)
            h.update(f"{stem}.{tag}:{arr.dtype}:{arr.shape}".encode())
            h.update(arr.tobytes())
    return h.hexdigest()[:16]


class AdapterStore:
    """Paged device-resident LoRA adapter slots plus a host tier.

    ``stems`` maps projection stem -> ``(d_out, d_in)``; ``rank`` is the
    padded per-slot rank ceiling (an adapter of smaller rank is
    zero-padded: padding rows add exactly 0); ``slots`` counts device
    slots INCLUDING the reserved all-zero slot 0; the A/B stacks are
    ``dtype`` (the engine's float dtype) on ``device``, the scales
    float32.  ``split`` maps a stack key (``f"{stem}_A"``/``_B``) to the
    dim its ``shards`` pieces split (the others are whole).
    """

    def __init__(self, stems, rank, slots, dtype=torch.float32,
                 device="cpu", host_bytes=None, split=None, shards=1):
        if slots < 2:
            raise ValueError("adapters needs >= 2 slots "
                             "(slot 0 is the reserved base-model row)")
        if rank < 1:
            raise ValueError("adapter rank must be >= 1")
        self.stems = dict(stems)
        self.rank = int(rank)
        self.slots = int(slots)
        self.host_bytes = host_bytes
        self._lock = threading.RLock()
        self._alias = {}                 # guarded-by: _lock (id -> digest)
        self._host = collections.OrderedDict()  # guarded-by: _lock
        self._host_used = 0              # guarded-by: _lock
        self._loaded = {}                # guarded-by: _lock (digest -> slot)
        self._slot_digest = [None] * self.slots  # guarded-by: _lock
        self._slot_ref = [0] * self.slots        # guarded-by: _lock
        self._free = list(range(1, self.slots))  # guarded-by: _lock
        self._cold = collections.OrderedDict()   # guarded-by: _lock
        self.loads = 0                   # guarded-by: _lock
        self.device_evictions = 0        # guarded-by: _lock
        self.host_evictions = 0          # guarded-by: _lock
        self.split = dict(split or {})
        stacks = {}

        def zeros(key, shape):
            dim = self.split.get(key)
            if dim is None:
                return torch.zeros(shape, dtype=dtype, device=device)
            shape = list(shape)
            shape[dim] //= shards
            return [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(shards)]

        for stem, (dout, din) in self.stems.items():
            stacks[f"{stem}_A"] = zeros(f"{stem}_A",
                                        (self.slots, self.rank, din))
            stacks[f"{stem}_B"] = zeros(f"{stem}_B",
                                        (self.slots, dout, self.rank))
        stacks["scale"] = torch.zeros((self.slots,), dtype=torch.float32,
                                      device=device)
        self._device = stacks            # bound once; loads write in place

    # -- registration (host tier) -------------------------------------

    def register(self, adapter_id, arrays, alpha=None):
        """Register ``{stem: (A, B)}`` numpy pairs under ``adapter_id``
        in the host tier (the device load is lazy, at the first
        ``acquire``).  ``A`` is ``(r, d_in)``, ``B`` is ``(d_out, r)``
        with ``r <= rank``; stems absent from ``arrays`` stay zero.
        Returns the content digest."""
        if not isinstance(adapter_id, str) or not adapter_id:
            raise ValueError("adapter id must be a non-empty string")
        clean, nbytes = {}, 0
        for stem, pair in arrays.items():
            if stem not in self.stems:
                raise ValueError(f"unknown projection stem: {stem}")
            a, b = (np.asarray(x) for x in pair)
            dout, din = self.stems[stem]
            r = a.shape[0] if a.ndim == 2 else -1
            if a.ndim != 2 or b.ndim != 2 or r > self.rank or r < 1 \
                    or a.shape[1] != din or b.shape != (dout, r):
                raise ValueError(
                    f"{stem}: want A (r<={self.rank}, {din}) / "
                    f"B ({dout}, r), got A {a.shape} / B {b.shape}")
            clean[stem] = (a, b)
            nbytes += a.nbytes + b.nbytes
        if not clean:
            raise ValueError("adapter has no projection deltas")
        ranks = {p[0].shape[0] for p in clean.values()}
        if len(ranks) != 1:
            raise ValueError(f"mixed per-stem ranks: {sorted(ranks)}")
        r = ranks.pop()
        alpha = float(alpha) if alpha is not None else float(r)
        digest = _digest(clean, alpha)
        with self._lock:
            if digest not in self._host:
                self._host_make_room(nbytes)
                self._host[digest] = {
                    "arrays": clean, "alpha": alpha, "rank": r,
                    "bytes": nbytes, "ids": set(),
                }
                self._host_used += nbytes
            self._host[digest]["ids"].add(adapter_id)
            self._host.move_to_end(digest)
            self._alias[adapter_id] = digest
        return digest

    def _host_make_room(self, nbytes):
        # called with _lock held (reentrant: re-entering is free and
        # keeps the lock discipline checkable)
        with self._lock:
            if self.host_bytes is None:
                return
            if nbytes > self.host_bytes:
                raise ValueError(
                    f"adapter ({nbytes}B) exceeds the host tier budget "
                    f"({self.host_bytes}B, MXTPU_SERVE_ADAPTER_HOST_BYTES)")
            for digest in list(self._host):
                if self._host_used + nbytes <= self.host_bytes:
                    break
                if digest in self._loaded:
                    continue        # device-resident copies stay pinned
                rec = self._host.pop(digest)
                self._host_used -= rec["bytes"]
                self.host_evictions += 1
                for aid in rec["ids"]:
                    self._alias.pop(aid, None)
            if self._host_used + nbytes > self.host_bytes:
                raise ValueError("host adapter tier full (every entry "
                                 "is device-resident)")

    def known(self, adapter_id):
        with self._lock:
            return adapter_id in self._alias

    def ids(self):
        with self._lock:
            return sorted(self._alias)

    def loaded(self):
        """Adapter ids currently device-resident (hot or cold)."""
        with self._lock:
            out = set()
            for digest in self._loaded:
                rec = self._host.get(digest)
                out |= rec["ids"] if rec else set()
            return sorted(out)

    # -- slot accounting ----------------------------------------------

    def acquire(self, adapter_id):
        """Pin ``adapter_id`` for one request and return its device
        slot, loading it from the host tier (evicting the coldest
        resident adapter if no slot is free).  Raises ``KeyError`` for
        an unknown id, :class:`NoAdapterSlots` when every slot is
        pinned by running requests."""
        with self._lock:
            digest = self._alias[adapter_id]
            slot = self._loaded.get(digest)
            if slot is not None:
                if self._slot_ref[slot] == 0:
                    self._cold.pop(slot, None)
                self._slot_ref[slot] += 1
                self._host.move_to_end(digest)
                return slot
            if self._free:
                slot = self._free.pop()
            elif self._cold:
                slot, old = self._cold.popitem(last=False)
                del self._loaded[old]
                self._slot_digest[slot] = None
                self.device_evictions += 1
            else:
                raise NoAdapterSlots(
                    f"all {self.slots - 1} adapter slots are pinned")
            self._load_slot(slot, digest)
            self._loaded[digest] = slot
            self._slot_digest[slot] = digest
            self._slot_ref[slot] = 1
            self._host.move_to_end(digest)
            return slot

    def release(self, slot):
        """Drop one pin (the engine zeroes the request's slot after
        calling, so a request releases once).  A slot at refcount 0
        stays loaded and joins the cold-LRU tail; releasing slot 0, an
        out-of-range slot or an unpinned one does nothing."""
        with self._lock:
            if not 0 < slot < self.slots or self._slot_ref[slot] == 0:
                return
            self._slot_ref[slot] -= 1
            if self._slot_ref[slot] == 0:
                self._cold[slot] = self._slot_digest[slot]
                self._cold.move_to_end(slot)

    def unload(self, adapter_id):
        """Force an adapter off the device (catalog rebalance).  Only
        cold adapters unload; a pinned one raises ``RuntimeError``.
        The host-tier registration stays."""
        with self._lock:
            digest = self._alias[adapter_id]
            slot = self._loaded.get(digest)
            if slot is None:
                return False
            if self._slot_ref[slot]:
                raise RuntimeError(
                    f"adapter {adapter_id!r} is pinned by "
                    f"{self._slot_ref[slot]} running request(s)")
            self._cold.pop(slot, None)
            del self._loaded[digest]
            self._slot_digest[slot] = None
            self._free.append(slot)
            return True

    def forget(self, adapter_id):
        """De-catalog an adapter: device-unload it AND drop its
        host-tier registration.  Cold only: a pinned adapter raises
        ``RuntimeError`` (drain first).  Other ids aliasing the same
        content keep theirs; returns False for an unknown id."""
        with self._lock:
            digest = self._alias.get(adapter_id)
            if digest is None:
                return False
            rec = self._host[digest]
            if len(rec["ids"]) == 1:
                self.unload(adapter_id)        # RuntimeError if pinned
                self._host.pop(digest)
                self._host_used -= rec["bytes"]
            rec["ids"].discard(adapter_id)
            self._alias.pop(adapter_id, None)
            return True

    def _load_slot(self, slot, digest):
        """Write ``digest``'s rows into ``slot`` of every stack, in
        place, zero-padded to ``rank`` (stems it lacks stay zero)."""
        # called with _lock held (reentrant, as _host_make_room)
        with self._lock:
            rec = self._host[digest]
            for stem in self.stems:
                pair = rec["arrays"].get(stem)
                for tag, i in (("A", 0), ("B", 1)):
                    key = f"{stem}_{tag}"
                    full = self._device[key]
                    rows = None
                    if pair is not None:
                        rows = torch.from_numpy(
                            np.ascontiguousarray(pair[i]))
                    shards = full if isinstance(full, list) else [full]
                    pieces = [rows] * len(shards)
                    if rows is not None and isinstance(full, list):
                        # the slot's rows lose the slot axis: dim - 1
                        pieces = torch.chunk(rows, len(shards),
                                             dim=self.split[key] - 1)
                    for shard, piece in zip(shards, pieces):
                        dst = shard[slot]
                        dst.zero_()
                        if piece is None:
                            continue
                        r = pair[0].shape[0]
                        (dst[:r] if tag == "A" else dst[:, :r]).copy_(piece)
            self._device["scale"][slot] = float(
                np.float32(rec["alpha"] / rec["rank"]))
            self.loads += 1

    @property
    def device(self):
        """The programs' input: ``{f"{stem}_A", f"{stem}_B", "scale"}``
        device stacks (the same tensors for the store's lifetime)."""
        return self._device

    # -- disk + wire codecs -------------------------------------------

    def save_file(self, adapter_id, path):
        with self._lock:
            rec = self._host[self._alias[adapter_id]]
            arrays = {f"{s}.A": p[0] for s, p in rec["arrays"].items()}
            arrays.update(
                {f"{s}.B": p[1] for s, p in rec["arrays"].items()})
            alpha = rec["alpha"]
        np.savez(path, __alpha__=np.float64(alpha), **arrays)

    def load_file(self, adapter_id, path):
        """Register an adapter from a ``save_file`` container."""
        with np.load(path) as z:
            alpha = float(z["__alpha__"])
            arrays = {}
            for name in z.files:
                if name == "__alpha__":
                    continue
                stem, tag = name.rsplit(".", 1)
                arrays.setdefault(stem, [None, None])
                arrays[stem][0 if tag == "A" else 1] = z[name]
        return self.register(adapter_id, {s: tuple(p)
                                          for s, p in arrays.items()},
                             alpha=alpha)

    def export_records(self, adapter_id):
        """Wire payload (base64 with a sha1 a array): JSON-safe,
        integrity-checked per array on import."""
        with self._lock:
            digest = self._alias[adapter_id]
            rec = self._host[digest]
            records = []
            for stem, (a, b) in sorted(rec["arrays"].items()):
                for tag, arr in (("A", a), ("B", b)):
                    raw = np.ascontiguousarray(arr).tobytes()
                    records.append({
                        "name": f"{stem}.{tag}",
                        "dtype": str(arr.dtype),
                        "shape": list(arr.shape),
                        "sha1": hashlib.sha1(raw).hexdigest()[:16],
                        "data": base64.b64encode(raw).decode("ascii"),
                    })
            return {"adapter": adapter_id, "digest": digest,
                    "alpha": rec["alpha"], "rank": rec["rank"],
                    "records": records}

    def import_records(self, adapter_id, payload):
        """Register from an ``export_records`` payload; any array whose
        sha1 disagrees with its bytes rejects the whole adapter."""
        arrays = {}
        for r in payload.get("records") or []:
            raw = base64.b64decode(r["data"])
            if hashlib.sha1(raw).hexdigest()[:16] != r["sha1"]:
                raise ValueError(
                    f"adapter array {r['name']!r} failed its sha1 "
                    "integrity check")
            arr = np.frombuffer(raw, dtype=np.dtype(r["dtype"]))
            arr = arr.reshape(r["shape"]).copy()
            stem, tag = r["name"].rsplit(".", 1)
            arrays.setdefault(stem, [None, None])
            arrays[stem][0 if tag == "A" else 1] = arr
        if any(a is None or b is None for a, b in arrays.values()):
            raise ValueError("adapter payload missing an A/B half")
        return self.register(
            adapter_id, {s: tuple(p) for s, p in arrays.items()},
            alpha=payload.get("alpha"))

    # -- introspection ------------------------------------------------

    def stats(self):
        with self._lock:
            used = sum(1 for d in self._slot_digest[1:] if d)
            return {
                "slots": self.slots,
                "rank": self.rank,
                "slots_used": used,
                "slots_pinned": sum(1 for r in self._slot_ref[1:] if r),
                "slots_free": self.slots - 1 - used,
                "ids": sorted(self._alias),
                "loaded": self.loaded(),
                "registered": len(self._host),
                "host_bytes_used": self._host_used,
                "host_bytes_budget": self.host_bytes,
                "loads": self.loads,
                "device_evictions": self.device_evictions,
                "host_evictions": self.host_evictions,
            }
