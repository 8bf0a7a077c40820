"""Paged KV-cache block accounting for the serving engine.

The port of ``mxnet_tpu/serve/kv_block_manager.py`` (host-side, numpy
only; the port keeps its own copy so it never imports the reference).
One fixed device cache, allocated once by ``serve.Engine``, is carved
into ``num_blocks`` blocks of ``block_size`` token slots.  This module
owns the host bookkeeping: which physical blocks belong to which
request (the per-request *block table*), the free list, refcounts, the
content-addressed prefix index and the LRU eviction tier.

Block id 0 is the permanent *null block*: never allocated, block tables
pad with it, and padded scatter positions write into it.  Its contents
are garbage by design — every consumer masks by context length.

Prefix caching: every FULL block whose token content is known is
published under ``H(parent_key, block_token_ids)``; chaining the parent
key makes the key table an implicit radix tree over token prefixes.
``allocate(rid, n, token_ids=...)`` reuses the longest cached chain
(refcounted) and returns how many tokens it covers.  ``free`` is a
decref; refcount-0 published blocks park in an LRU and are evicted as
radix leaves, oldest first.  Copy-on-write: a prompt fully covered by
cached blocks still recomputes its final span into a fresh block.

Host-DRAM tier (``HostKVPool``): with a pool attached (the engine's
``host_kv_bytes``), a refcount-0 published leaf reclaimed by the prefix
LRU parks its K/V on the host (the engine's ``set_offload_source``
fetch) under its content key instead of being discarded.  ``_walk``
continues the radix chain into the pool: a host hit claims a fresh
device block, queues its host copies for the engine's ``restore``
program (``take_pending_restores``) and counts the span as cached.
Host copies are CPU torch tensors (numpy has no bfloat16).  The same
records serve the prefill/decode handoff (``export_blocks`` /
``import_blocks`` / ``has_blocks``), chain-hash verified on import.

Routing advertisement (``RadixSummary``): a counting bloom over every
published block key in both tiers plus the top-K most recently
published chain keys, kept incrementally at each publish, unpublish and
host-tier insert or removal.  ``BlockManager.summary()`` is the
``kv_summary`` a fleet replica publishes on ``/healthz`` and
``/statusz.json``; the router hashes a prompt with ``chain_keys`` and
probes it with ``RadixSummary.match``.
"""

from __future__ import annotations

import base64
import hashlib
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from .. import telemetry
from ..base import env_flag, env_float, env_int

__all__ = ["BlockManager", "HostKVPool", "NoFreeBlocks", "RadixSummary",
           "blocks_for", "chain_keys", "salted_root", "dtype_name",
           "host_tensor"]

# chaos-harness fault: simulated seconds per host-tier restore claim (a
# slow DRAM copy); with a restore budget set, a delay past the budget
# degrades the hit to recompute instead of stalling the step loop
ENV_HOST_RESTORE_DELAY = "MXTPU_FAULT_HOST_RESTORE_DELAY"
ENV_HOST_RESTORE_BUDGET = "MXTPU_SERVE_HOST_KV_RESTORE_BUDGET"

# chain anchor for the first block of every sequence (the radix root);
# the same bytes as the reference, so chain keys agree across packages
_ROOT = b"mxtpu-radix-root"


class NoFreeBlocks(Exception):
    """Raised when an allocation cannot be satisfied even after
    evicting every refcount-0 retained/cached block.  The scheduler
    catches this and preempts a running request instead."""


def blocks_for(n_tokens, block_size):
    """Physical blocks needed to hold ``n_tokens`` cache slots."""
    return -(-n_tokens // block_size)


def _block_key(parent, token_ids):
    """Content-addressed key of one full block: chain-hash of the
    parent block's key and this block's token ids."""
    h = hashlib.sha1(parent)
    h.update(np.asarray(token_ids, np.int32).tobytes())
    return h.digest()


def salted_root(salt):
    """Radix root for a KV-affecting request condition (e.g. a LoRA
    adapter id): equal salt, equal chain keys; a different salt, a
    disjoint key space.  ``None``/empty is the unsalted root."""
    if not salt:
        return _ROOT
    h = hashlib.sha1(_ROOT)
    h.update(str(salt).encode())
    return h.digest()


def chain_keys(token_ids, block_size, max_blocks=None, salt=None):
    """Chain keys of ``token_ids``'s full blocks, in prefix order,
    copy-on-write capped like the radix walk: the final token's block
    always recomputes, so it is never part of the routable prefix."""
    bs = int(block_size)
    if bs < 1 or token_ids is None:
        return []
    n_full = len(token_ids) // bs
    if n_full and n_full * bs > len(token_ids) - 1:
        n_full -= 1                    # COW: last span recomputes
    if max_blocks is not None:
        n_full = min(n_full, int(max_blocks))
    out = []
    parent = salted_root(salt)
    for b in range(n_full):
        key = _block_key(parent, token_ids[b * bs:(b + 1) * bs])
        out.append(key)
        parent = key
    return out


def dtype_name(a):
    """The reference's dtype name of a host copy (``"bfloat16"``,
    ``"int8"``, ``"float32"``): the same word for a torch tensor and
    for a numpy array (ml_dtypes' bfloat16 included), so handoff
    records name their payloads as the reference's do."""
    return str(a.dtype).replace("torch.", "")


def host_tensor(a):
    """One host copy as a CPU torch tensor: tensors as they are, numpy
    arrays shared without a copy where writable; a numpy bfloat16 array (the ml_dtypes
    type the reference writes) is reinterpreted through its 16 bits, as
    ``convert.to_tensor`` does."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:      # e.g. a view of a jax array
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class RadixSummary:
    """Compact advertisement of the radix cache's contents (the
    reference's ``RadixSummary``): the ``kv_summary`` a replica
    publishes so the fleet router can score prefix affinity without
    walking the tree.

    - A counting Bloom filter over every published block key in either
      tier: the ``k`` probe positions are cut from the key's sha1 bytes,
      ``add`` increments and ``remove`` decrements a uint16 count
      (saturating, so a saturated position stays set), and the snapshot
      packs ``count > 0`` into a base64 bitmap of ``m`` bits.  A false
      positive sends a request to a replica that recomputes: never a
      wrong token.
    - ``top``: the most recently published chain keys (16 hex chars),
      at most ``top_k``, an exact-membership fast path.

    ``MXTPU_ROUTE_SUMMARY_BLOOM_BITS`` (4096) and
    ``MXTPU_ROUTE_SUMMARY_TOPK`` (32) size it.  Both tiers mutate it
    under their own locks; it keeps a leaf lock of its own."""

    def __init__(self, block_size, bloom_bits=None, top_k=None):
        self.block_size = int(block_size)
        m = (env_int("MXTPU_ROUTE_SUMMARY_BLOOM_BITS", 4096)
             if bloom_bits is None else int(bloom_bits))
        self.m = max(64, int(m))
        self.k = 4
        self.top_k = max(0, env_int("MXTPU_ROUTE_SUMMARY_TOPK", 32)
                         if top_k is None else int(top_k))
        self._lock = threading.Lock()
        self._counts = np.zeros(self.m, np.uint16)  # guarded-by: _lock
        self._top = OrderedDict()                   # guarded-by: _lock
        self.keys = 0                               # guarded-by: _lock
        self.version = 0                            # guarded-by: _lock

    def _positions(self, key):
        return [int.from_bytes(key[4 * i:4 * i + 4], "little") % self.m
                for i in range(self.k)]

    def add(self, key):
        """One block published (either tier) under ``key``."""
        with self._lock:
            for p in self._positions(key):
                if self._counts[p] < np.iinfo(np.uint16).max:
                    self._counts[p] += 1
            self.keys += 1
            self.version += 1
            if self.top_k:
                hexk = key.hex()[:16]
                self._top[hexk] = True
                self._top.move_to_end(hexk)
                while len(self._top) > self.top_k:
                    self._top.popitem(last=False)

    def remove(self, key):
        """One block unpublished or evicted (either tier)."""
        with self._lock:
            for p in self._positions(key):
                if self._counts[p] > 0:
                    self._counts[p] -= 1
            self.keys = max(0, self.keys - 1)
            self.version += 1
            self._top.pop(key.hex()[:16], None)

    def clear(self):
        with self._lock:
            self._counts[:] = 0
            self._top.clear()
            self.keys = 0
            self.version += 1

    def snapshot(self):
        """The JSON-ready advertisement ``match`` probes: ``m/8`` bloom
        bytes plus at most ``top_k`` keys, whatever the cache holds."""
        with self._lock:
            bits = np.packbits(self._counts > 0).tobytes()
            return {"block_size": self.block_size,
                    "keys": self.keys,
                    "version": self.version,
                    "bloom": {"m": self.m, "k": self.k,
                              "bits": base64.b64encode(bits)
                              .decode("ascii")},
                    "top": list(self._top)}

    @staticmethod
    def match(snapshot, keys):
        """How many leading ``keys`` (full digests, prefix order) the
        ``snapshot`` advertises.  The first miss ends the count: a block
        is never cached without its ancestor.  Stdlib only, and a
        malformed snapshot scores zero instead of raising."""
        if not snapshot or not keys:
            return 0
        bloom = snapshot.get("bloom") or {}
        try:
            m = int(bloom.get("m") or 0)
            k = int(bloom.get("k") or 0)
            raw = base64.b64decode(bloom.get("bits") or "")
        except (TypeError, ValueError):
            return 0
        bloom_ok = m > 0 and k > 0 and len(raw) * 8 >= m
        top = set(snapshot.get("top") or ())
        depth = 0
        for key in keys:
            if key.hex()[:16] in top:
                depth += 1
                continue
            if not bloom_ok:
                break
            pos = [int.from_bytes(key[4 * i:4 * i + 4], "little") % m
                   for i in range(k)]
            if all((raw[p >> 3] >> (7 - (p & 7))) & 1 for p in pos):
                depth += 1
            else:
                break
        return depth


class HostKVPool:
    """Bounded host-DRAM pool of evicted prefix-cache blocks (the
    reference's ``HostKVPool``).

    Entries are keyed by the block's radix key and hold its host copies
    (K, V, plus the int8 scale pair under int8 K/V), the bytes the
    device block held.  The pool runs its own LRU under ``max_bytes``
    with the device tier's leaf-only discipline: an entry with a hosted
    child is never evicted first, and the child link is registered
    before any room-making eviction, so an insert never reclaims its own
    chain's interior.

    Chaos hook: ``MXTPU_FAULT_HOST_RESTORE_DELAY`` simulates a slow
    copy per claim; with ``MXTPU_SERVE_HOST_KV_RESTORE_BUDGET`` set, a
    delay past the budget degrades the claim to a miss (the entry stays
    hosted, the engine recomputes).
    """

    def __init__(self, max_bytes, block_tokens=0):
        self.max_bytes = int(max_bytes)
        if self.max_bytes <= 0:
            raise ValueError(
                f"max_bytes must be > 0 (got {max_bytes}); an absent "
                "pool is host_pool=None, not a zero-byte pool")
        self.block_tokens = int(block_tokens)
        self._lock = threading.RLock()
        # key -> (parent_key, arrays tuple, nbytes), LRU order
        self._entries = OrderedDict()   # guarded-by: _lock
        # parent key -> hosted entries chained under it (leaf == absent)
        self._by_parent = {}            # guarded-by: _lock
        self.bytes_used = 0             # guarded-by: _lock
        self.bytes_peak = 0             # guarded-by: _lock
        self.offloads = 0               # guarded-by: _lock
        self.restores = 0               # guarded-by: _lock
        self.evictions = 0              # guarded-by: _lock
        self.rejects = 0                # guarded-by: _lock
        self.degraded = 0               # guarded-by: _lock
        self.discarded_tokens = 0       # guarded-by: _lock
        # (on_add, on_remove) per-key callbacks: the BlockManager's
        # RadixSummary upkeep
        self._listener = None           # guarded-by: _lock
        self.fault_delay_s = env_float(ENV_HOST_RESTORE_DELAY, 0.0)
        self.restore_budget_s = env_float(ENV_HOST_RESTORE_BUDGET, 0.0)
        self._m_offloads = telemetry.counter(
            "mxtpu_serve_host_kv_offloads_total",
            "prefix-cache blocks parked in the host-DRAM tier")
        self._m_discarded = telemetry.counter(
            "mxtpu_serve_prefix_discarded_tokens_total",
            "tokens whose cached K/V an eviction threw away for good")
        self._m_degraded = telemetry.counter(
            "mxtpu_serve_host_kv_degraded_total",
            "host-tier restore claims degraded to recompute "
            "(restore budget exceeded)")

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def has(self, key):
        with self._lock:
            return key in self._entries

    def keys(self):
        """Every hosted key, LRU order (the summary rebuild after a
        ``BlockManager.reset()``, never the scrape path)."""
        with self._lock:
            return list(self._entries)

    def set_listener(self, on_add, on_remove):
        """Register per-key add/remove callbacks (the BlockManager's
        RadixSummary upkeep).  They run under ``_lock`` and get the key
        only."""
        with self._lock:
            self._listener = (on_add, on_remove)

    def _remove(self, key):
        """Drop one entry; returns its ``(parent, arrays, nbytes)``."""
        with self._lock:
            parent, arrays, nbytes = self._entries.pop(key)
            self.bytes_used -= nbytes
            if parent is not None and parent in self._by_parent:
                self._by_parent[parent] -= 1
                if not self._by_parent[parent]:
                    del self._by_parent[parent]
            if self._listener is not None:
                self._listener[1](key)
            return parent, arrays, nbytes

    def _evict_leaf(self):
        """Reclaim the oldest hosted entry with no hosted children, the
        host tier's final discard."""
        with self._lock:
            for key in self._entries:          # oldest first
                if self._by_parent.get(key, 0) == 0:
                    self._remove(key)
                    self.evictions += 1
                    self.discarded_tokens += self.block_tokens
                    self._m_discarded.inc(self.block_tokens)
                    return True
            return False

    def _insert(self, key, parent, arrays):
        """Budget-checked insert; returns whether the entry parked."""
        with self._lock:
            nbytes = sum(int(a.nbytes) for a in arrays)
            if nbytes > self.max_bytes:
                self.rejects += 1
                return False
            if key in self._entries:
                # a restored block parked again: equal keys, equal bytes
                self._remove(key)
            # the parent link first: making room must never reclaim the
            # incoming entry's own hosted parent
            if parent is not None:
                self._by_parent[parent] = self._by_parent.get(parent, 0) + 1
            while self.bytes_used + nbytes > self.max_bytes:
                if not self._evict_leaf():
                    if parent is not None and parent in self._by_parent:
                        self._by_parent[parent] -= 1
                        if not self._by_parent[parent]:
                            del self._by_parent[parent]
                    self.rejects += 1
                    return False
            self._entries[key] = (parent, tuple(arrays), nbytes)
            self.bytes_used += nbytes
            self.bytes_peak = max(self.bytes_peak, self.bytes_used)
            if self._listener is not None:
                self._listener[0](key)
            return True

    def put(self, key, parent, arrays):
        """Park one evicted block's host copies under ``key``; False
        (the caller counts a discard) when it cannot fit even after
        evicting every hosted leaf."""
        with self._lock:
            if not self._insert(key, parent, arrays):
                return False
            self.offloads += 1
            self._m_offloads.inc()
            return True

    def claim(self, key):
        """Pop ``key``'s host copies for a device restore; None on a
        miss, and in the chaos-degraded case (the simulated copy would
        exceed the restore budget: the entry stays hosted)."""
        with self._lock:
            if key not in self._entries:
                return None
            if self.fault_delay_s:
                if (self.restore_budget_s
                        and self.fault_delay_s > self.restore_budget_s):
                    self.degraded += 1
                    self._m_degraded.inc()
                    return None
                time.sleep(self.fault_delay_s)   # the simulated copy
            _, arrays, _ = self._remove(key)
            self.restores += 1
            return arrays

    def peek(self, key):
        """``key``'s host copies without claiming (the entry and its
        recency stay); None on a miss.  The handoff export reads parked
        blocks through this."""
        with self._lock:
            entry = self._entries.get(key)
            return None if entry is None else entry[1]

    def unclaim(self, key, parent, arrays):
        """Return a claimed entry after a failed allocation (no offload
        is counted)."""
        with self._lock:
            self._insert(key, parent, arrays)

    def clear(self):
        """Release every hosted copy (engine shutdown)."""
        with self._lock:
            if self._listener is not None:
                for key in self._entries:
                    self._listener[1](key)
            self._entries.clear()
            self._by_parent.clear()
            self.bytes_used = 0

    def stats(self):
        """JSON-ready snapshot: budget, occupancy and counters."""
        with self._lock:
            return {"max_bytes": self.max_bytes,
                    "bytes_used": self.bytes_used,
                    "bytes_peak": self.bytes_peak,
                    "utilization": round(
                        self.bytes_used / self.max_bytes, 4),
                    "entries": len(self._entries),
                    "offloads": self.offloads,
                    "restores": self.restores,
                    "evictions": self.evictions,
                    "rejects": self.rejects,
                    "degraded": self.degraded,
                    "discarded_tokens": self.discarded_tokens}


class BlockManager:
    """Host-side block accounting.  Mutations are serialized by an
    RLock (the scheduler allocates from the engine's step thread while
    admission checks may read from others)."""

    def __init__(self, num_blocks, block_size, prefix_cache=None,
                 host_pool=None):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        if prefix_cache is None:
            prefix_cache = env_flag("MXTPU_SERVE_PREFIX_CACHE", True)
        self.prefix_cache = bool(prefix_cache)
        # host-DRAM tier (None = off: every prefix eviction discards)
        self.host = host_pool
        self._lock = threading.RLock()
        # block 0 reserved as the null/padding block
        self._free = deque(range(1, num_blocks))  # guarded-by: _lock
        self._tables = {}                         # guarded-by: _lock
        self._lens = {}                           # guarded-by: _lock
        self._retained = OrderedDict()            # guarded-by: _lock
        # block id -> live table references (entries removed at 0)
        self._refs = {}                           # guarded-by: _lock
        # content-addressed radix index: key -> published block id
        self._index = {}                          # guarded-by: _lock
        self._key_of = {}                         # guarded-by: _lock
        self._parent = {}                         # guarded-by: _lock
        # key -> number of cached (published) children; leaf == absent
        self._children = {}                       # guarded-by: _lock
        # refcount-0 published blocks, reusable AND evictable (LRU)
        self._lru = OrderedDict()                 # guarded-by: _lock
        # per-request published chain of block keys (prefix order)
        self._chain = {}                          # guarded-by: _lock
        # reclaim EVENTS: one retained set or one published leaf each
        self.evictions = 0                        # guarded-by: _lock
        self.prefix_hits = 0                      # guarded-by: _lock
        self.prefix_misses = 0                    # guarded-by: _lock
        self.prefix_resurrections = 0             # guarded-by: _lock
        self.prefix_tokens_saved = 0              # guarded-by: _lock
        self.prefix_evictions = 0                 # guarded-by: _lock
        self.prefix_discarded_tokens = 0          # guarded-by: _lock
        self.host_hits = 0                        # guarded-by: _lock
        self.host_restored_tokens = 0             # guarded-by: _lock
        # device->host block copier for offload (the engine's
        # set_offload_source); None = every eviction discards
        self._offload_fetch = None                # guarded-by: _lock
        # (block, host copies) awaiting the engine's restore program,
        # drained by take_pending_restores() before any program reads
        # the blocks
        self._pending_restores = []               # guarded-by: _lock
        # rid -> tokens of its table restored from the host tier
        self._host_tokens = {}                    # guarded-by: _lock
        self._m_hits = telemetry.counter(
            "mxtpu_serve_prefix_hits_total",
            "prefix-cache lookups that reused >= 1 cached block")
        self._m_misses = telemetry.counter(
            "mxtpu_serve_prefix_misses_total",
            "prefix-cache lookups that reused nothing")
        self._m_saved = telemetry.counter(
            "mxtpu_serve_prefix_tokens_saved_total",
            "prompt tokens whose prefill was skipped via the prefix cache")
        self._m_discarded = telemetry.counter(
            "mxtpu_serve_prefix_discarded_tokens_total",
            "tokens whose cached K/V an eviction threw away for good")
        self._m_restored = telemetry.counter(
            "mxtpu_serve_host_kv_restored_tokens_total",
            "prompt tokens restored host->device instead of recomputed")
        self._m_resurrections = telemetry.counter(
            "mxtpu_serve_prefix_resurrections_total",
            "prefix hits that revived >= 1 block parked refcount-0 "
            "in the prefix LRU")
        # the routable-cache advertisement (None with the prefix cache
        # off), kept at every publish and unpublish in both tiers
        self._summary = (RadixSummary(block_size)
                         if self.prefix_cache else None)
        if self._summary is not None and host_pool is not None:
            host_pool.set_listener(self._summary.add,
                                   self._summary.remove)
            for key in host_pool.keys():
                self._summary.add(key)

    def set_offload_source(self, fetch):
        """Register the device->host block copier the eviction path and
        ``export_blocks`` call (``fetch(blk) -> tuple of host copies``,
        or None to skip)."""
        with self._lock:
            self._offload_fetch = fetch

    # -- capacity ------------------------------------------------------------
    @property
    def total_blocks(self):
        """Allocatable blocks (the null block excluded)."""
        return self.num_blocks - 1

    @property
    def blocks_in_use(self):
        """Distinct physical blocks referenced by at least one table."""
        with self._lock:
            return len(self._refs)

    @property
    def free_blocks(self):
        """Immediately or lazily reclaimable blocks."""
        with self._lock:
            return (len(self._free) + len(self._lru)
                    + sum(len(b) for b in self._retained.values()))

    @property
    def retained_blocks(self):
        """Blocks parked refcount-0 (reclaimable)."""
        with self._lock:
            return (len(self._lru)
                    + sum(len(b) for b in self._retained.values()))

    def utilization(self):
        return self.blocks_in_use / max(1, self.total_blocks)

    def occupancy(self):
        """One JSON-ready snapshot of the block accounting (the
        ``/statusz`` and flight-dump ``kv_blocks`` section), taken under
        the lock so a scrape sees one consistent view."""
        with self._lock:
            return {"in_use": self.blocks_in_use,
                    "retained": self.retained_blocks,
                    "free": len(self._free),
                    "total": self.total_blocks,
                    "utilization": round(self.utilization(), 4),
                    "evictions": self.evictions,
                    "prefix_cache": self.prefix_stats()}

    def prefix_stats(self):
        """Prefix-cache population and hit/miss/evict counters;
        ``discarded_tokens`` adds the host tier's own final discards."""
        with self._lock:
            looked = self.prefix_hits + self.prefix_misses
            shared = sum(1 for r in self._refs.values() if r > 1)
            discarded = self.prefix_discarded_tokens
            if self.host is not None:
                discarded += self.host.discarded_tokens
            return {"enabled": self.prefix_cache,
                    "cached_blocks": len(self._index),
                    "reusable_blocks": len(self._lru),
                    "shared_blocks": shared,
                    "max_refcount": max(self._refs.values(), default=0),
                    "hits": self.prefix_hits,
                    "misses": self.prefix_misses,
                    "resurrections": self.prefix_resurrections,
                    "hit_rate": (round(self.prefix_hits / looked, 4)
                                 if looked else None),
                    "tokens_saved": self.prefix_tokens_saved,
                    "evictions": self.prefix_evictions,
                    "discarded_tokens": discarded,
                    "host_hits": self.host_hits,
                    "host_restored_tokens": self.host_restored_tokens}

    def host_stats(self):
        """The host-tier occupancy snapshot (None without a pool)."""
        with self._lock:
            return None if self.host is None else self.host.stats()

    def summary(self):
        """The ``RadixSummary`` snapshot a replica publishes on
        ``/healthz`` and ``/statusz.json`` (None with the prefix cache
        off): bit packing, never a tree walk."""
        if self._summary is None:
            return None
        return self._summary.snapshot()

    def host_tokens(self, rid):
        """Tokens of ``rid``'s table restored from the host tier rather
        than recomputed (0 for everyone else)."""
        with self._lock:
            return self._host_tokens.get(rid, 0)

    def take_pending_restores(self):
        """Drain the queued (block, host copies) restores: the engine
        runs its restore program on them before the first program that
        reads the blocks."""
        with self._lock:
            out, self._pending_restores = self._pending_restores, []
            return out

    def can_allocate(self, n_tokens, token_ids=None):
        """Whether ``allocate(n_tokens, token_ids=...)`` would succeed
        now: device prefix hits need no free block, host hits do (a
        restored span claims a fresh device block)."""
        need = blocks_for(n_tokens, self.block_size)
        if token_ids is not None:
            cached_blocks, _ = self.prefix_probe(token_ids)
            need -= cached_blocks
        return need <= self.free_blocks

    def fits_at_all(self, n_tokens):
        """Whether a request of ``n_tokens`` could EVER hold the cache
        alone — the admission-time rejection test."""
        return blocks_for(n_tokens, self.block_size) <= self.total_blocks

    # -- prefix lookup -------------------------------------------------------
    def _walk(self, token_ids, salt=None):
        """Longest cached prefix of ``token_ids`` at block granularity
        (called under ``_lock``): the device ``[(key, block)]`` chain
        plus the ``[key]`` continuation the host tier holds past the
        device break (empty without a pool).  Copy-on-write capped so at
        least one token is left to recompute; host hits shed first (the
        deeper end of the chain)."""
        n = len(token_ids)
        bs = self.block_size
        hits = []
        parent = salted_root(salt)
        while (len(hits) + 1) * bs <= n:
            b = len(hits)
            key = _block_key(parent, token_ids[b * bs:(b + 1) * bs])
            blk = self._index.get(key)
            if blk is None:
                break
            hits.append((key, blk))
            parent = key
        host = []
        if self.host is not None:
            while (len(hits) + len(host) + 1) * bs <= n:
                b = len(hits) + len(host)
                key = _block_key(parent, token_ids[b * bs:(b + 1) * bs])
                if not self.host.has(key):
                    break
                host.append(key)
                parent = key
        while (len(hits) + len(host)) * bs > n - 1:
            (host or hits).pop()       # COW: recompute the final span
        return hits, host

    def prefix_probe(self, token_ids, salt=None):
        """(cached_blocks, cached_tokens) an ``allocate`` with these ids
        would reuse, no state mutated: ``cached_blocks`` counts device
        hits only (a host hit restores into a fresh block),
        ``cached_tokens`` both tiers."""
        with self._lock:
            if not self.prefix_cache or token_ids is None:
                return 0, 0
            hits, host = self._walk(token_ids, salt=salt)
            return len(hits), (len(hits) + len(host)) * self.block_size

    # -- prefill/decode handoff ----------------------------------------------
    def export_blocks(self, rid, token_ids, salt=None):
        """``rid``'s cached prefix chain for ``token_ids`` as handoff
        records ``[(key, parent_key, block_token_ids, arrays)]`` in
        prefix order (``parent_key`` None at the root; ``arrays`` the
        host copies K, V[, the scale pair]).  The chain is re-walked
        from the ids, so it works while ``rid`` runs and after it
        finished.  Device blocks are copied through the offload fetch,
        parked ones peeked from the pool; a block in neither tier ends
        the chain."""
        with self._lock:
            if not self.prefix_cache or self._offload_fetch is None:
                return []
            bs = self.block_size
            n = len(token_ids)
            out = []
            parent = salted_root(salt)
            parent_key = None
            while (len(out) + 1) * bs <= n:
                b = len(out)
                tok = [int(t) for t in token_ids[b * bs:(b + 1) * bs]]
                key = _block_key(parent, tok)
                blk = self._index.get(key)
                arrays = None
                if blk is not None:
                    arrays = self._offload_fetch(blk)
                elif self.host is not None:
                    arrays = self.host.peek(key)
                if arrays is None:
                    break
                out.append((key, parent_key, tok, tuple(arrays)))
                parent_key = key
                parent = key
            return out

    def import_blocks(self, records, salt=None):
        """Park handoff records (``export_blocks``'s shape, in prefix
        order; ``arrays`` None for a block the receiver already holds)
        in the host tier under their keys.  Each record is verified
        against its chain hash first: a wrong key, a record out of
        order, or a missing payload ends the chain there and the rest
        recomputes.  numpy payloads (the reference's, bfloat16 through
        ml_dtypes) become CPU tensors.  Returns ``(imported, deduped,
        rejected)`` block counts."""
        imported = deduped = 0
        with self._lock:
            expect_parent = None
            parent = salted_root(salt)
            for key, parent_key, token_ids, arrays in records:
                if (parent_key != expect_parent
                        or len(token_ids) != self.block_size
                        or _block_key(parent, token_ids) != key):
                    break
                if key in self._index or (self.host is not None
                                          and self.host.has(key)):
                    deduped += 1
                elif (arrays is None or self.host is None
                        or not self.host.put(
                            key, parent_key,
                            tuple(host_tensor(a) for a in arrays))):
                    break
                else:
                    imported += 1
                expect_parent = key
                parent = key
        return imported, deduped, len(records) - imported - deduped

    def has_blocks(self, keys):
        """The subset of ``keys`` cached in either tier now (the handoff
        dedup probe)."""
        with self._lock:
            return [k for k in keys
                    if k in self._index
                    or (self.host is not None and self.host.has(k))]

    # -- allocation ----------------------------------------------------------
    def _take(self, n):
        """Pop n free blocks, evicting refcount-0 parked blocks as
        needed: legacy retained sets first, then prefix-LRU radix
        LEAVES oldest-first."""
        with self._lock:
            while len(self._free) < n:
                if self._retained:
                    _, blocks = self._retained.popitem(last=False)  # oldest
                    self._free.extend(blocks)
                    self.evictions += 1
                    continue
                if not self._evict_prefix_leaf():
                    raise NoFreeBlocks(
                        f"need {n} blocks, {len(self._free)} free and "
                        "nothing refcount-0 left to evict")
            taken = [self._free.popleft() for _ in range(n)]
            for blk in taken:
                self._refs[blk] = 1
            return taken

    def _evict_prefix_leaf(self):
        """Reclaim the oldest refcount-0 published radix leaf.  With a
        pool its K/V parks on the host under its key before the device
        block is reused; otherwise (or when the pool rejects it) it is
        gone for good and ``discarded_tokens`` counts the loss."""
        with self._lock:
            for key in self._lru:       # oldest first
                if self._children.get(key, 0) == 0:
                    blk = self._index[key]
                    parked = False
                    if (self.host is not None
                            and self._offload_fetch is not None):
                        arrays = self._offload_fetch(blk)
                        if arrays is not None:
                            parked = self.host.put(
                                key, self._parent.get(key), arrays)
                    if not parked:
                        self.prefix_discarded_tokens += self.block_size
                        self._m_discarded.inc(self.block_size)
                    self._unpublish(key)
                    self._free.append(blk)
                    self.evictions += 1
                    self.prefix_evictions += 1
                    return True
            return False

    def _unpublish(self, key):
        """Drop ``key`` from the radix index; returns its block."""
        with self._lock:
            blk = self._index.pop(key)
            self._key_of.pop(blk, None)
            parent = self._parent.pop(key, None)
            if parent is not None and parent in self._children:
                self._children[parent] -= 1
                if not self._children[parent]:
                    del self._children[parent]
            self._children.pop(key, None)
            self._lru.pop(key, None)
            if self._summary is not None:
                self._summary.remove(key)
            return blk

    def _ref_hit(self, blk):
        """Take one reference on a cached block; returns whether it was
        parked in the LRU (a resurrection)."""
        with self._lock:
            self._refs[blk] = self._refs.get(blk, 0) + 1
            if self._refs[blk] == 1:
                return self._lru.pop(self._key_of[blk], None) is not None
            return False

    def allocate(self, rid, n_tokens, token_ids=None, salt=None):
        """Create ``rid``'s block table covering ``n_tokens`` slots.

        Without ``token_ids``: fresh blocks only, returns the table.
        With ``token_ids``: the longest cached prefix is reused (hit
        blocks head the table, refcounts incremented) and the return is
        ``(table, cached_tokens)``."""
        with self._lock:
            if rid in self._tables:
                raise ValueError(
                    f"request {rid!r} already has a block table")
            if rid in self._retained:
                # a preempted request resuming: its parked unpublished
                # blocks hold stale K/V (resume recomputes)
                self._free.extend(self._retained.pop(rid))
            hits, host_keys = [], []
            if self.prefix_cache and token_ids is not None:
                hits, host_keys = self._walk(token_ids, salt=salt)
            # clear-miss precheck BEFORE any mutation or eviction; host
            # hits never discount the block need
            if blocks_for(n_tokens, self.block_size) - len(hits) \
                    > self.free_blocks:
                raise NoFreeBlocks(
                    f"request {rid!r} needs "
                    f"{blocks_for(n_tokens, self.block_size)} blocks "
                    f"({len(hits)} cached), {self.free_blocks} "
                    "free/reclaimable")
            # claim host entries BEFORE _take: its evictions offload more
            # blocks, and the pool's LRU could evict the entries this
            # walk matched.  A degraded claim ends the restored span
            claimed = []
            parent_key = hits[-1][0] if hits else None
            for key in host_keys:
                arrays = self.host.claim(key)
                if arrays is None:
                    break
                claimed.append((key, parent_key, arrays))
                parent_key = key
            if self.prefix_cache and token_ids is not None:
                if hits or claimed:
                    saved = (len(hits) + len(claimed)) * self.block_size
                    self.prefix_hits += 1
                    self.prefix_tokens_saved += saved
                    self._m_hits.inc()
                    self._m_saved.inc(saved)
                else:
                    self.prefix_misses += 1
                    self._m_misses.inc()
                if claimed:
                    self.host_hits += 1
                    self.host_restored_tokens += \
                        len(claimed) * self.block_size
                    self._m_restored.inc(len(claimed) * self.block_size)
                resurrected = 0
                for _, blk in hits:
                    if self._ref_hit(blk):
                        resurrected += 1
                if resurrected:
                    self.prefix_resurrections += 1
                    self._m_resurrections.inc()
            n = blocks_for(n_tokens, self.block_size)
            try:
                fresh = self._take(n - len(hits))
            except NoFreeBlocks:
                # undo the hit references and re-park the claimed host
                # entries: a failed allocation must not pin cached
                # blocks or drop hosted K/V
                for _, blk in hits:
                    self._deref(blk, retain=True)
                for key, parent, arrays in claimed:
                    self.host.unclaim(key, parent, arrays)
                raise
            # restored blocks publish at once under their keys (they are
            # the cached chain, back on the device) and queue their host
            # copies for the engine's restore program
            for (key, parent, arrays), blk in zip(claimed, fresh):
                self._index[key] = blk
                self._key_of[blk] = key
                self._parent[key] = parent
                if parent is not None:
                    self._children[parent] = \
                        self._children.get(parent, 0) + 1
                if self._summary is not None:
                    self._summary.add(key)
                self._pending_restores.append((blk, arrays))
            self._tables[rid] = [blk for _, blk in hits] + fresh
            self._lens[rid] = n * self.block_size
            self._chain[rid] = ([key for key, _ in hits]
                                + [key for key, _, _ in claimed])
            if token_ids is not None:
                self._host_tokens[rid] = len(claimed) * self.block_size
                return (list(self._tables[rid]),
                        (len(hits) + len(claimed)) * self.block_size)
            return list(self._tables[rid])

    def ensure_capacity(self, rid, n_tokens):
        """Grow ``rid``'s table to cover ``n_tokens`` slots (decode
        appends); raises NoFreeBlocks when the cache is exhausted."""
        with self._lock:
            table = self._tables[rid]
            need = blocks_for(n_tokens, self.block_size) - len(table)
            if need > 0:
                table.extend(self._take(need))
                self._lens[rid] = len(table) * self.block_size
            return list(table)

    def table(self, rid):
        with self._lock:
            return list(self._tables[rid])

    def capacity(self, rid):
        """Token slots currently reserved for ``rid``."""
        with self._lock:
            return self._lens[rid]

    def reclaimable_blocks(self, rid):
        """Blocks ``free(rid)`` would actually park/release right now —
        the refcount-1 subset of its table."""
        with self._lock:
            return sum(1 for b in self._tables.get(rid, ())
                       if self._refs.get(b, 0) == 1)

    def truncate(self, rid, n_tokens):
        """Shrink ``rid``'s table to cover just ``n_tokens`` slots,
        releasing tail blocks; a shared (refcount > 1) block stops the
        walk.  Returns the number of blocks released."""
        with self._lock:
            table = self._tables.get(rid)
            if table is None:
                return 0
            keep = max(1, blocks_for(max(1, int(n_tokens)),
                                     self.block_size))
            freed = 0
            while len(table) > keep:
                blk = table[-1]
                if self._refs.get(blk, 0) > 1:
                    break          # shared prefix block — never touch
                table.pop()
                released = self._deref(blk, retain=False)
                if released is not None:
                    self._free.append(released)
                freed += 1
            self._lens[rid] = len(table) * self.block_size
            chain = self._chain.get(rid)
            if chain is not None and len(chain) > len(table):
                del chain[len(table):]
            return freed

    # -- publishing ----------------------------------------------------------
    def note_tokens(self, rid, token_ids, salt=None):
        """Publish ``rid``'s newly-FULL blocks under their chain keys
        (``token_ids``: the sequence whose K/V is written so far).  A
        key already mapping to a different block keeps its mapping.
        No-op with the prefix cache off."""
        if not self.prefix_cache:
            return
        with self._lock:
            table = self._tables.get(rid)
            if table is None:
                return
            chain = self._chain.setdefault(rid, [])
            n_full = min(len(token_ids) // self.block_size, len(table))
            while len(chain) < n_full:
                b = len(chain)
                parent = chain[-1] if chain else salted_root(salt)
                key = _block_key(
                    parent,
                    token_ids[b * self.block_size:(b + 1) * self.block_size])
                blk = table[b]
                if key not in self._index and blk not in self._key_of:
                    self._index[key] = blk
                    self._key_of[blk] = key
                    self._parent[key] = (parent if chain else None)
                    if chain:
                        self._children[parent] = \
                            self._children.get(parent, 0) + 1
                    if self._summary is not None:
                        self._summary.add(key)
                chain.append(key)

    # -- release -------------------------------------------------------------
    def _drop_pending(self, blk):
        """``blk`` left every table before its queued restore ran (not
        through the engine, which drains restores in the step that
        allocated them; the public API allows it): it never received its
        K/V, so it must not stay published.  Re-park the host copies and
        unpublish.  Called under ``_lock``."""
        with self._lock:
            kept, dropped = [], []
            for b, a in self._pending_restores:
                (dropped if b == blk else kept).append((b, a))
            if not dropped:
                return
            self._pending_restores[:] = kept
            key = self._key_of.get(blk)
            if key is not None:
                parent = self._parent.get(key)
                self._unpublish(key)
                if self.host is not None:
                    self.host.unclaim(key, parent, dropped[0][1])

    def _deref(self, blk, retain):
        """Drop one reference; returns the block if it reached refcount
        0 UNPUBLISHED (the caller decides its fate), else None."""
        with self._lock:
            self._refs[blk] -= 1
            if self._refs[blk] > 0:
                return None            # another table still reads it
            del self._refs[blk]
            if self._pending_restores:
                self._drop_pending(blk)
            key = self._key_of.get(blk)
            if key is not None:
                if retain:
                    self._lru[key] = blk   # reusable AND evictable
                    self._lru.move_to_end(key)
                else:
                    self._unpublish(key)
                    self._free.append(blk)
                return None
            return blk

    def free(self, rid, retain=True):
        """Release ``rid``'s references (decref: blocks shared with
        another live table are untouched).  Refcount-0 published blocks
        park in the prefix LRU; unpublished ones park in the retained
        tier with ``retain=True`` or return to the free list."""
        with self._lock:
            blocks = self._tables.pop(rid)
            self._lens.pop(rid)
            self._chain.pop(rid, None)
            self._host_tokens.pop(rid, None)
            loose = []
            for blk in blocks:
                released = self._deref(blk, retain)
                if released is not None:
                    loose.append(released)
            if loose:
                if retain:
                    self._retained[rid] = loose
                else:
                    self._free.extend(loose)

    def reset(self):
        """Forget every table, the radix index and the LRUs.  Hosted
        entries stay (content-addressed, still valid for the ids they
        hash); restores queued against recycled blocks are dropped."""
        with self._lock:
            self._free = deque(range(1, self.num_blocks))
            self._tables.clear()
            self._lens.clear()
            self._retained.clear()
            self._refs.clear()
            self._index.clear()
            self._key_of.clear()
            self._parent.clear()
            self._children.clear()
            self._lru.clear()
            self._chain.clear()
            self._host_tokens.clear()
            del self._pending_restores[:]
            # the advertisement rebuilds from the surviving host tier
            if self._summary is not None:
                self._summary.clear()
                if self.host is not None:
                    for key in self.host.keys():
                        self._summary.add(key)
