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

Not ported yet: the host-DRAM tier (``HostKVPool``), the routing
advertisement (``RadixSummary``) and the prefill/decode handoff
(``export_blocks``/``import_blocks``/``has_blocks``) — ROADMAP §A items
8 and 14.  ``host_pool`` must be None.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict, deque

import numpy as np

from .. import telemetry
from ..base import env_flag

__all__ = ["BlockManager", "NoFreeBlocks", "blocks_for", "chain_keys",
           "salted_root"]

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
        if host_pool is not None:
            raise NotImplementedError(
                "BlockManager: the host-DRAM KV tier is not ported yet "
                "(ROADMAP §A item 8); host_pool must be None")
        self.num_blocks = num_blocks
        self.block_size = block_size
        if prefix_cache is None:
            prefix_cache = env_flag("MXTPU_SERVE_PREFIX_CACHE", True)
        self.prefix_cache = bool(prefix_cache)
        self.host = None
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
        self._m_resurrections = telemetry.counter(
            "mxtpu_serve_prefix_resurrections_total",
            "prefix hits that revived >= 1 block parked refcount-0 "
            "in the prefix LRU")

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

    def prefix_stats(self):
        """Prefix-cache population and hit/miss/evict counters (the
        host-tier fields stay zero until that tier is ported)."""
        with self._lock:
            looked = self.prefix_hits + self.prefix_misses
            shared = sum(1 for r in self._refs.values() if r > 1)
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
                    "discarded_tokens": self.prefix_discarded_tokens,
                    "host_hits": 0,
                    "host_restored_tokens": 0}

    def host_stats(self):
        """The host-tier occupancy snapshot (None: no tier yet)."""
        return None

    def host_tokens(self, rid):
        """Tokens of ``rid``'s table restored from the host tier (always
        0 until that tier is ported)."""
        return 0

    def fits_at_all(self, n_tokens):
        """Whether a request of ``n_tokens`` could EVER hold the cache
        alone — the admission-time rejection test."""
        return blocks_for(n_tokens, self.block_size) <= self.total_blocks

    # -- prefix lookup -------------------------------------------------------
    def _walk(self, token_ids, salt=None):
        """Longest cached prefix of ``token_ids`` at block granularity
        (called under ``_lock``) as a ``[(key, block)]`` chain,
        copy-on-write capped so at least one token is left to
        recompute."""
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
        while len(hits) * bs > n - 1:
            hits.pop()                 # COW: recompute the final span
        return hits

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
        """Reclaim the oldest refcount-0 published radix leaf; its K/V
        is gone for good (``discarded_tokens`` counts the loss)."""
        with self._lock:
            for key in self._lru:       # oldest first
                if self._children.get(key, 0) == 0:
                    blk = self._index[key]
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
            hits = []
            if self.prefix_cache and token_ids is not None:
                hits = self._walk(token_ids, salt=salt)
            # clear-miss precheck BEFORE any mutation or eviction
            if blocks_for(n_tokens, self.block_size) - len(hits) \
                    > self.free_blocks:
                raise NoFreeBlocks(
                    f"request {rid!r} needs "
                    f"{blocks_for(n_tokens, self.block_size)} blocks "
                    f"({len(hits)} cached), {self.free_blocks} "
                    "free/reclaimable")
            if self.prefix_cache and token_ids is not None:
                if hits:
                    saved = len(hits) * self.block_size
                    self.prefix_hits += 1
                    self.prefix_tokens_saved += saved
                    self._m_hits.inc()
                    self._m_saved.inc(saved)
                else:
                    self.prefix_misses += 1
                    self._m_misses.inc()
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
                # undo the hit references: a failed allocation must not
                # leave cached blocks pinned un-evictable
                for _, blk in hits:
                    self._deref(blk, retain=True)
                raise
            self._tables[rid] = [blk for _, blk in hits] + fresh
            self._lens[rid] = n * self.block_size
            self._chain[rid] = [key for key, _ in hits]
            if token_ids is not None:
                return (list(self._tables[rid]),
                        len(hits) * self.block_size)
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
                chain.append(key)

    # -- release -------------------------------------------------------------
    def _deref(self, blk, retain):
        """Drop one reference; returns the block if it reached refcount
        0 UNPUBLISHED (the caller decides its fate), else None."""
        with self._lock:
            self._refs[blk] -= 1
            if self._refs[blk] > 0:
                return None            # another table still reads it
            del self._refs[blk]
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
