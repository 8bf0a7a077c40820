"""Continuous-batching LLM serving over a paged KV-cache.

The port of ``mxnet_tpu.serve``: ``Engine`` (scheduler iterations of
whole-prompt prefills plus one batched decode, or one speculative
iteration with ``spec_k``; int8 weights and K/V, per-request
sampling, a host-DRAM KV tier, LoRA adapters, tensor-parallel shards
and the export store on request),
``Scheduler`` (admission, back-pressure, preemption by recomputation),
``BlockManager`` (paged block accounting) and ``HostKVPool`` (the host
tier), ``AdapterStore`` (the adapters' device slots and host tier),
``ServeStats`` and ``spec`` (the draft side of speculative decoding).
"""

from . import adapters, spec
from .adapters import AdapterStore, NoAdapterSlots
from .engine import Engine
from .kv_block_manager import BlockManager, HostKVPool, NoFreeBlocks
from .scheduler import (CANCELLED, FINISHED, REJECTED, RUNNING, WAITING,
                        QueueFull, Request, Scheduler)
from .stats import ServeStats, StatsRecorder

__all__ = ["Engine", "spec", "adapters", "AdapterStore", "NoAdapterSlots",
           "BlockManager", "HostKVPool", "NoFreeBlocks",
           "Request",
           "Scheduler", "QueueFull", "ServeStats", "StatsRecorder",
           "WAITING", "RUNNING", "FINISHED", "REJECTED", "CANCELLED"]
