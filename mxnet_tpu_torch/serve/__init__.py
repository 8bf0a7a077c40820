"""Continuous-batching LLM serving over a paged KV-cache (greedy core).

The port of ``mxnet_tpu.serve``: ``Engine`` (scheduler iterations of
whole-prompt prefills plus one batched decode), ``Scheduler``
(admission, back-pressure, preemption by recomputation),
``BlockManager`` (paged block accounting) and ``ServeStats``.
"""

from .engine import Engine
from .kv_block_manager import BlockManager, NoFreeBlocks
from .scheduler import (CANCELLED, FINISHED, REJECTED, RUNNING, WAITING,
                        QueueFull, Request, Scheduler)
from .stats import ServeStats, StatsRecorder

__all__ = ["Engine", "BlockManager", "NoFreeBlocks", "Request",
           "Scheduler", "QueueFull", "ServeStats", "StatsRecorder",
           "WAITING", "RUNNING", "FINISHED", "REJECTED", "CANCELLED"]
