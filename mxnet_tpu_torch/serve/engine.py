"""The serving engine: continuous batching over a paged KV-cache.

The port of ``mxnet_tpu/serve/engine.py``'s greedy core:

  eng = Engine(params, num_heads=12, device="cuda")
  eng.warmup()                                      # optional: every program
  req = eng.submit(prompt_ids, max_new_tokens=64)   # may raise QueueFull
  for tok in eng.stream(req):
      ...
  eng.shutdown()

Each ``step()`` is one scheduler iteration: at most
``max_prefills_per_step`` prefills (a whole prompt, the uncached suffix
of a prefix-cache hit, or one chunk of a long prompt), then ONE batched
single-token decode over every running request — or, with
``spec_k > 0``, one speculative iteration (``serve/spec.py``: a draft
program proposes k tokens a request, a verify program scores the k+1
positions, greedy acceptance emits 1..k+1 tokens).  Shapes are padded to
the reference's power-of-two buckets and the block-table width is fixed
at ``max_model_len / block_size``.  Cache-pressure policy (preemption by
recomputation, back-pressure), the prefix cache's radix index and the
chunked-prefill lane live in ``scheduler.Scheduler`` and
``kv_block_manager.BlockManager``; the engine executes the schedule it
is handed.

The KV-cache is ONE device tensor pair per engine, (layers, num_blocks,
block_size, kv_heads, head_dim), carved into blocks by the
``BlockManager``; with ``kv_dtype="int8"`` it is int8 beside a float32
scale pair (layers, num_blocks, block_size, kv_heads), one scale a slot
and head.  ``quantize="int8"`` stores every projection's weight as int8
with a per-output-channel scale, dequantized before its matmul
(``_wfc``).  The reference compiles one jit program per (kind, bucket)
for ``decode``, ``prefill`` and ``chunk``, plus ``verify``, ``draft``
and ``draft_chunk`` with speculative decoding on; here
each is a :class:`_Program` that owns static input buffers and runs one
body, which writes the cache in place (``index_put_``) where the
reference used ``.at[].set`` under buffer donation.  On CUDA the program
warms its body on a side stream and captures it once as a CUDA graph;
every later call replays the graph.  On the CPU (which a caller must
ask for) it calls the same body on the same buffers.  A failed capture
or replay raises: nothing runs the body eagerly on CUDA in its place.

Programs are per engine, where the reference's ``_STEP_CACHE`` is per
process: a graph closes over one engine's parameter and cache
addresses.  All of an engine's graphs share one memory pool; each
replay's output is copied to the host before another graph replays.
``warmup()`` builds every program a manifest (``aot/warmup.py``) or the
full bucket grid lists, before traffic.  Decode and the draft's steps
attend through ``ops.attention.paged_attention``, the Hopper kernel on
CUDA (int8 K/V dequantized inside it); prefill, chunk and verify
attention are dense torch, as the reference's are dense jnp.

With ``host_kv_bytes`` a host-DRAM tier sits under the prefix cache
(``kv_block_manager.HostKVPool``): an evicted prefix block's K/V is
copied to the host, and a later radix hit on it runs the ``restore``
program (the parked bytes staged by one pinned copy and scattered into
the cache) before anything reads the block.  ``sampling=True`` (or
stochastic defaults) makes per-request temperature, top-p and top-k
per-row program inputs: one graph per (kind, bucket) serves any mix,
each emitted token comes with its logprob and the top ``TOP_LOGPROBS``
candidates, ``n > 1`` samples share the prompt's blocks copy-on-write,
and speculative decoding accepts by rejection sampling.  Randomness is
a counter-based hash of (a per-call seed input, a purpose, the element's
index), drawn as Gumbel noise in the program: a replay draws afresh
because the seed is an input, and no generator state lives in a graph.

With ``adapters=S`` the engine multiplexes LoRA adapters
(``serve/adapters.py``): every target projection adds its low-rank delta
``scale * x @ A.T @ B.T``, gathered from device stacks by each row's
slot, a program input like the sampling parameters.  One graph per
(kind, bucket) serves any mix of base rows (slot 0, an exact zero
delta) and adapter rows; a request pins its slot from ``submit`` to its
terminal event.  The draft of speculative decoding stays the base model.

Telemetry is the reference's, call site for call site
(``telemetry/``): the request tracer threads every lifecycle event into
the always-on flight ring (and, with ``MXTPU_REQUEST_TRACE``, a JSONL
timeline a request); an engine exception, a deadline miss or a
rejection rate over ``MXTPU_FLIGHT_REJECT_RATE`` dumps the ring to
``MXTPU_FLIGHT_DIR``; each step records a ``step`` flight event, its
spans and live-state gauges, and its phase laps (``StepProfiler``);
``statusz()`` is registered on ``/statusz``; ``PerfAttrib`` keeps the
analytic cost of every (kind, bucket) and, on sampled steps, times each
program call with CUDA events around the graph replay.  Every instrument
sits on the host dispatch path, never inside a program body (a body's
Python runs once, at capture), and reads host state only, so an HTTP
thread may render ``/statusz`` while ``warmup()`` captures.  With
``MXTPU_NUMERIC_WATCH=1`` the decode, prefill, chunk and verify bodies
also return ``isfinite(logits).all()``, read in the same copy as the
tokens; a false flag records an anomaly and dumps.

With ``aot_dir`` (or ``MXTPU_AOT_DIR``) every program goes through the
export store (``aot/export_store.py``): a body is exported with
``torch.export`` over a module that takes its inputs, parameters,
caches, scales and adapter stacks as inputs (the artifact holds no
weights) and saved under the engine's fingerprint and its (kind,
bucket); a restarted engine loads it and runs the loaded program's
module instead of tracing the body, and on CUDA captures it as a graph
as it would the body.  ``mxtpu_aot_programs_total{kind,source}`` counts
``source="trace"`` (built from the body) and ``source="artifact"``
(loaded).  A stale, corrupt or truncated artifact costs a trace.

With ``tp=N`` (or ``MXTPU_SERVE_TP``) the parameters are placed by
regex partition rules (``parallel/partition.py``; the GPT default or
``partition_rules=``/``MXTPU_SERVE_PARTITION_RULES``) on a ``{'tp': N}``
mesh (``parallel/mesh.py``), one shard a mesh device, and the K/V-cache
is born head-sharded: each shard holds ``kv_heads/N`` heads of every
block.  In the bodies a column-sharded projection gives each shard its
heads (or hidden units), a row-sharded one partial sums reduced over
the shards with the bias added once after, and a replicated one is
computed whole and sliced to the shard's heads where attention needs
them; paged attention runs once a shard and layer on that shard's
cache, inside the one program.  The mesh may only hold shards of one
device (``MXTPU_TORCH_VIRTUAL_DEVICES``): distinct cards raise.

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP §A item: Symbol-driven config, the draft's included, and the
``MXTPU_TIMESERIES`` ring, whose sampler is ``ServeMonitor`` (15).
"""

from __future__ import annotations

import collections
import functools
import json
import math
import os
import queue
import threading
import time
import traceback
import weakref

import numpy as np
import torch

from .. import aot, telemetry
from .. import profiler as profiler_mod
from ..aot import export_store
from ..base import env_flag, env_int
from ..context import resolve_device
from ..convert import params_from_numpy
from ..models.generate import (_fc, _gelu, _gumbel, _ln,
                               detect_gpt_variant, reconcile_decode_config)
from ..ops import paged_attention_cuda as _pac
from ..ops.attention import paged_attention, resolve_paged_impl
from ..parallel import mesh as mesh_mod
from ..parallel import partition as partition_mod
from ..telemetry import cudamon, profiling
from ..telemetry import flight as flight_mod
from ..telemetry import statusz as statusz_mod
from ..telemetry.perf_attrib import PerfAttrib
from ..telemetry.request_trace import RequestTracer
from . import adapters as adapters_mod
from . import spec as spec_mod
from .kv_block_manager import BlockManager, HostKVPool, dtype_name
from .scheduler import (CANCELLED, FINISHED, REJECTED, WAITING, QueueFull,
                        Request, Scheduler)
from .stats import StatsRecorder

__all__ = ["Engine", "TOP_LOGPROBS"]

# the static model config the program bodies close over; ``kv_quant``
# says the cache is int8 with scales, ``paged_impl`` is the decode
# attention's implementation ("cuda" or "torch"); ``sampling`` and
# ``sample_cap`` (the candidate width) are on in sampling mode only;
# ``numeric_watch`` adds the logits-finite flag to the decode, prefill,
# chunk and verify outputs; ``tp`` is the tensor-parallel degree and
# ``split`` the sharded parameters' ``(name, dim)`` pairs (``()`` at
# tp 1), the parameter layout the bodies compute over
_ModelCfg = collections.namedtuple("_ModelCfg", [
    "name", "n_layers", "num_heads", "head_dim", "kv_heads", "pos_table",
    "swiglu", "tied", "rmsnorm", "window", "block_size", "kv_quant",
    "paged_impl", "sampling", "sample_cap", "numeric_watch", "tp",
    "split"],
    defaults=(False, 0, False, 1, ()))

# top-logprob candidates every sampling-mode program returns for each
# sampled position (the request's ``logprobs`` picks how many surface)
TOP_LOGPROBS = 5

# the Gumbel draws' purposes: each kind of draw hashes its own stream
# (a draft step j uses _DRAFT + j)
_SAMPLE, _ACCEPT, _RESIDUAL, _BONUS, _DRAFT = 1, 2, 3, 4, 16

# the staging dtypes a program's host views expose as numpy arrays (the
# others, bfloat16 among them, as CPU tensors)
_NUMPY_DTYPES = (torch.int32, torch.float32, torch.int8)

# eager runs of a body on a side stream before its capture: the first
# builds the kernel libraries and sets their launch attributes, which a
# capture must not do
_WARM_RUNS = 2

# a capture's mode: "thread_local" forbids unsafe CUDA calls on the
# capturing thread only (torch's default "global" makes a sibling
# engine's stream sync fail and end the capture).  The capture and its
# warm-up runs hold the profiler's capture lock, so no profiler start or
# stop lands inside them and two captures never overlap
_CAPTURE_MODE = "thread_local"

# the paged op's launch counters tick on the host when a graph is
# captured, and a replay launches the kernels without calling the op: a
# program takes its own warm-up and capture counts off again (read from
# its thread's tally, so a sibling engine stepping on another thread
# keeps its counts) and adds what the capture counted at every replay,
# each under the op's counter lock (chip_smoke.py holds these sums
# against the kernel instances in a profiler trace)


def _next_bucket(n, cap):
    """Smallest power-of-two >= n, clamped to cap."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _bucket_ladder(cap):
    """Power-of-two buckets up to (and always including) ``cap``: what
    live traffic's ``_next_bucket`` clamp can hit."""
    out, b = [], 1
    while b < cap:
        out.append(b)
        b *= 2
    return out + [cap]


def _rope(u, pos, base=10000.0):
    """Rotate (N, H, Dh) rows by their own positions (N,) — matches
    ``models/generate.py``'s scalar-position ``_rot``."""
    half = u.shape[-1] // 2
    inv = base ** (-torch.arange(half, dtype=torch.float32,
                                 device=u.device) / half)
    ang = pos.float()[:, None] * inv                       # (N, half)
    cos = torch.cos(ang)[:, None, :]
    sin = torch.sin(ang)[:, None, :]
    uf = u.float()
    u1, u2 = uf[..., :half], uf[..., half:]
    return torch.cat([u1 * cos - u2 * sin, u1 * sin + u2 * cos],
                     dim=-1).to(u.dtype)


# -- per-request sampling-parameter validation (submit + Engine defaults) ----
def _valid_temperature(t):
    t = float(t)
    if not math.isfinite(t) or t < 0.0:
        raise ValueError(f"temperature must be finite and >= 0 (got {t})")
    return t


def _valid_top_p(p):
    p = float(p)
    if not math.isfinite(p) or not 0.0 < p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1] (got {p})")
    return p


def _valid_top_k(k):
    """None/0 = off; else a positive int (values past ``sample_cap``
    behave as the cap)."""
    if k is None or k == 0:
        return None
    k = int(k)
    if k < 1:
        raise ValueError(f"top_k must be None/0 or >= 1 (got {k})")
    return k


class _Program:
    """One (kind, bucket) program of one engine.

    ``fields`` names the inputs: ``(name, shape)`` for int32, or
    ``(name, shape, dtype)``.  The fields of one dtype are views of ONE
    device buffer, staged from one host buffer (pinned on CUDA) by one
    ``non_blocking`` copy a call: fill :meth:`stage`'s views (numpy
    arrays for int32, float32 and int8; CPU tensors for the others,
    bfloat16 among them), then call the program.  ``body`` takes the
    inputs by name and returns one device tensor (a call returns it as
    a list), a tuple of them (a call returns a tuple of numpy arrays),
    or None (a call returns None without waiting for the device).

    On CUDA the body runs ``_WARM_RUNS`` times on a side stream on
    all-zero inputs (so every K/V write lands in the null block 0),
    then is captured once on that stream into ``pool``, on ``capturer``'s
    thread and stream (the engine's :class:`_CaptureThread`; in
    ``_CAPTURE_MODE``, warm-up and capture holding the profiler's
    capture lock; a failed capture is undone by
    :func:`_abandon_capture`); calls replay the graph.  Each
    call records an event after its staging copy, and :meth:`stage`
    waits on it: a program whose output is never read (``restore``)
    cannot have its pinned buffer refilled under a copy still in flight.
    Warm-up and capture take their own launches off the counters again,
    and each replay adds what the capture counted.  On the CPU a call runs
    the body on the same buffers.  ``calls`` counts the calls.

    A call is :meth:`launch` (stage, replay, queue the outputs' copy to
    the host) then :meth:`result` (wait for them), so the engine can
    time the launch and attribute the wait apart.
    """

    def __init__(self, fields, body, device, pool=None, capturer=None):
        cuda = device.type == "cuda"
        specs = [(f[0], tuple(f[1]), f[2] if len(f) > 2 else torch.int32)
                 for f in fields]
        sizes = {}
        for _, shape, dt in specs:
            sizes[dt] = sizes.get(dt, 0) + math.prod(shape)
        self._host, self._dev = {}, {}
        for dt, n in sizes.items():
            self._host[dt] = torch.zeros(n, dtype=dt, pin_memory=cuda)
            self._dev[dt] = torch.zeros(n, dtype=dt, device=device)
        self._views, self._inputs, off = {}, {}, dict.fromkeys(sizes, 0)
        for name, shape, dt in specs:
            o, n = off[dt], math.prod(shape)
            host = self._host[dt][o:o + n].view(shape)
            self._views[name] = (host.numpy() if dt in _NUMPY_DTYPES
                                 else host)
            self._inputs[name] = self._dev[dt][o:o + n].view(shape)
            off[dt] = o + n
        self._body = body
        self._device = device
        self._graph = None
        self._copied = None            # the last staging copy's event
        self._pending = None           # the CPU body's last output
        self.calls = 0
        if cuda:
            caller = torch.cuda.current_stream(device)
            capturer.run(lambda: self._capture(pool, capturer.stream,
                                               caller))

    def _capture(self, pool, side, cur):
        """Warm the body and capture it on ``side``, ordered after
        ``cur`` (the constructing thread's stream), which then waits for
        the capture."""
        with profiler_mod.capture_lock:
            before = _pac.thread_counts()
            side.wait_stream(cur)
            graph = torch.cuda.CUDAGraph()
            with torch.no_grad(), torch.cuda.stream(side):
                for _ in range(_WARM_RUNS):
                    self._body(**self._inputs)
                mark = _pac.thread_counts()
                graph.capture_begin(pool=pool,
                                    capture_error_mode=_CAPTURE_MODE)
                try:
                    out = self._body(**self._inputs)
                except BaseException:
                    _abandon_capture(graph, self._device, ended=False)
                    raise
                try:
                    graph.capture_end()
                except BaseException:
                    _abandon_capture(graph, self._device, ended=True)
                    raise
            cur.wait_stream(side)
            after = _pac.thread_counts()
            self._deltas = [a - m for a, m in zip(after, mark)]
            _pac.add_counts(*[b - a for a, b in zip(after, before)])
            self._graph, self._out = graph, out
            outs = () if out is None else (out,) if torch.is_tensor(out) \
                else out
            self._out_host = [torch.empty(o.shape, dtype=o.dtype,
                                          pin_memory=True) for o in outs]
            self._copied = torch.cuda.Event()

    @property
    def captured(self):
        return self._graph is not None

    def stage(self):
        """The inputs' host views, zeroed (padding rows read the null
        block and position 0), once the previous call's staging copy has
        left them."""
        if self._copied is not None:
            self._copied.synchronize()
        for h in self._host.values():
            h.zero_()
        return self._views

    def launch(self, timing=None):
        """Stage the inputs and run the program: on CUDA, replay the
        graph and queue its outputs' copy to the host, without waiting;
        on the CPU, run the body.  ``timing`` is what ``PerfAttrib.t0()``
        gave: on CUDA its event pair is recorded just around the replay
        (so a sampled time is the graph's, not the staging's); None and
        the CPU's clock read are not used here."""
        self.calls += 1
        for dt, host in self._host.items():
            self._dev[dt].copy_(host, non_blocking=True)
        if self._graph is None:
            self._pending = self._body(**self._inputs)
            return
        if self._copied is not None:
            self._copied.record()
        if timing is not None:
            timing[0].record()
        self._graph.replay()
        if timing is not None:
            timing[1].record()
        _pac.add_counts(*self._deltas)
        if self._out is None:
            return
        outs = (self._out,) if torch.is_tensor(self._out) else self._out
        for h, o in zip(self._out_host, outs):
            h.copy_(o, non_blocking=True)

    def result(self):
        """The last launch's outputs on the host (None, a list, or a
        tuple of numpy arrays), waiting for them on CUDA; a program
        without outputs returns None without waiting."""
        if self._graph is None:
            out, self._pending = self._pending, None
            return _host_outputs(out)
        if self._out is None:
            return None
        torch.cuda.current_stream(self._device).synchronize()
        if torch.is_tensor(self._out):
            return self._out_host[0].tolist()
        return _host_outputs(tuple(self._out_host))

    def __call__(self, timing=None):
        self.launch(timing)
        return self.result()


def _host_outputs(out):
    """A body's output as a call returns it: None, one tensor as a list,
    a tuple of tensors as a tuple of numpy arrays (copies)."""
    if out is None:
        return None
    if torch.is_tensor(out):
        return out.tolist()
    return tuple(o.detach().cpu().numpy().copy() for o in out)


class _CaptureThread:
    """The thread and the side stream an engine's CUDA-graph captures run
    on, one each per engine, for the engine's lifetime.  torch keeps one
    cuBLAS workspace per (thread's cuBLAS handle, stream), allocated by a
    program's warm-up and kept after the engine is gone, and a graph
    replays with the workspace its capture used.  A new side stream a
    program left 22 workspaces (704 MiB on the H100) an engine and
    thread; and engines captured on one thread and stream share one,
    which their graphs, replayed at once from two step threads, would
    both write.  A thread of its own gives an engine a cuBLAS handle no
    other live engine holds, and one stream keeps it to one
    workspace."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self._jobs = queue.SimpleQueue()
        self._thread = threading.Thread(
            target=self._loop, args=(self._jobs, device), daemon=True,
            name="mxtpu-capture")
        self._thread.start()

    @staticmethod
    def _loop(jobs, device):
        if device.index is not None:
            torch.cuda.set_device(device)
        while True:
            job = jobs.get()
            if job is None:
                return
            fn, box, done = job
            try:
                box["out"] = fn()
            except BaseException as e:  # re-raised on the caller's thread
                box["err"] = e
            done.set()
            job = fn = box = done = None   # hold nothing between jobs

    def run(self, fn):
        """``fn()`` on the capture thread; its result, or its error
        raised here."""
        if threading.current_thread() is self._thread:
            return fn()
        box, done = {}, threading.Event()
        self._jobs.put((fn, box, done))
        done.wait()
        if "err" in box:
            raise box["err"]
        return box.get("out")

    def stop(self):
        self._jobs.put(None)


def _abandon_capture(graph, device, ended):
    """Undo what a failed capture leaves behind (the caller's ``with``
    puts the thread back on its own stream: ``torch.cuda.graph`` left
    it on the process's shared capture stream when ``capture_end``
    raised, and later engines on that thread then gave other tokens).
    A body that raised leaves its stream capturing: end the capture
    (which then raises, the capture being invalid, or gives a graph
    nobody keeps).  A capture that did not end cleanly can also leave its
    pool among the caching allocator's captures in progress, with a
    filter over the dead graph: take it out (the pool's use count
    stays: the engine is failing)."""
    if not ended:
        try:
            graph.capture_end()
            return                   # ended cleanly: torch undid its state
        except RuntimeError:
            pass
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    try:
        torch._C._cuda_endAllocateToPool(index, graph.pool())
    except RuntimeError:
        pass                         # torch ended it before it raised


class Engine:
    """Continuous-batching inference engine over a paged KV-cache.

    Args:
      params: gpt() parameter dict (numpy arrays or torch tensors;
        fused-qkv and ``*_wscale`` checkpoints are normalized at load).
      num_heads / window: decode config not recoverable from weight
        shapes (window = the trained sliding-window radius, 0 = full).
      symbol: the trained ``gpt_symbol`` (e.g. from
        ``model.load_checkpoint``): ``num_heads`` and ``window`` are read
        from it (``models.reconcile_decode_config``); an explicit value
        that contradicts it raises.  ``draft_symbol`` does the same for
        the draft.
      block_size: tokens per KV-cache block
        (env ``MXTPU_SERVE_BLOCK_SIZE``, default 16).
      num_blocks: physical blocks in the cache, incl. the reserved
        null block (env ``MXTPU_SERVE_NUM_BLOCKS``, default 512).
      max_batch: decode batch ceiling (env ``MXTPU_SERVE_MAX_BATCH``,
        default 8).
      max_queue: admission-queue bound; ``submit`` beyond it raises
        ``QueueFull`` (env ``MXTPU_SERVE_MAX_QUEUE``, default 64).
      max_model_len: longest prompt+generation length served; defaults
        to the positional-table length (learned positions) or the cache
        capacity at ``max_batch`` concurrency (rope).
      max_prefills_per_step: prompt prefills per iteration (default 1).
      tenant_share: fair-share admission fraction
        (env ``MXTPU_SERVE_TENANT_SHARE``, default 1.0 = strict FIFO).
      prefix_cache: content-addressed KV-block sharing across requests
        (env ``MXTPU_SERVE_PREFIX_CACHE``, default on): a new prompt's
        longest block-aligned cached prefix is reused and only the
        suffix is prefilled, through the ``chunk`` program.
      prefill_chunk: chunked-prefill threshold in tokens (env
        ``MXTPU_SERVE_PREFILL_CHUNK``, default 512): a prompt whose
        uncached remainder exceeds it prefills one chunk per iteration
        interleaved with decode steps.  0 disables chunking.
      spec_k: draft tokens proposed per speculative iteration (env
        ``MXTPU_SERVE_SPEC``, default 0 = plain decode, and 0 leaves
        programs, warm-up grid and fingerprint as they were).  Needs
        ``draft_params``: a small gpt() checkpoint with the target's
        vocab, decoded with ``draft_num_heads`` / ``draft_window`` under
        the name prefix ``draft_name`` (default ``name``).
      quantize: ``"int8"`` (env ``MXTPU_SERVE_QUANT``) stores every
        projection weight per-output-channel int8 plus a float32
        ``*_wscale``, dequantized before each matmul; embeddings, norms,
        biases and a tied head stay floating point.  Default off.
      kv_dtype: ``"int8"`` (env ``MXTPU_SERVE_KV_DTYPE``) stores K/V
        blocks as int8 with a float32 scale a slot and head; every
        program quantizes on write and dequantizes to attend.  Default
        off: the parameter dtype.
      host_kv_bytes: host-DRAM tier under the prefix cache (env
        ``MXTPU_SERVE_HOST_KV_BYTES``, default 0 = off, and off leaves
        programs, warm-up grid, fingerprint and tokens as they were).
        With a byte budget, an evicted prefix block's K/V (and int8
        scales) is copied to a host pool instead of discarded, and a
        later radix hit restores it through the ``restore`` program
        instead of recomputing it.  The tier never enters the
        fingerprint; with it on the grid adds the restore ladder.
      temperature / top_p / top_k / seed: the per-request sampling
        defaults (``submit`` overrides them).  0.0 / 1.0 / None is
        greedy argmax.  Stochastic defaults turn sampling mode on.
        ``seed`` seeds the engine's host generator, which draws one
        seed input per sampling program call.
      sampling: per-request sampling mode (env ``MXTPU_SERVE_SAMPLING``;
        on by itself with stochastic defaults).  Temperature, top-p and
        top-k become per-row program inputs, never a capture key, so
        one graph per (kind, bucket) serves any mix, greedy rows
        included; each emitted token records its logprob and the top
        ``TOP_LOGPROBS`` candidates.  Off (the default) leaves the
        greedy programs, fingerprint and tokens as they were.
      sample_cap: candidate width of the sampling programs (env
        ``MXTPU_SERVE_SAMPLE_CAP``, default 64): one ``topk`` of the
        scaled logits, sampled within; ``top_k`` past it behaves as the
        cap, and a nucleus needing more candidates is cut there.
      adapters: LoRA adapter device slots, slot 0 (the base model)
        included (env ``MXTPU_SERVE_ADAPTERS``, default 0 = off, and off
        leaves programs, fingerprint and tokens as they were; 1 raises).
        On, ``adapter_store`` registers adapters and ``submit(adapter_id=)``
        serves a request through one; prefill and chunk take a ``slot``
        input and decode and verify per-row ``slots``.
      adapter_rank: the slots' padded rank ceiling (env
        ``MXTPU_SERVE_ADAPTER_RANK``, default 8).
      adapter_host_bytes: the adapter host tier's byte budget (env
        ``MXTPU_SERVE_ADAPTER_HOST_BYTES``, default 0 = unbounded).
      tp: tensor-parallel degree (env ``MXTPU_SERVE_TP``, default 1):
        must divide ``num_heads`` and the K/V heads, and not exceed the
        visible devices (physical ones x ``MXTPU_TORCH_VIRTUAL_DEVICES``).
        At 1 nothing is sharded and programs, fingerprint and tokens
        stay as they were.
      partition_rules: the ``(pattern, PartitionSpec)`` rules, or their
        ``MXTPU_SERVE_PARTITION_RULES`` text, placing the parameters at
        tp > 1 (default ``parallel.gpt_partition_rules``).
      aot_dir: the export store's directory (env ``MXTPU_AOT_DIR``,
        default none): programs are exported there on a miss and loaded
        on a hit.
      clock: injectable monotonic clock (tests drive deadlines).
      device: where weights, cache and programs live (default
        ``"cuda"``; raises when CUDA is absent — no CPU fallback).
      dtype: parameter/activation dtype (default: the checkpoint's);
        int8 weights stay int8 and their scales float32.

    ``MXTPU_WARMUP_MANIFEST=<path>`` records the (kind, bucket)
    programs traffic ran, for a later ``warmup(path)``.
    """

    def __init__(self, params, num_heads=None, window=None, name="gpt",
                 block_size=None, num_blocks=None, max_batch=None,
                 max_queue=None, max_model_len=None,
                 max_prefills_per_step=1, clock=time.monotonic,
                 device="cuda", dtype=None, tenant_share=None,
                 prefix_cache=None, prefill_chunk=None, temperature=0.0,
                 top_k=None, top_p=None, sampling=None, sample_cap=None,
                 seed=0, tp=None,
                 quantize=None, kv_dtype=None, spec_k=None,
                 draft_params=None, draft_num_heads=None, draft_window=None,
                 draft_name=None, draft_symbol=None, adapters=None,
                 adapter_rank=None, adapter_host_bytes=None,
                 host_kv_bytes=None, aot_dir=None, symbol=None,
                 partition_rules=None):
        if symbol is not None:
            num_heads, window = reconcile_decode_config(symbol, num_heads,
                                                        window)
        if num_heads is None:
            raise ValueError("num_heads is required (pass it, or pass "
                             "symbol= to read it from the trained graph)")
        window = 0 if window is None else int(window)
        if window < 0:
            raise ValueError(f"window must be >= 0 (got {window})")
        # sampling mode: the engine defaults are per-request defaults;
        # stochastic ones (or sampling=True / MXTPU_SERVE_SAMPLING=1)
        # turn it on, and off is inert
        self.temperature = _valid_temperature(temperature)
        self.top_p = _valid_top_p(1.0 if top_p is None else top_p)
        self.top_k = _valid_top_k(top_k)
        stochastic = (self.temperature > 0.0 or self.top_p < 1.0
                      or self.top_k is not None)
        if sampling is None:
            sampling = (env_flag("MXTPU_SERVE_SAMPLING", False)
                        or stochastic)
        self._sampling = bool(sampling)
        if not self._sampling and stochastic:
            raise ValueError(
                "sampling=False forces the greedy-only programs, which "
                "cannot serve temperature/top_p/top_k defaults — drop "
                "sampling=False or the stochastic defaults")
        self.sample_cap = (int(sample_cap) if sample_cap is not None
                           else env_int("MXTPU_SERVE_SAMPLE_CAP", 64))
        if self.sample_cap < 1:
            raise ValueError(
                f"sample_cap must be >= 1 (got {self.sample_cap})")
        # one int32 seed input per sampling program call, drawn on the
        # host (a graph replays with whatever seed it is staged)
        self._gen = torch.Generator().manual_seed(int(seed))
        self.host_kv_bytes = (int(host_kv_bytes)
                              if host_kv_bytes is not None
                              else env_int("MXTPU_SERVE_HOST_KV_BYTES", 0))
        if self.host_kv_bytes < 0:
            raise ValueError(
                f"host_kv_bytes must be >= 0 (got {self.host_kv_bytes})")
        # quantized serving: both default off, and off is inert (same
        # programs, fingerprint and tokens as an engine without them)
        if quantize is None:
            quantize = os.environ.get("MXTPU_SERVE_QUANT") or None
        if quantize not in (None, "int8"):
            raise ValueError(
                f"quantize must be None or 'int8' (got {quantize!r})")
        self.quantize = quantize
        if kv_dtype is None:
            kv_dtype = os.environ.get("MXTPU_SERVE_KV_DTYPE") or None
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype must be None or 'int8' (got {kv_dtype!r})")
        self._kv_quant = kv_dtype == "int8"
        # LoRA multiplexing: off by default, and off is inert.  The slot
        # count includes the reserved all-zero base slot 0
        self._adapters = (int(adapters) if adapters is not None
                          else env_int("MXTPU_SERVE_ADAPTERS", 0))
        if self._adapters < 0 or self._adapters == 1:
            raise ValueError(
                f"adapters must be 0 (off) or >= 2 slots including the "
                f"reserved base slot 0 (got {self._adapters})")
        self.adapter_rank = (int(adapter_rank) if adapter_rank is not None
                             else env_int("MXTPU_SERVE_ADAPTER_RANK", 8))
        if self._adapters and self.adapter_rank < 1:
            raise ValueError(
                f"adapter_rank must be >= 1 (got {self.adapter_rank})")
        self.adapter_host_bytes = (
            int(adapter_host_bytes) if adapter_host_bytes is not None
            else env_int("MXTPU_SERVE_ADAPTER_HOST_BYTES", 0)) or None
        self.spec_k = (int(spec_k) if spec_k is not None
                       else env_int(spec_mod.ENV_SPEC, 0))
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0 (got {self.spec_k})")
        if self.spec_k and draft_params is None:
            raise ValueError(
                "spec_k > 0 requires draft_params (a small gpt() "
                "checkpoint whose vocab matches the target's)")

        self.device = resolve_device(device)
        self.block_size = (int(block_size) if block_size is not None
                           else env_int("MXTPU_SERVE_BLOCK_SIZE", 16))
        self.num_blocks = (int(num_blocks) if num_blocks is not None
                           else env_int("MXTPU_SERVE_NUM_BLOCKS", 512))
        self.max_batch = (int(max_batch) if max_batch is not None
                          else env_int("MXTPU_SERVE_MAX_BATCH", 8))
        max_queue = (int(max_queue) if max_queue is not None
                     else env_int("MXTPU_SERVE_MAX_QUEUE", 64))

        self.tp = int(tp) if tp is not None else env_int("MXTPU_SERVE_TP", 1)
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1 (got {self.tp})")
        # weight-only int8 quantizes the normalized checkpoint at its
        # own precision, then casts what stays floating point.  At tp > 1
        # this happens on the host, and each shard is copied alone
        self.params = params_from_numpy(
            params, self.device if self.tp == 1 else "cpu",
            dtype=None if self.quantize else dtype, name=name)
        self.spec = detect_gpt_variant(self.params, num_heads, name)
        if self.quantize:
            self.params = {
                k: (v if dtype is None or k.endswith("_wscale")
                    or not v.is_floating_point() else v.to(dtype))
                for k, v in _quantize_gpt_params(
                    self.params, name, self.spec).items()}
        self.name = name
        self.num_heads = int(num_heads)
        adapter_stems = (adapters_mod.gpt_stems(
            name, self.spec["n_layers"], self.spec["swiglu"],
            self.spec["tied"], self.params) if self._adapters else None)
        # the tensor-parallel mesh and layout (tp 1: none)
        self.mesh = None
        self._rules = self._rules_digest = None
        self._split = {}               # sharded parameter -> its dim
        if self.tp > 1:
            self._shard_params(partition_rules)
        self.window = window
        cache_tokens = (self.num_blocks - 1) * self.block_size
        if max_model_len is None:
            max_model_len = (self.spec["pos_table"]
                             or max(self.block_size,
                                    cache_tokens // max(1, self.max_batch)))
        self.max_model_len = int(min(max_model_len, cache_tokens))
        if (self.spec["pos_table"] is not None
                and self.max_model_len > self.spec["pos_table"]):
            raise ValueError(
                f"max_model_len={self.max_model_len} exceeds the "
                f"positional table ({self.spec['pos_table']})")
        # fixed block-table width: one decode shape per batch bucket
        self.table_width = -(-self.max_model_len // self.block_size)

        # the host tier (None = off: every prefix eviction discards)
        self._host_pool = (HostKVPool(self.host_kv_bytes,
                                      block_tokens=self.block_size)
                           if self.host_kv_bytes else None)
        self.blocks = BlockManager(self.num_blocks, self.block_size,
                                   prefix_cache=prefix_cache,
                                   host_pool=self._host_pool)
        # always registered: eviction offloads only with a pool, but
        # export_blocks copies device blocks through it on any engine
        self.blocks.set_offload_source(self._host_kv_fetch)
        # request-scoped observability: the tracer threads every
        # lifecycle event (scheduler decisions included) into the flight
        # ring, the optional JSONL export (MXTPU_REQUEST_TRACE) and the
        # Chrome-trace request tracks; its terminal hook drops an adapter
        # pin and judges the SLO triggers
        self._rtrace = RequestTracer()
        self._rtrace.on_terminal = self._on_request_terminal
        self.scheduler = Scheduler(self.blocks, self.max_batch, max_queue,
                                   max_prefills_per_step, clock=clock,
                                   trace=self._rtrace,
                                   tenant_share=tenant_share,
                                   prefill_chunk=prefill_chunk,
                                   spec_slots=self.spec_k)
        self._stats = StatsRecorder(clock=clock)
        self.clock = clock
        self._step_id = 0
        # SLO breach -> flight dump: deadline misses always (rate-limited
        # by the recorder), the rejection rate when the env threshold is
        # set (fraction of the last 100 terminal requests)
        self._slo_window = collections.deque(maxlen=100)
        try:
            self._reject_rate_thr = float(
                os.environ.get(flight_mod.ENV_REJECT_RATE, "") or 0.0)
        except ValueError:
            self._reject_rate_thr = 0.0
        self._numeric_watch = env_flag("MXTPU_NUMERIC_WATCH", False)
        self.decode_steps = 0          # batched decode passes run
        self._noop_steps = 0
        self._alive = True
        # n > 1 sample groups whose siblings wait for the primary's
        # prefill to publish the prompt's blocks (submit appends from
        # any thread, the step thread drains)
        self._fanout_lock = threading.Lock()
        self._pending_fanout = []      # guarded-by: _fanout_lock

        L = self.spec["n_layers"]
        dt = _first(self.params[f"{name}_tok_embed_weight"]).dtype
        # born head-sharded at tp > 1: each shard holds kv_heads/tp heads
        # of every block (block accounting never changes)
        shape = (L, self.num_blocks, self.block_size,
                 self.spec["kv_heads"] // self.tp, self.spec["head_dim"])
        cache_dt = torch.int8 if self._kv_quant else dt
        self._cache_k = self._zeros(shape, cache_dt)
        self._cache_v = self._zeros(shape, cache_dt)
        self._scale_k = self._scale_v = None
        if self._kv_quant:
            # one float32 scale a slot and head, indexed by the same
            # block ids, sharded on the same head axis
            self._scale_k = self._zeros(shape[:-1], torch.float32)
            self._scale_v = self._zeros(shape[:-1], torch.float32)
        # the adapter stacks in the activation dtype (int8 weights never
        # make the deltas int8); slot 0 stays all zero.  Under tp a stack
        # follows its parent projection: an out-sharded parent shards B's
        # d_out (A replicated), an in-sharded one A's d_in (B replicated)
        self.adapter_store = None
        if self._adapters:
            stack_split = {}
            for stem in adapter_stems:
                wdim = self._split.get(f"{stem}_weight")
                if wdim == 0:
                    stack_split[f"{stem}_B"] = 1
                elif wdim == 1:
                    stack_split[f"{stem}_A"] = 2
            self.adapter_store = adapters_mod.AdapterStore(
                adapter_stems, self.adapter_rank, self._adapters, dtype=dt,
                device=self.device, host_bytes=self.adapter_host_bytes,
                split=stack_split, shards=self.tp)
        self._cfg = _ModelCfg(
            name=name, n_layers=L, num_heads=self.num_heads,
            head_dim=self.spec["head_dim"], kv_heads=self.spec["kv_heads"],
            pos_table=self.spec["pos_table"], swiglu=self.spec["swiglu"],
            tied=self.spec["tied"], rmsnorm=self.spec["rmsnorm"],
            window=self.window, block_size=self.block_size,
            kv_quant=self._kv_quant,
            paged_impl=resolve_paged_impl(self.block_size,
                                          self.spec["head_dim"],
                                          device=self.device),
            sampling=self._sampling,
            sample_cap=self.sample_cap if self._sampling else 0,
            numeric_watch=self._numeric_watch, tp=self.tp,
            split=tuple(sorted(self._split.items())))
        # the draft side last: target params, target cache, then the
        # (much smaller) draft
        self._spec = None
        if self.spec_k:
            self._spec = spec_mod.DraftWorker(
                self, draft_params, num_heads=draft_num_heads,
                window=draft_window, symbol=draft_symbol,
                name=draft_name or name, dtype=dtype)
        # -- programs and their warm start (aot/) ----------------------------
        self._programs = {}            # (kind, bucket) -> _Program
        self.captures = 0              # CUDA graphs captured
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        self._capturer = (_CaptureThread(self.device)
                          if self.device.type == "cuda" else None)
        if self._capturer is not None:
            # an engine dropped without shutdown() ends its thread too
            weakref.finalize(self, self._capturer.stop)
        # the export store (None: every program is traced)
        self._aot = (export_store.ExportStore(aot_dir) if aot_dir is not None
                     else export_store.default_store())
        self._spec_digest = aot.digest(self._fingerprint())[:16]
        self._manifest = aot.ManifestRecorder(
            self._spec_digest, os.environ.get(aot.ENV_MANIFEST))
        self._warming = False
        # per-program attribution (analytic cost table, default on;
        # CUDA-event timing of sampled steps behind
        # MXTPU_PERF_ATTRIB_SAMPLE) and the per-step phase decomposition
        # (default on).  Built here, after telemetry.enable() in the
        # usual ordering, because both cache their metric handles; never
        # in the fingerprint: tokens, programs and captures stay as they
        # are in any combination of their knobs
        self._perf = PerfAttrib(device=self.device)
        self._sprof = profiling.make_step_profiler()
        # live-state gauges stamped once per step (no-op objects when
        # telemetry is off); cumulative counters live in StatsRecorder
        self._tel_queue = telemetry.gauge(
            "mxtpu_serve_queue_depth", "requests waiting for admission")
        self._tel_running = telemetry.gauge(
            "mxtpu_serve_running", "requests in the decode batch")
        self._tel_blocks = telemetry.gauge(
            "mxtpu_serve_blocks_in_use", "KV-cache blocks allocated")
        self._tel_block_util = telemetry.gauge(
            "mxtpu_serve_block_utilization", "KV-cache block fraction used")
        self._tel_preempt = telemetry.gauge(
            "mxtpu_serve_preemptions", "scheduler preemptions (lifetime)")
        self._tel_evict = telemetry.gauge(
            "mxtpu_serve_evictions", "retained-block evictions (lifetime)")
        self._tel_rejected = telemetry.gauge(
            "mxtpu_serve_rejected", "rejected requests (lifetime)")
        telemetry.gauge("mxtpu_serve_blocks_total",
                        "allocatable KV-cache blocks").set(
            self.blocks.total_blocks)
        # /statusz shows this engine while it is alive (a weakref: a
        # retired engine drops off the page)
        self._statusz_name = statusz_mod.register_weak(self, "serve.engine")

    def _shard_params(self, partition_rules):
        """Validate ``tp``, build the ``{'tp': tp}`` mesh and place the
        (host) parameters by the partition rules: replicated ones as one
        tensor on the mesh's device, sharded ones as a list of shards,
        each copied alone."""
        visible = mesh_mod.visible_devices(self.device.type)
        if self.tp > len(visible):
            raise ValueError(
                f"tp={self.tp} exceeds the {len(visible)} visible "
                f"{self.device.type} devices (physical devices x "
                f"{mesh_mod.ENV_VIRTUAL})")
        kv = self.spec["kv_heads"]
        if self.num_heads % self.tp or kv % self.tp:
            raise ValueError(
                f"tp={self.tp} must divide num_heads={self.num_heads} and "
                f"kv_heads={kv} (head-sharded attention and KV-cache)")
        if partition_rules is None:
            partition_rules = os.environ.get(
                "MXTPU_SERVE_PARTITION_RULES") or None
        if isinstance(partition_rules, str):
            self._rules = partition_mod.parse_rules(partition_rules)
        elif partition_rules is not None:
            self._rules = list(partition_rules)
        if not self._rules:
            self._rules = partition_mod.gpt_partition_rules(name=self.name,
                                                            axis="tp")
        self._rules_digest = partition_mod.rules_digest(self._rules)
        # the engine's own device first: the mesh holds its shards there
        visible.sort(key=lambda d: d != self.device)
        self.mesh = mesh_mod.make_mesh({"tp": self.tp}, devices=visible)
        shardings = partition_mod.named_shardings(
            self.mesh, partition_mod.match_partition_rules(self._rules,
                                                           self.params))
        placed = {}
        for k, v in self.params.items():
            sh = shardings[k]
            try:
                dim = sh.split_dim(v.dim())
                placed[k] = sh.place(v)
            except ValueError as e:
                raise ValueError(
                    f"partition rule for {k!r} {tuple(v.shape)}: {e}; "
                    "serving executes P(), P('tp'), P('tp', None) and "
                    "P(None, 'tp') on the 'tp' axis") from None
            if dim is not None:
                self._split[k] = dim
        self.params = placed

    def _zeros(self, shape, dtype):
        """A zero cache buffer: one tensor at tp 1, else one a shard."""
        if self.mesh is None:
            return torch.zeros(shape, dtype=dtype, device=self.device)
        return [torch.zeros(shape, dtype=dtype, device=d)
                for d in self.mesh.devices]

    @property
    def paged_impl(self):
        """Decode attention's implementation: "cuda" or "torch"."""
        return self._cfg.paged_impl

    @property
    def cache_dtype(self):
        """The K/V-cache's dtype (None once shut down)."""
        return None if self._cache_k is None else _first(self._cache_k).dtype

    # -- public API ----------------------------------------------------------
    def submit(self, prompt, max_new_tokens=64, deadline_s=None,
               tenant=None, trace_id=None, handoff=False, temperature=None,
               top_p=None, top_k=None, n=1, logprobs=0, adapter_id=None):
        """Queue one generation request; returns its ``Request`` handle.

        Raises ``QueueFull`` when the admission queue is at capacity
        (back-pressure — retry later).  A request that could never fit
        (longer than ``max_model_len`` or the whole cache) is returned
        already REJECTED rather than queued to deadlock.

        ``temperature``/``top_p``/``top_k`` are per-request (None takes
        the engine defaults); a greedy-only engine refuses stochastic
        values and ``logprobs`` with ``ValueError``.  ``n > 1`` serves
        that many samples of the prompt, its blocks shared copy-on-write
        (one prefill pays for all; the handles are on ``req.samples``).
        ``logprobs`` (0..5) records that many top candidates a token
        beside each token's own logprob.

        ``adapter_id`` serves the request through a registered LoRA
        adapter (adapters mode only): each of its rows pins the
        adapter's device slot until its terminal event, and adds the
        adapter's delta in every target projection.  An unknown id
        raises ``ValueError``; every slot pinned rejects the request
        with the retriable ``adapter_slots`` reason."""
        if not self._alive:
            raise RuntimeError("engine is shut down")
        temperature = (self.temperature if temperature is None
                       else _valid_temperature(temperature))
        top_p = self.top_p if top_p is None else _valid_top_p(top_p)
        top_k = self.top_k if top_k is None else _valid_top_k(top_k)
        logprobs = int(logprobs)
        if not 0 <= logprobs <= TOP_LOGPROBS:
            raise ValueError(
                f"logprobs must be in [0, {TOP_LOGPROBS}] "
                f"(got {logprobs})")
        n = int(n)
        if not 1 <= n <= 64:
            raise ValueError(f"n must be in [1, 64] (got {n})")
        if not self._sampling and (temperature > 0.0 or top_p < 1.0
                                   or top_k is not None or logprobs):
            raise ValueError(
                "per-request sampling/logprobs require a sampling-mode "
                "engine (Engine(sampling=True) / MXTPU_SERVE_SAMPLING=1 "
                "or stochastic engine defaults) — greedy-only engines "
                "keep the historical programs byte-for-byte")
        if n > 1 and not self.blocks.prefix_cache:
            raise ValueError(
                "n > 1 requires the prefix cache (siblings share the "
                "prompt's radix-cached blocks copy-on-write — one "
                "prefill, n samples)")
        if adapter_id is not None:
            if not self._adapters:
                raise ValueError(
                    "adapter_id requires an adapters-mode engine "
                    "(Engine(adapters=S) / MXTPU_SERVE_ADAPTERS) — "
                    "adapters-off engines keep the historical programs "
                    "byte-for-byte")
            if (not isinstance(adapter_id, str)
                    or not self.adapter_store.known(adapter_id)):
                raise ValueError(f"unknown adapter: {adapter_id!r}")
        kw = dict(deadline_s=deadline_s, tenant=tenant, handoff=handoff,
                  temperature=temperature, top_p=top_p, top_k=top_k,
                  logprobs=logprobs, adapter_id=adapter_id)
        req = Request(prompt, max_new_tokens, **kw)
        if trace_id:
            req.trace_id = str(trace_id)
        if n > 1:
            sibs = []
            for i in range(1, n):
                sib = Request(prompt, max_new_tokens, **kw)
                sib.group, sib.sample_index = req.rid, i
                if trace_id:
                    sib.trace_id = str(trace_id)
                sibs.append(sib)
            req.group, req.sample_index = req.rid, 0
            req.samples = [req] + sibs
        if req.target_len() > self.max_model_len:
            for r in (req.samples or [req]):
                self.scheduler._reject(r, "exceeds_max_len")
            return req
        if adapter_id is not None:
            # every row pins the slot once; the pin survives preemption
            # and drops in _on_request_terminal.  All slots pinned is
            # transient capacity pressure: a retriable rejection
            try:
                for r in (req.samples or [req]):
                    r.adapter_slot = self.adapter_store.acquire(adapter_id)
            except adapters_mod.NoAdapterSlots:
                for r in (req.samples or [req]):
                    self.scheduler._reject(r, "adapter_slots")
                return req
        try:
            out = self.scheduler.submit(req)
        except QueueFull:
            self._stats.on_reject()      # back-pressure event counter
            for sib in (req.samples or [req])[1:]:
                # each sibling is one more back-pressure event
                self.scheduler._reject(sib, "queue_full")
                self._stats.on_reject()
            raise
        if req.samples:
            if req.status == REJECTED:
                for sib in req.samples[1:]:
                    self.scheduler._reject(sib, req.reject_reason
                                           or "rejected")
            else:
                # siblings wait engine-side until the primary's prefill
                # publishes the prompt's blocks: only then does their
                # radix walk share the whole block-aligned prefix
                with self._fanout_lock:
                    self._pending_fanout.append((req,
                                                 list(req.samples[1:])))
        return out

    def _has_pending_fanout(self):
        with self._fanout_lock:
            return bool(self._pending_fanout)

    def _release_fanout(self):
        """Move n > 1 siblings into the scheduler once their primary's
        prefill has published the prompt's blocks: each sibling's radix
        walk then shares the block-aligned prefix copy-on-write (its
        final span recomputes into a private block)."""
        with self._fanout_lock:
            if not self._pending_fanout:
                return
            pending, self._pending_fanout = self._pending_fanout, []
        keep = []
        for primary, sibs in pending:
            if not primary.tokens and not primary.done:
                keep.append((primary, sibs))
                continue
            rest = []
            for i, sib in enumerate(sibs):
                if self.scheduler.queue_depth >= self.scheduler.max_queue:
                    rest = sibs[i:]      # queue full: retry next step
                    break
                try:
                    self.scheduler.submit(sib)
                except QueueFull:
                    # raced another thread into the last queue slot
                    sib.status = REJECTED
                    sib.reject_reason = "queue_full"
                    sib.finish_t = self.clock()
                    self._stats.on_reject()
            if rest:
                keep.append((primary, rest))
        if keep:
            with self._fanout_lock:
                self._pending_fanout = keep + self._pending_fanout

    def step(self):
        """One scheduler iteration: admit + prefill, then one batched
        decode.  Returns the number of tokens emitted.

        An unhandled exception dumps the flight-recorder ring to
        ``MXTPU_FLIGHT_DIR`` before propagating."""
        if not self._alive:
            # a caller error, not an engine failure: no post-mortem
            raise RuntimeError("engine is shut down")
        try:
            with torch.no_grad():
                return self._step_inner()
        except Exception:
            rec = flight_mod.recorder()
            rec.record("error", site="engine.step",
                       error=traceback.format_exc(limit=4))
            # the digest identifies which programs were live
            rec.dump("engine_exception", force=True,
                     extra={"traceback": traceback.format_exc(limit=30),
                            "spec_digest": self._spec_digest,
                            "tp": self.tp,
                            "sharding_rules_digest": self._rules_digest})
            raise

    def _step_inner(self):
        self._step_id += 1
        # arm (or not) this step's call timing: with sampling off (the
        # default) every t0() below is None and no call gains a sync
        self._perf.arm(self._step_id)
        # begin/lap/commit bracket the whole iteration; the laps inside
        # _run_prefill/_run_decode/_run_spec_decode split staging and
        # launch, the wait for the outputs and host bookkeeping
        sprof = self._sprof
        sprof.begin(self._step_id)
        with telemetry.span("serve.step"):
            self._release_fanout()
            prefills, decodes = self.scheduler.schedule()
            if self._host_pool is not None:
                # host-tier hits this schedule() allocated queued their
                # restores: run them before any program reads the blocks
                self._restore_pending()
            # blocks for this iteration are all held right now — the
            # honest high-water sample
            self._stats.on_utilization(self.blocks.utilization())
            sprof.lap("schedule")
            emitted = 0
            for req in prefills:
                with telemetry.span("serve.prefill", rid=req.rid):
                    # the iteration's prefill token budget is shared
                    # with the decode slots: up to 1 + spec_k tokens each
                    emitted += self._run_prefill(
                        req, decode_slots=len(decodes) * (1 + self.spec_k))
            if decodes:
                with telemetry.span("serve.decode", batch=len(decodes)):
                    if self._spec is not None:
                        emitted += self._run_spec_decode(decodes)
                    else:
                        emitted += self._run_decode(decodes)
            if prefills or decodes:
                # scheduler decisions ride the flight ring (bounded,
                # always on); with the host tier on, its occupancy too
                step_fields = dict(
                    id=self._step_id, prefills=len(prefills),
                    decodes=len(decodes),
                    queue=self.scheduler.queue_depth,
                    blocks_in_use=self.blocks.blocks_in_use)
                if self._host_pool is not None:
                    step_fields["host_kv_entries"] = len(self._host_pool)
                    step_fields["host_kv_bytes"] = \
                        self._host_pool.bytes_used
                flight_mod.recorder().record("step", **step_fields)
            if emitted == 0 and not prefills and not decodes:
                self._noop_steps += 1
                if self._noop_steps > 1000 and self.scheduler.has_work():
                    raise RuntimeError(
                        "scheduler stalled: work queued but 1000 consecutive "
                        "steps scheduled nothing (cache/queue misconfigured?)")
            else:
                self._noop_steps = 0
            self._stats.on_step(emitted, decode_batch=len(decodes))
            self._perf.on_step(emitted)
            if self._spec is not None:
                # bound the draft ledger by the running set: a request
                # that left between decodes never reached forget()
                self._spec.prune({r.rid for r in self.scheduler.running})
            self._tel_queue.set(self.scheduler.queue_depth)
            self._tel_running.set(len(self.scheduler.running))
            self._tel_blocks.set(self.blocks.blocks_in_use)
            self._tel_block_util.set(self.blocks.utilization())
            self._tel_preempt.set(self.scheduler.preemptions)
            self._tel_evict.set(self.blocks.evictions)
            self._tel_rejected.set(self.scheduler.rejections)
        sprof.commit(emitted, prefills=len(prefills), decodes=len(decodes))
        return emitted

    def has_work(self):
        """Whether ``step()`` still has anything to do: the scheduler's
        queues and batches, or n > 1 siblings awaiting release."""
        return self.scheduler.has_work() or self._has_pending_fanout()

    def run(self):
        """Pump ``step()`` until every queued request resolves."""
        while self.has_work():
            self.step()

    def stream(self, req):
        """Yield ``req``'s tokens as they are generated, pumping the
        engine as needed (every co-scheduled request advances too)."""
        sent = 0
        while True:
            while sent < len(req.tokens):
                yield int(req.tokens[sent])
                sent += 1
            if req.done or not self.has_work():
                return
            self.step()

    def stats(self):
        """Immutable ``ServeStats`` snapshot of the engine right now."""
        return self._stats.snapshot(self.scheduler, self.blocks)

    def shutdown(self):
        """Cancel in-flight work and release the programs (their graphs
        first), then the device cache and weights."""
        if not self._alive:
            return
        for req in (list(self.scheduler.running)
                    + list(self.scheduler.prefilling)):
            self.scheduler.finish(req, status=CANCELLED)
        for req in self.scheduler.drain_waiting():
            req.status = CANCELLED
            req.finish_t = self.clock()
            self._rtrace.terminal(req, CANCELLED)
        with self._fanout_lock:
            pending, self._pending_fanout = self._pending_fanout, []
        for _, sibs in pending:
            # n > 1 siblings still engine-side resolve like drained
            # waiters
            for sib in sibs:
                sib.status = CANCELLED
                sib.finish_t = self.clock()
                self._rtrace.terminal(sib, CANCELLED)
        self._rtrace.close()
        statusz_mod.unregister(self._statusz_name)
        self._programs.clear()
        self._pool = None
        if self._capturer is not None:
            self._capturer.stop()
        if self._spec is not None:
            self._spec.shutdown()
        for bufs in (self._cache_k, self._cache_v, self._scale_k,
                     self._scale_v):
            if isinstance(bufs, list):
                bufs.clear()       # every shard, whoever still holds the list
        self._cache_k = self._cache_v = None
        self._scale_k = self._scale_v = None
        if self._host_pool is not None:
            # the host tier goes with the device buffers
            self._host_pool.clear()
            self._host_pool = None
        self.params = None
        self._alive = False

    # -- SLO breach detection (flight-recorder triggers) ---------------------
    def _on_request_terminal(self, req, name, args):
        """Runs on every request's terminal trace event: drops the
        request's adapter pin (once: its slot is zeroed), dumps the
        flight ring on a deadline miss (rate-limited), and dumps when the
        rejection rate over the recent-terminal window reaches
        ``MXTPU_FLIGHT_REJECT_RATE``."""
        if req.adapter_slot and self.adapter_store is not None:
            self.adapter_store.release(req.adapter_slot)
            req.adapter_slot = 0
        rejected = name == "rejected"
        self._slo_window.append(1 if rejected else 0)
        if rejected and args.get("reason") == "deadline":
            flight_mod.recorder().dump(
                "deadline_miss", extra={"rid": req.rid,
                                        "deadline_s": req.deadline_s})
        thr = self._reject_rate_thr
        if thr and len(self._slo_window) >= 20:
            rate = sum(self._slo_window) / len(self._slo_window)
            if rate >= thr:
                flight_mod.recorder().dump(
                    "rejection_rate",
                    extra={"rate": round(rate, 4), "threshold": thr,
                           "window": len(self._slo_window)})

    # -- live introspection (/statusz provider) ------------------------------
    def statusz(self):
        """Live engine state for ``/statusz``: in-flight requests with
        ages and phases, queue and cache occupancy, program, perf and
        step-profile state — the reference's sections.  Host reads only
        (tensor metadata, host counters): it runs on the HTTP thread,
        possibly while the step thread captures a CUDA graph."""
        now = self.clock()
        aot_info = {"dir": getattr(self._aot, "dir", None)}
        if self._aot is not None:
            entries = self._aot.entries()
            aot_info.update(artifacts=len(entries),
                            bytes=sum(b for _, b in entries))
        reqs = []
        mid_prefill = {id(r) for r in self.scheduler.prefilling}
        for req in (list(self.scheduler.running)
                    + list(self.scheduler.prefilling)
                    + list(self.scheduler.waiting)):
            if req.status == WAITING:
                phase = "queued" if req.n_preemptions == 0 else "preempted"
            elif id(req) in mid_prefill or not req.tokens:
                phase = "prefill"
            else:
                phase = "decode"
            reqs.append({
                "rid": req.rid, "trace_id": req.trace_id,
                "tenant": req.tenant, "status": req.status, "phase": phase,
                "age_s": (round(now - req.submit_t, 3)
                          if req.submit_t is not None else None),
                "prompt_tokens": int(req.prompt.size),
                "generated": len(req.tokens),
                "target": req.target_len(),
                "cached_tokens": req.cached_prefix_len,
                "host_tokens": req.host_restored_len,
                "prefill_done": int(req.cache_len),
                "prefill_target": req.prefill_target,
                "n_preemptions": req.n_preemptions})
        return {
            "alive": self._alive,
            "steps": self._step_id,
            "queue_depth": self.scheduler.queue_depth,
            "running": len(self.scheduler.running),
            "in_flight": reqs,
            "completed": self._stats.completed,
            "preemptions": self.scheduler.preemptions,
            "reject_reasons": dict(self.scheduler.reject_reasons),
            "tenants": self.scheduler.tenant_stats(),
            "kv_blocks": self.blocks.occupancy(),
            "prefix_cache": self.blocks.prefix_stats(),
            "kv_cache": self.kv_cache_stats(),
            "host_kv": self.host_kv_stats(),
            "quant": self.quant_info(),
            "sampling": self.sampling_info(),
            "adapters": self.adapter_info(),
            "sharding": self.sharding_info(),
            # a shut-down engine's draft is released (the reference
            # drops it, and reads None here)
            "spec": (None if self._spec is None or not self._alive
                     else self._spec.statusz(self)),
            "perf": self._perf.statusz(),
            "step_profile": self._sprof.statusz(),
            "max_batch": self.max_batch,
            "max_model_len": self.max_model_len,
            "programs_recorded": len(self._manifest.entries()),
            "request_trace": {"enabled": self._rtrace.enabled,
                              "sample": self._rtrace.sample,
                              "traced": self._rtrace.traced,
                              "written": self._rtrace.written,
                              "path": self._rtrace.path},
            "numeric_watch": self._numeric_watch,
            "aot": aot_info,
        }

    def perf_summary(self):
        """Compact performance-attribution summary — sampled call count,
        MFU/achieved-TFLOP/s, flops a token and device cost per 1k
        tokens (None with ``MXTPU_PERF_ATTRIB=0``)."""
        return self._perf.summary()

    def adapter_info(self):
        """The ``/statusz`` ``adapters`` section: slot occupancy,
        refcounts and loaded ids (None when off)."""
        if not self._adapters:
            return None
        return self.adapter_store.stats()

    def quant_info(self):
        """The ``/statusz`` ``quant`` section: weight-only mode, K/V
        dtype and their bytes (None when both are off)."""
        if not self.quantize and not self._kv_quant:
            return None
        info = {"weights": self.quantize,
                "kv_dtype": (dtype_name(_first(self._cache_k))
                             if self._cache_k is not None else None)}
        if self.quantize and self.params:
            info["quantized_weights"] = sum(
                1 for k in self.params if k.endswith("_wscale"))
            info["weight_bytes"] = sum(
                _nbytes(v) for k, v in self.params.items()
                if k.endswith("_weight") or k.endswith("_wscale"))
        if self._kv_quant and self._scale_k is not None:
            info["kv_scale_bytes"] = 2 * _nbytes(self._scale_k)
        return info

    def sharding_info(self):
        """The ``/statusz`` ``sharding`` section: tp degree, rules and
        program digests, the mesh's axes and devices (at tp > 1), and
        the parameters' bytes by device (a replicated tensor counts once
        a mesh device, its real footprint there; at tp > 1 keyed by the
        mesh's device ids)."""
        info = {"tp": self.tp, "rules_digest": self._rules_digest,
                "spec_digest": self._spec_digest}
        if self.mesh is not None:
            info["mesh"] = {
                "axes": dict(self.mesh.shape),
                "devices": list(self.mesh.device_ids),
                "device_names": [str(d) for d in self.mesh.devices]}
        if self.params:
            if self.mesh is None:
                info["params_bytes_per_device"] = \
                    statusz_mod.bytes_by_device(self.params.values())
            else:
                info["params_bytes_per_device"] = {
                    i: sum(int(_shard(v, s).nbytes)
                           for v in self.params.values())
                    for s, i in enumerate(self.mesh.device_ids)}
        return info

    def kv_cache_stats(self):
        """K/V-cache bytes, in total and a device: each device holds
        ``kv_heads/tp`` of every block, so the bytes a device (total and
        in use) drop by tp while the block accounting stays."""
        if self._cache_k is None:
            return None
        total = 2 * _nbytes(self._cache_k)              # K and V
        per_dev = total // self.tp
        per_block = per_dev // self.num_blocks
        out = {"bytes_total": total,
               "bytes_per_device": per_dev,
               "bytes_per_block_per_device": per_block,
               "bytes_in_use_per_device":
                   per_block * self.blocks.blocks_in_use,
               "dtype": dtype_name(_first(self._cache_k))}
        if self._kv_quant:
            sb = 2 * _nbytes(self._scale_k)
            out["scale_bytes_total"] = sb
            out["scale_bytes_per_device"] = sb // self.tp
        return out

    def sampling_info(self):
        """The sampling section of the reference's ``/statusz``: cap,
        engine defaults (None on greedy-only engines)."""
        if not self._sampling:
            return None
        return {"enabled": True, "sample_cap": self.sample_cap,
                "top_logprobs": TOP_LOGPROBS,
                "defaults": {"temperature": self.temperature,
                             "top_p": self.top_p, "top_k": self.top_k}}

    def host_block_spec(self):
        """Shapes and dtype names of ONE block's host copies, the layout
        ``_host_kv_fetch`` produces and the restore program takes: K and
        V ``(layers, block_size, kv_heads, head_dim)`` in the cache
        dtype, plus the two float32 scale arrays under int8 K/V (the
        reference's names: ``"bfloat16"``, ``"float32"``, ``"int8"``)."""
        L, bs = self._cfg.n_layers, self.block_size
        Hkv, Dh = self._cfg.kv_heads, self._cfg.head_dim
        dt = dtype_name(_first(self._cache_k))
        specs = [((L, bs, Hkv, Dh), dt), ((L, bs, Hkv, Dh), dt)]
        if self._kv_quant:
            specs += [((L, bs, Hkv), "float32"), ((L, bs, Hkv), "float32")]
        return specs

    def host_kv_stats(self):
        """The host tier's budget, occupancy and counters, plus the host
        bytes one parked block costs (None with the tier off)."""
        if self._host_pool is None:
            return None
        out = self._host_pool.stats()
        per_block = 2 * (_nbytes(self._cache_k) // self.num_blocks
                         if self._cache_k is not None else 0)
        if self._kv_quant and self._scale_k is not None:
            per_block += 2 * (_nbytes(self._scale_k) // self.num_blocks)
        out["block_bytes"] = int(per_block)
        return out

    def kv_summary(self):
        """The routable-cache advertisement: the BlockManager's
        ``RadixSummary`` snapshot (None with the prefix cache off),
        bounded in size and kept incrementally, so a fleet replica
        publishes it on every ``/healthz`` and ``/statusz`` scrape."""
        return self.blocks.summary()

    def ingest_pulled_blocks(self, records, salt=None):
        """Park a peer's handoff records in the host tier (the
        chain-hash-verified ``import_blocks``): the next radix hit
        restores them.  Returns ``(imported, deduped, rejected)``."""
        return self.blocks.import_blocks(records, salt=salt)

    # -- warmup / manifests (aot/) -------------------------------------------
    def manifest(self):
        """The (kind, bucket) programs this engine has executed so far
        — the traffic-replay warmup manifest (list of entry dicts)."""
        return self._manifest.entries()

    def save_manifest(self, path):
        """Write the manifest as JSONL for a later ``warmup(path)``."""
        with open(path, "w") as f:
            for e in self._manifest.entries():
                f.write(json.dumps(e) + "\n")
        return path

    def warmup(self, manifest=None):
        """Build (on CUDA: warm and capture) every program ``manifest``
        lists, before traffic arrives.

        ``manifest`` is a JSONL path, an iterable of entry dicts
        (another engine's :meth:`manifest`), or None, which replays
        ``MXTPU_WARMUP_MANIFEST`` when set, else warms the full bucket
        grid.  Entries recorded by an incompatibly-configured engine
        (or another torch or card), outside this engine's bucket range,
        or of a kind it does not run, are skipped.  Warmup never records
        the manifest.  Returns the number of programs made ready.
        """
        if not self._alive:
            raise RuntimeError("engine is shut down")
        entries = aot.load_manifest(manifest, self._spec_digest)
        if not entries and manifest is None:
            entries = self._warmup_grid()
        elif self._host_pool is not None:
            # the tier changes no program and no fingerprint, so a
            # tier-off engine's manifest replays here, but it lists no
            # restore program: add the ladder, or the first host hit
            # would capture in traffic
            entries = list(entries) + [
                {"kind": "restore", "bucket": b}
                for b in _bucket_ladder(self.table_width)]
        caps = self._caps()
        ready = 0
        self._warming = True
        try:
            with telemetry.span("serve.warmup", programs=len(entries)):
                for e in entries:
                    kind, bucket = e["kind"], int(e["bucket"])
                    cap = caps.get(kind)
                    if cap is None or not 1 <= bucket <= cap:
                        continue
                    self._program(kind, _next_bucket(bucket, cap))
                    ready += 1
        finally:
            self._warming = False
        return ready

    def _warmup_grid(self):
        """Every program this config can ever run: decode, prefill and
        chunk (prefix-cache suffixes and chunked long prompts), plus
        verify, draft and draft_chunk with speculative decoding on, and
        restore with the host tier on, over their bucket ladders, each
        non-power-of-two cap included."""
        return [{"kind": kind, "bucket": b}
                for kind, cap in self._caps().items()
                for b in _bucket_ladder(cap)]

    def _caps(self):
        """Each program family's largest bucket."""
        caps = {"decode": self.max_batch, "prefill": self.max_model_len,
                "chunk": self._chunk_cap()}
        if self._spec is not None:
            caps.update(verify=self.max_batch, draft=self.max_batch,
                        draft_chunk=self.max_model_len)
        if self._host_pool is not None:
            caps["restore"] = self.table_width
        return caps

    def verify_buckets(self):
        """The verify family's bucket grid (empty with spec off)."""
        if self._spec is None:
            return []
        return _bucket_ladder(self.max_batch)

    def _chunk_cap(self):
        """Largest chunk-program bucket live traffic can hit.  With
        chunking on, a non-chunked suffix is <= prefill_chunk by the
        scheduler's lane test and a chunk is <= the budget; with
        chunking off only prefix-hit suffixes use the chunk program,
        and those can reach the full model length."""
        chunk = self.scheduler.prefill_chunk
        if chunk > 0:
            return _next_bucket(chunk, self.max_model_len)
        return self.max_model_len

    # -- programs ------------------------------------------------------------
    def _fingerprint(self):
        """The program key (the reference's ``_spec_key``): what pins the
        programs' math and lowering (``_ModelCfg``, ``paged_impl``
        included), their shapes (``num_blocks``, ``table_width``) and the
        cache dtype, plus the torch version and card.  Speculative
        decoding (``spec_k`` and the draft's cfg and cache dtype),
        ``kv_quant``, ``quantize``, ``sampling``, ``sample_cap``,
        ``adapters`` and ``adapter_rank`` enter only when on, so an
        engine without them keeps its digest and manifests.  The host
        tier never enters: it changes no program (its restore programs
        are a kind of their own).  The tp degree, mesh shape and rules
        digest enter at tp > 1 only."""
        extra = {}
        if self._spec is not None:
            extra.update(spec_k=self.spec_k, draft=dict(
                _cfg_fields(self._spec.cfg),
                cache_dtype=str(self._spec.cache_k.dtype)))
        if self.quantize:
            extra["quantize"] = self.quantize
        if self._adapters:
            extra.update(adapters=self._adapters,
                         adapter_rank=self.adapter_rank)
        if self.tp > 1:
            # the sharding layout enters only at tp > 1: a tp 1 engine
            # keeps its digest, manifests and artifacts
            extra.update(tp=self.tp, mesh_shape=dict(self.mesh.shape),
                         partition_rules=self._rules_digest)
        return aot.fingerprint(device=self.device,
                               cfg=_cfg_fields(self._cfg),
                               num_blocks=self.num_blocks,
                               table_width=self.table_width,
                               cache_dtype=str(self.cache_dtype),
                               **extra)

    def _program(self, kind, bucket):
        prog = self._programs.get((kind, bucket))
        if prog is None:
            prog = self._resolve_program(kind, bucket)
            self._programs[(kind, bucket)] = prog
            self.captures += prog.captured
            if prog.captured:
                cudamon.note_capture(kind)
        if not self._warming:
            self._manifest.record(kind, bucket)
        if self._perf.enabled and self._perf.cost(kind, bucket) is None:
            # the cost table fills HERE, the one point every program
            # passes (built now, warmed earlier, or replayed): a warmed
            # engine never reports an empty perf section.  After the
            # first note, one dict probe a call
            af, ab = self._analytic_cost(kind, bucket)
            self._perf.note_cost(kind, bucket, flops=af, bytes_accessed=ab)
        return prog

    def _analytic_cost(self, kind, bucket):
        """Analytic (flops, bytes) of one (kind, bucket) call, from the
        GQA-aware closed forms in ``flops.py`` over the PADDED program
        shapes (bucket rows, table-capacity context): the reference's
        ``_analytic_cost``, the same numbers for the same config."""
        from .. import flops as flops_mod

        if kind in ("draft", "draft_chunk") and self._spec is not None:
            cfg, params = self._spec.cfg, self._spec.params
        else:
            cfg, params = self._cfg, self.params
        try:
            tok_w = _full_shape(cfg, params, f"{cfg.name}_tok_embed_weight")
            ffw = (_full_shape(cfg, params, f"{cfg.name}_l0_ff_up_weight")
                   if f"{cfg.name}_l0_ff_up_weight" in params else None)
            kw = dict(n_layers=cfg.n_layers,
                      d_model=int(tok_w[1]),
                      num_heads=cfg.num_heads, head_dim=cfg.head_dim,
                      kv_heads=cfg.kv_heads, vocab=int(tok_w[0]),
                      d_ff=int(ffw[0]) if ffw is not None else None,
                      swiglu=cfg.swiglu)
        except (KeyError, TypeError):
            return None, None          # params already freed (shutdown)
        ctx = self.table_width * self.block_size
        per_tok = flops_mod.gpt_token_flops(context=ctx, **kw)
        if kind == "prefill":
            return flops_mod.gpt_prefill_flops(seq_len=bucket, **kw), None
        if kind in ("chunk", "draft_chunk"):
            return bucket * per_tok, None
        if kind == "verify":
            return bucket * (self.spec_k + 1) * per_tok, None
        if kind == "draft":
            return bucket * self.spec_k * per_tok, None
        if kind == "restore":
            # a pure copy: no matmuls; bytes are the K+V block payload
            # in and out (the MBU numerator)
            L, bs = self._cfg.n_layers, self.block_size
            Hkv, Dh = self._cfg.kv_heads, self._cfg.head_dim
            payload = (2 * L * bucket * bs * Hkv * Dh
                       * _first(self._cache_k).element_size())
            return None, 2 * payload
        return bucket * per_tok, None      # decode

    def _aot_fp(self, kind, bucket):
        """The export store's fingerprint of one (kind, bucket) program:
        the engine's program key, with the store's format, and the CUDA
        device's index (an exported graph names its device)."""
        key = {k: v for k, v in self._fingerprint().items()
               if k not in ("format", "torch_version", "device")}
        if self.device.type == "cuda":
            key["device_index"] = self.device.index
        return export_store.fingerprint(device=self.device,
                                        subsystem="serve", kind=kind,
                                        bucket=int(bucket), **key)

    def _resolve_program(self, kind, bucket):
        """One (kind, bucket) program: its body traced from the Python
        (and, with the export store on, exported and saved for the next
        start), or loaded from the store.  ``mxtpu_aot_programs_total
        {kind,source}`` counts which: ``source="trace"`` is exactly a
        build the warm start is meant to avoid.  With the store on, the
        cold and the warm engine both run an exported program's module
        (on CUDA captured as a graph), never the body itself; a body that
        cannot be exported runs as traced, counted as an ``export``
        error."""
        fields, body, state = self._program_parts(kind, bucket)
        source, module = "trace", None
        if self._aot is not None:
            fp = self._aot_fp(kind, bucket)
            label = f"serve-{kind}{bucket}"
            exported = self._aot.load(fp, label=label)
            if exported is not None:
                module = exported.module()
                if export_store.cache_copies(module, _cache_numel(state)):
                    # a program that copies its caches would not write
                    # this engine's: stale, traced afresh
                    telemetry.counter(
                        "mxtpu_aot_errors_total", "AOT artifact failures",
                        ("kind",)).labels(kind="inplace").inc()
                    module = None
                else:
                    source = "artifact"
            if module is None:
                try:
                    exported = self._export(fields, body, state)
                except Exception:
                    # a body torch.export cannot take runs as traced,
                    # counted: a fleet serving unexportable programs has
                    # lost its warm start (the reference's rule)
                    telemetry.counter(
                        "mxtpu_aot_errors_total", "AOT artifact failures",
                        ("kind",)).labels(kind="export").inc()
                else:
                    self._aot.save(fp, exported, label=label)
                    module = exported.module()
        if module is not None:
            body = functools.partial(_call_exported, module, state)
        else:
            body = functools.partial(body, **state)
        telemetry.counter(
            "mxtpu_aot_programs_total", "bucket-program resolutions",
            ("kind", "source")).labels(kind=kind, source=source).inc()
        return _Program(fields, body, self.device, self._pool,
                        self._capturer)

    def _export(self, fields, body, state):
        """``torch.export`` of ``body`` over its inputs (zeros of the
        fields' shapes) and ``state`` (parameters, caches, scales and
        adapter stacks, as inputs: the program holds no weights, and its
        example inputs are dropped).  The default export IR keeps the
        caches' in-place writes; it is never decomposed (that would
        functionalize them)."""
        example = {}
        for f in fields:
            dt = f[2] if len(f) > 2 else torch.int32
            example[f[0]] = torch.zeros(f[1], dtype=dt, device=self.device)
        with torch.no_grad():
            exported = torch.export.export(_Exportable(body),
                                           (example, state), strict=False)
        # the program keeps its example inputs, which are this engine's
        # parameters and caches: dropped, so that neither the artifact
        # nor the program holds them
        exported.example_inputs = None
        return exported

    def _program_parts(self, kind, bucket):
        """``(fields, body, state)`` of one (kind, bucket) program: its
        inputs' ``(name, shape[, dtype])``, the body over its static
        arguments, and the tensors it also takes (``params``, caches
        ``ck``/``cv``, int8 scales ``ksc``/``vsc``, adapter stacks
        ``adp``), by keyword."""
        W = self.table_width
        k = self.spec_k
        f32 = torch.float32
        batch = (("toks", (bucket,)), ("pos", (bucket,)),
                 ("tables", (bucket, W)))
        chunk = (("toks", (bucket,)), ("start", (1,)), ("n_valid", (1,)),
                 ("table", (W,)), ("blk", (bucket,)), ("off", (bucket,)))
        # sampling mode: per-row temperature, top-p, top-k and the
        # call's seed, inputs like any other (never a capture key)
        rows = 1 if kind in ("prefill", "chunk") else bucket
        samp = ((("temp", (rows,), f32), ("topp", (rows,), f32),
                 ("topk", (rows,)), ("seed", (1,)))
                if self._sampling else ())
        if kind == "decode":
            fields, body = batch + samp, functools.partial(_decode,
                                                           self._cfg)
        elif kind == "prefill":
            fields = (("toks", (bucket,)), ("plen", (1,)),
                      ("blk", (bucket,)), ("off", (bucket,))) + samp
            body = functools.partial(_prefill, self._cfg, bucket)
        elif kind == "chunk":
            fields = chunk + samp
            body = functools.partial(_chunk, self._cfg, bucket)
        elif kind == "restore":
            return self._restore_parts(bucket)
        elif kind == "verify":
            if self._sampling:
                # the draft's candidate-space q, staged like every input
                cap = _cap(self._cfg, self.spec["vocab"])
                fields = (("toks", (bucket,)), ("drafted", (bucket, k)),
                          ("q_at", (bucket, k), f32),
                          ("q_vals", (bucket, k, cap), f32),
                          ("q_idx", (bucket, k, cap)),
                          ("pos0", (bucket,)), ("tables", (bucket, W))) \
                    + samp
                body = functools.partial(spec_mod._verify_rs, self._cfg, k)
            else:
                fields = (("rows", (bucket, k + 1)), ("pos0", (bucket,)),
                          ("tables", (bucket, W)))
                body = functools.partial(spec_mod._verify, self._cfg, k)
        else:
            # the draft's programs: its cfg, params and (floating-point)
            # caches
            sw = self._spec
            if kind == "draft":
                fields = batch + samp
                if self._sampling:
                    # proposals sampled from the draft's warped q, with
                    # the target's candidate width
                    body = functools.partial(
                        spec_mod._draft_rs, sw.cfg, k,
                        _cap(self._cfg, self.spec["vocab"]))
                else:
                    body = functools.partial(spec_mod._draft, sw.cfg, k)
            else:
                fields = chunk
                body = functools.partial(_chunk, sw.cfg, bucket)
            return fields, body, {"params": sw.params, "ck": sw.cache_k,
                                  "cv": sw.cache_v}
        state = {"params": self.params, "ck": self._cache_k,
                 "cv": self._cache_v}
        if self._kv_quant:
            state.update(ksc=self._scale_k, vsc=self._scale_v)
        if self._adapters:
            # the target programs' slot inputs and the store's stacks
            # (the draft's programs above stay base-model)
            state["adp"] = self.adapter_store.device
            fields = tuple(fields) + (
                (("slot", (1,)),) if kind in ("prefill", "chunk")
                else (("slots", (bucket,)),))
        return fields, body, state

    def _restore_parts(self, bucket):
        """The ``restore`` program at ``bucket`` blocks: the block ids
        (int32) and the parked K/V ``(L, R, bs, Hkv, Dh)`` in the cache
        dtype, plus ``(L, R, bs, Hkv)`` float32 scales under int8 K/V,
        each dtype staged by one pinned copy; the body scatters them into
        the cache (under tp, each shard's heads into its shard)."""
        L, bs = self._cfg.n_layers, self.block_size
        Hkv, Dh = self._cfg.kv_heads, self._cfg.head_dim
        dt = self.cache_dtype
        fields = [("blks", (bucket,)), ("hk", (L, bucket, bs, Hkv, Dh), dt),
                  ("hv", (L, bucket, bs, Hkv, Dh), dt)]
        state = {"ck": self._cache_k, "cv": self._cache_v}
        if self._kv_quant:
            fields += [("hks", (L, bucket, bs, Hkv), torch.float32),
                       ("hvs", (L, bucket, bs, Hkv), torch.float32)]
            state.update(ksc=self._scale_k, vsc=self._scale_v)
        return fields, _restore, state

    # -- execution -----------------------------------------------------------
    def _next_seed(self):
        """One int32 seed input for a sampling program call."""
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self._gen))

    def _stage_sampling(self, h, reqs):
        """Stage the per-row sampling inputs of ``reqs`` (rows past them
        are padding: greedy, their outputs dropped) and a fresh seed.
        No-op on greedy-only engines."""
        if not self._sampling:
            return
        h["topp"][:] = 1.0
        for i, req in enumerate(reqs):
            h["temp"][i] = req.temperature
            h["topp"][i] = req.top_p
            h["topk"][i] = req.top_k or 0
        h["seed"][0] = self._next_seed()

    def _stage_slots(self, h, reqs):
        """Stage each row's adapter slot into a decode or verify
        program (padding rows stay 0, the base model's zero delta).
        No-op with adapters off."""
        if self._adapters:
            for i, req in enumerate(reqs):
                h["slots"][i] = req.adapter_slot

    def _note_logprobs(self, req, chosen, tv, ti):
        """Record emitted tokens' logprobs on the request: the chosen
        token's always (sampling mode), the top view trimmed to the
        request's ``logprobs``."""
        for j in range(len(chosen)):
            req.token_logprobs.append(float(chosen[j]))
            if req.logprobs:
                req.top_logprobs.append(
                    [[int(t), float(v)]
                     for t, v in zip(ti[j][:req.logprobs],
                                     tv[j][:req.logprobs])])

    def _host_kv_fetch(self, blk):
        """Device->host copy of ONE block's K/V (and int8 scales) for
        the host tier, as CPU tensors (pageable).  The BlockManager calls
        it under its lock, from ``allocate`` inside ``schedule()``, just
        before the device block is reused; ``.cpu()`` returns only once
        the bytes are on the host, and it is ordered on the stream after
        every program already launched.  No graph is in flight there:
        every program call but ``restore`` waits for its output, and a
        restore's scatter precedes this copy on the stream."""
        if self._cache_k is None:
            return None
        bufs = [self._cache_k, self._cache_v]
        if self._kv_quant:
            bufs += [self._scale_k, self._scale_v]
        # under tp each shard's head slice, gathered into one full block
        # on the head axis (3 of (L, bs, Hkv[, Dh]))
        parts = [torch.cat([t[:, blk] for t in b], dim=2)
                 if isinstance(b, list) else b[:, blk] for b in bufs]
        # a copy on the CPU too, where .cpu() would alias the cache
        return tuple(a.to("cpu", copy=True) for a in parts)

    def _restore_pending(self):
        """Run the queued host->device restores, ``table_width`` blocks
        a ``restore`` call at most (bucketed), before this step's first
        program reads the blocks.  The call does not wait for the
        device: the stream orders the scatter before the next program,
        and the program's staging event keeps its pinned buffer until
        the copy has read it."""
        pending = self.blocks.take_pending_restores()
        cap = self.table_width
        while pending:
            batch, pending = pending[:cap], pending[cap:]
            bucket = _next_bucket(len(batch), cap)
            prog = self._program("restore", bucket)
            h = prog.stage()
            for i, (blk, arrays) in enumerate(batch):
                h["blks"][i] = blk
                for name, a in zip(("hk", "hv", "hks", "hvs"), arrays):
                    # a numpy view becomes a tensor on the same memory
                    torch.as_tensor(h[name][:, i]).copy_(a)
            with telemetry.span("serve.host_kv_restore", blocks=len(batch)):
                t0 = self._perf.t0()
                prog(t0)               # no output: nothing waits
                self._perf.done(t0, "restore", bucket)

    def _run_prefill(self, req, decode_slots=0):
        """Run one prefill pass for ``req``: the whole prompt (cold
        path; after a preemption, everything generated so far too), the
        uncached suffix of a prefix-cache hit, or — when the scheduler
        put it in the chunked-prefill lane — ONE budget-sized chunk.
        Returns the tokens emitted (1 on the pass that produces the
        next token, 0 for an intermediate chunk)."""
        ids = req.prefill_ids()
        n = int(ids.size)
        start = int(req.cache_len)     # cached prefix + finished chunks
        resume = req.n_preemptions > 0
        chunked = self.scheduler.is_prefilling(req)
        if chunked:
            budget = max(1, self.scheduler.prefill_chunk - decode_slots)
            end = min(n, start + budget)
        else:
            end = n
        if not req._prefill_started:
            req._prefill_started = True
            self._rtrace.event(req, "prefill_start", tokens=int(n - start),
                               cached=start, chunked=chunked,
                               resume=resume)
        span = end - start
        bs = self.block_size
        table = self.blocks.table(req.rid)
        if start == 0 and end == n:
            # cold whole-prompt pass: the dense causal prefill program
            bucket = _next_bucket(n, self.max_model_len)
            prog = self._program("prefill", bucket)
            h = prog.stage()
            h["toks"][:n] = ids
            h["plen"][0] = n
            h["blk"][:n] = np.asarray(table, np.int32)[np.arange(n) // bs]
            h["off"][:] = np.arange(bucket) % bs   # padded rows: null blk
            self._stage_sampling(h, [req])
        else:
            # suffix/chunk pass: positions [start, end) attend through
            # the block table to the K/V already in the cache (cached
            # prefix + earlier chunks); cached positions are never
            # recomputed and shared blocks are never written
            bucket = _next_bucket(span, self._chunk_cap())
            prog = self._program("chunk", bucket)
            h = prog.stage()
            h["toks"][:span] = ids[start:end]
            h["start"][0] = start
            h["n_valid"][0] = span
            h["table"][:len(table)] = table
            h["blk"][:span] = h["table"][(start + np.arange(span)) // bs]
            h["off"][:] = (start + np.arange(bucket)) % bs
            self._stage_sampling(h, [req])
        if self._adapters:
            h["slot"][0] = req.adapter_slot
        pkind = "prefill" if start == 0 and end == n else "chunk"
        t0 = self._perf.t0()
        prog.launch(t0)
        self._perf.done(t0, pkind, bucket)
        self._sprof.lap("prefill_dispatch")
        out = self._watched(prog.result(), "prefill_logits", rid=req.rid)
        self._sprof.lap("device_wait")
        tok = int(out[0][0] if self._sampling else out[0])
        req.cache_len = end
        self._stats.on_prefill(span)
        # publish the newly-full blocks under their chain keys so later
        # prompts (or this request's own resume) can reuse them
        self.blocks.note_tokens(req.rid, ids[:end], salt=req.adapter_id)
        if end < n:
            # intermediate chunk: its token is mid-prompt and dropped;
            # the request stays in the prefilling lane
            self._rtrace.event(req, "prefill_chunk", done=int(end),
                               target=int(n), tokens=int(span))
            self._sprof.lap("host_sync")
            return 0
        self._rtrace.event(req, "prefill_end", tokens=int(n - start),
                           resume=resume)
        self.scheduler.prefill_done(req)
        self.scheduler.admit_running(req)
        now = self.clock()
        if req.first_token_t is None:
            req.first_token_t = now
            self._stats.on_first_token(req.ttft() or 0.0)
        else:
            # resume prefill after preemption: the re-emitted token's
            # gap IS the client-visible inter-token latency
            self._stats.on_tokens(req, 1, now=now)
        req.tokens.append(tok)
        if self._sampling:
            self._note_logprobs(req, out[1], out[2], out[3])
        self._maybe_finish(req)
        self._sprof.lap("host_sync")
        return 1

    def _run_decode(self, reqs):
        B = len(reqs)
        prog = self._program("decode", _next_bucket(B, self.max_batch))
        h = prog.stage()
        for i, req in enumerate(reqs):
            h["toks"][i] = req.tokens[-1]
            h["pos"][i] = req.cache_len
            t = self.blocks.table(req.rid)
            h["tables"][i, :len(t)] = t
        self._stage_sampling(h, reqs)
        self._stage_slots(h, reqs)
        bucket = _next_bucket(B, self.max_batch)
        t0 = self._perf.t0()
        prog.launch(t0)
        self._perf.done(t0, "decode", bucket)
        self._sprof.lap("decode_dispatch")
        # the host needs the tokens: the designed sync
        out = self._watched(prog.result(), "decode_logits", batch_size=B,
                            rids=[r.rid for r in reqs])
        self._sprof.lap("device_wait")
        self.decode_steps += 1
        now = self.clock()
        toks = out[0] if self._sampling else out
        for i, req in enumerate(reqs):
            req.cache_len += 1
            req.tokens.append(int(toks[i]))
            if self._sampling:
                self._note_logprobs(req, out[1][i:i + 1], out[2][i:i + 1],
                                    out[3][i:i + 1])
            self._stats.on_tokens(req, 1, now=now)
            self._rtrace.event(req, "decode", batch=self._step_id,
                               batch_size=B, tokens=len(req.tokens),
                               emitted=1)
            self._maybe_finish(req)
        self._sprof.lap("host_sync")
        return B

    def _spec_ingest(self, req):
        """Bring the draft cache up to ``req``'s context: positions
        ``[0, cache_len)`` through the draft's chunk program
        (``draft_chunk``) in one call, at admission and after a resume.
        A prefix-cache hit's shared blocks are rewritten with recomputed
        draft values, which can move other sharers' acceptance, never a
        token."""
        sw = self._spec
        span = sw.context_gap(req)
        if span <= 0:
            return
        bs = self.block_size
        bucket = _next_bucket(span, self.max_model_len)
        with telemetry.span("serve.spec_ingest", rid=req.rid, tokens=span):
            prog = self._program("draft_chunk", bucket)
            h = prog.stage()
            h["toks"][:span] = req.prefill_ids()[:span]
            h["n_valid"][0] = span
            table = self.blocks.table(req.rid)
            h["table"][:len(table)] = table
            h["blk"][:span] = h["table"][np.arange(span) // bs]
            h["off"][:] = np.arange(bucket) % bs   # padded rows: null blk
            t0 = self._perf.t0()
            prog(t0)
            self._perf.done(t0, "draft_chunk", bucket)
        sw.note_ingested(req, span)

    def _run_spec_decode(self, reqs):
        """One speculative iteration over the batch: the draft program
        proposes ``spec_k`` tokens a request, its outputs come to the
        host, and the verify program scores the ``k+1`` positions through
        the block tables.  Greedy engines accept the agreeing prefix on
        the host (``accept_greedy``); sampling engines stage the draft's
        candidate-space q into the verify program, which accepts by
        rejection sampling and resamples the first rejection from the
        residual.  1..k+1 tokens a request, capped at its quota."""
        B = len(reqs)
        k = self.spec_k
        sw = self._spec
        for req in reqs:
            self._spec_ingest(req)
        bucket = _next_bucket(B, self.max_batch)
        draft = self._program("draft", bucket)
        h = draft.stage()
        for i, req in enumerate(reqs):
            h["toks"][i] = req.tokens[-1]
            h["pos"][i] = req.cache_len
            t = self.blocks.table(req.rid)
            h["tables"][i, :len(t)] = t
        self._stage_sampling(h, reqs)
        with telemetry.span("serve.draft", batch=B, k=k):
            t0 = self._perf.t0()
            draft.launch(t0)
            self._perf.done(t0, "draft", bucket)
            self._sprof.lap("decode_dispatch")
            drafted = draft.result()   # the verify rows need them: sync
            self._sprof.lap("device_wait")
        verify = self._program("verify", bucket)
        hv = verify.stage()
        if self._sampling:
            hv["toks"][:] = h["toks"]
            hv["drafted"][:], hv["q_at"][:], hv["q_vals"][:], \
                hv["q_idx"][:] = drafted
            drafted = drafted[0]
            self._stage_sampling(hv, reqs)
        else:
            hv["rows"][:, 0] = h["toks"]
            hv["rows"][:, 1:] = drafted
        hv["pos0"][:] = h["pos"]
        hv["tables"][:] = h["tables"]
        self._stage_slots(hv, reqs)
        with telemetry.span("serve.verify", batch=B, k=k):
            t0 = self._perf.t0()
            verify.launch(t0)
            self._perf.done(t0, "verify", bucket)
            self._sprof.lap("decode_dispatch")
            # acceptance needs them: sync
            out = self._watched(verify.result(), "verify_logits",
                                batch_size=B, rids=[r.rid for r in reqs])
            self._sprof.lap("device_wait")
        emitted = 0
        now = self.clock()
        for i, req in enumerate(reqs):
            if self._sampling:
                accepted = int(out[1][i])
                emit = [int(x) for x in out[0][i][:accepted + 1]]
            else:
                accepted, emit = spec_mod.accept_greedy(drafted[i], out[i],
                                                        k)
            # the draft wrote every candidate position: no gap next time
            sw.note_drafted(req, req.cache_len + k + 1)
            # a run that would overshoot the quota stops where plain
            # decode would, and only emitted drafts count as accepted
            emit = emit[:req.max_new_tokens - len(req.tokens)]
            accepted = min(accepted, len(emit))
            sw.on_verify(k, accepted)
            self._stats.on_verify(k, accepted,
                                  stochastic=req.temperature > 0.0)
            req.tokens.extend(emit)
            if self._sampling:
                self._note_logprobs(req, out[2][i][:len(emit)],
                                    out[3][i][:len(emit)],
                                    out[4][i][:len(emit)])
            req.cache_len += len(emit)
            emitted += len(emit)
            self._stats.on_tokens(req, len(emit), now=now)
            self._rtrace.event(req, "decode", batch=self._step_id,
                               batch_size=B, tokens=len(req.tokens),
                               emitted=len(emit), accepted=accepted)
            self._maybe_finish(req)
            if req.done:
                sw.forget(req.rid)
            else:
                # roll back the speculative tail (never a shared block)
                self.blocks.truncate(req.rid, req.cache_len)
        self._sprof.lap("host_sync")
        return emitted

    def _watched(self, out, anomaly, **fields):
        """A program call's outputs as the unwatched program returns
        them.  Under ``MXTPU_NUMERIC_WATCH`` the body returned one more
        output, ``isfinite(logits).all()``, copied to the host with the
        tokens: a false flag counts an anomaly, marks the flight ring
        and dumps it (rate-limited)."""
        if not self._cfg.numeric_watch:
            return out
        out, ok = out[:-1], out[-1]
        if not bool(ok):
            flight_mod.record_anomaly(anomaly, step=self._step_id, **fields)
        return out[0] if len(out) == 1 else out

    def _maybe_finish(self, req):
        if len(req.tokens) >= req.max_new_tokens:
            self.scheduler.finish(req, status=FINISHED)
            self._stats.on_complete(req)


# -- quantized serving helpers -------------------------------------------------
def quantize_weight(w):
    """Per-output-channel symmetric int8 (the reference's
    ``contrib.quantization.quantize_weight``, on a tensor): returns
    (int8 tensor, float32 scales) with ``w ~= wq * scale[:, None, ...]``.
    An all-zero channel keeps scale 1.0."""
    flat = w.float().reshape(w.shape[0], -1)
    amax = flat.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    wq = torch.round(flat / scale[:, None]).clamp(-127, 127)
    return wq.to(torch.int8).reshape(w.shape), scale


def _quantize_gpt_params(params, name, spec):
    """Weight-only int8 at load: every projection of the normalized
    gpt() checkpoint becomes int8 weights plus a ``*_wscale`` float32
    vector that :func:`_wfc` dequantizes.  Embeddings, norms and biases
    stay floating point, and so does a tied head (it is the embedding
    matrix)."""
    out = dict(params)
    stems = []
    for i in range(spec["n_layers"]):
        p = f"{name}_l{i}"
        stems += [f"{p}_q", f"{p}_k", f"{p}_v", f"{p}_proj",
                  f"{p}_ff_up", f"{p}_ff_down"]
        if spec["swiglu"]:
            stems.append(f"{p}_ff_gate")
    if not spec["tied"]:
        stems.append(f"{name}_head")
    for stem in stems:
        w = out.get(f"{stem}_weight")
        if w is not None:
            out[f"{stem}_weight"], out[f"{stem}_wscale"] = \
                quantize_weight(w)
    return out


# -- the export store's program module ---------------------------------------
class _Exportable(torch.nn.Module):
    """A program body as a module for ``torch.export``: ``forward``
    takes the inputs and the state (parameters, caches, scales, adapter
    stacks) as two dicts, so both are inputs of the exported program."""

    def __init__(self, body):
        super().__init__()
        self.body = body

    def forward(self, inputs, state):
        return self.body(**inputs, **state)


def _call_exported(module, state, **inputs):
    """A ``_Program`` body over an exported program's module."""
    return module(inputs, state)


def _cache_numel(state):
    """Elements of one layer of one shard of a program's K cache: the
    smallest cache write a program makes, the size
    ``export_store.cache_copies`` looks for."""
    return _first(state["ck"])[0].numel()


# -- the tensor-parallel layout ------------------------------------------------
# At tp > 1 a sharded parameter (and a cache, a scale, a sharded adapter
# stack) is a list of one tensor a shard, a replicated one a tensor.  An
# activation between two projections is either a tensor (whole) or a
# list of the shards' pieces of its last dimension.  At tp 1 nothing is
# a list, and every helper below reduces to the op it wraps.
def _first(t):
    """A buffer's first shard (the tensor itself when not sharded)."""
    return t[0] if isinstance(t, list) else t


def _shard(t, s):
    """Shard ``s`` of a buffer (a replicated tensor serves every one)."""
    return t[s] if isinstance(t, list) else t


def _nbytes(t):
    """Bytes of a buffer, every shard's."""
    return sum(int(x.nbytes) for x in t) if isinstance(t, list) \
        else int(t.nbytes)


@functools.lru_cache(maxsize=None)
def _split_map(split):
    return dict(split)


def _full(cfg, params, key):
    """Parameter ``key`` whole: its shards joined on their dim."""
    v = params[key]
    if not isinstance(v, list):
        return v
    return torch.cat(v, dim=_split_map(cfg.split)[key])


def _full_shape(cfg, params, key):
    """The whole shape of parameter ``key``."""
    v = params[key]
    if not isinstance(v, list):
        return tuple(v.shape)
    shape = list(v[0].shape)
    shape[_split_map(cfg.split)[key]] *= len(v)
    return tuple(shape)


def _rows(cfg, params, key):
    """Per-shard pieces of a 1-D per-output vector (a bias, a weight
    scale): its shards, or the whole vector chunked."""
    v = params.get(key)
    if v is None or isinstance(v, list):
        return v if v is not None else [None] * cfg.tp
    return list(torch.chunk(v, cfg.tp))


def _joined(x):
    """An activation whole: a list of pieces concatenated."""
    if not isinstance(x, list):
        return x
    return x[0] if len(x) == 1 else torch.cat(x, dim=-1)


def _pieces(cfg, x):
    """An activation as its shards' pieces of the last dimension."""
    return x if isinstance(x, list) else list(torch.chunk(x, cfg.tp, -1))


def _elementwise(cfg, fn, *xs):
    """``fn`` over activations: piece by piece where any is split."""
    if not any(isinstance(x, list) for x in xs):
        return fn(*xs)
    return [fn(*p) for p in zip(*(_pieces(cfg, x) for x in xs))]


def _deq(w, sc, dtype):
    """An int8 weight dequantized as ``_wfc`` does (weight, then scale,
    cast to the activation dtype, then multiplied); a floating-point
    weight (``sc`` None) as it is."""
    return w if sc is None else w.to(dtype) * sc.to(dtype)[:, None]


def _proj(cfg, params, adp, stem, x, slots):
    """Projection ``stem`` of activation ``x`` (its LoRA delta too when
    the program binds the adapter stacks).  At tp 1, :func:`_awfc`.  At
    tp > 1, by the weight's layout: a replicated weight takes ``x``
    whole and gives the output whole; an out-sharded (column) weight
    takes ``x`` whole and gives each shard its piece (its bias and scale
    pieces added there); an in-sharded (row) weight takes each shard's
    piece of ``x`` and gives partial sums, reduced over the shards, the
    bias added once after.  A sharded stack follows its parent: B split
    on d_out with an out-sharded one, A on d_in with an in-sharded
    one."""
    if cfg.tp == 1:
        return _awfc(params, adp, stem, _joined(x), slots)
    wkey = f"{stem}_weight"
    dim = _split_map(cfg.split).get(wkey)
    if dim is None:
        xf = _joined(x)
        w = _deq(_full(cfg, params, wkey),
                 _full(cfg, params, f"{stem}_wscale")
                 if f"{stem}_wscale" in params else None, xf.dtype)
        out = _fc(xf, w, _full(cfg, params, f"{stem}_bias"))
        if adp is not None:
            out = out + _lora_delta(_stack_view(adp, stem, None), stem, xf,
                                    slots)
        return out
    ws = params[wkey]
    if dim == 0:
        xf = _joined(x)
        scs = _rows(cfg, params, f"{stem}_wscale")
        bs = _rows(cfg, params, f"{stem}_bias")
        outs = []
        for s in range(cfg.tp):
            o = _fc(xf, _deq(ws[s], scs[s], xf.dtype), bs[s])
            if adp is not None:
                o = o + _lora_delta(_stack_view(adp, stem, s), stem, xf,
                                    slots)
            outs.append(o)
        return outs
    xs = _pieces(cfg, x)
    sc = (_full(cfg, params, f"{stem}_wscale")
          if f"{stem}_wscale" in params else None)
    out = None
    for s in range(cfg.tp):
        w = _deq(ws[s], sc, xs[s].dtype)
        part = xs[s] @ w.t().to(xs[s].dtype)
        if adp is not None:
            part = part + _lora_delta(_stack_view(adp, stem, s), stem,
                                      xs[s], slots)
        out = part if out is None else out + part
    return out + _full(cfg, params, f"{stem}_bias").to(out.dtype)


def _stack_view(adp, stem, s):
    """The adapter stacks of ``stem`` as shard ``s`` sees them."""
    return {f"{stem}_A": _shard(adp[f"{stem}_A"], s),
            f"{stem}_B": _shard(adp[f"{stem}_B"], s),
            "scale": adp["scale"]}


def _head_shards(cfg, x, n_heads, lead):
    """Each shard's heads of a projection output ``x`` (whole or split),
    as ``(*lead, n_heads/tp, head_dim)`` tensors, one a shard."""
    h = n_heads // cfg.tp
    return [t.reshape(*lead, h, cfg.head_dim) for t in
            (x if isinstance(x, list) else
             [x] if cfg.tp == 1 else torch.chunk(x, cfg.tp, -1))]


def _wfc(params, stem, x):
    """``_fc`` through a possibly int8 checkpoint entry: with a
    ``<stem>_wscale`` the int8 weight is dequantized in the activation
    dtype first (weight, then scale, cast to it, then multiplied, as the
    reference does); without one this is ``_fc`` on the entry."""
    w = _deq(params[f"{stem}_weight"], params.get(f"{stem}_wscale"),
             x.dtype)
    return _fc(x, w, params[f"{stem}_bias"])


def _lora_delta(adp, stem, x, slots):
    """One projection's LoRA delta (the reference's ``_lora_delta``):
    gather each row's (A, B) slices and scale from the device stacks by
    its slot and compute ``scale * x @ A.T @ B.T``, in that order and in
    ``x.dtype``, never materializing a merged weight.  Slot 0's rows and
    scale are zeros, so a base row adds exactly ``+0.0``.

    ``slots`` is a 0-dim tensor for the one-request prefill and chunk
    programs, ``(B,)`` for decode (2-D ``x``) and verify (3-D ``x``
    ``(B, K+1, D)``: the slot broadcasts over the candidate positions).
    Gathers are ``index_select`` on the device: indexing by a 0-dim
    tensor would read it on the host, which a capture forbids."""
    a, b, sc = adp[f"{stem}_A"], adp[f"{stem}_B"], adp["scale"]
    if slots.ndim == 0:
        i = slots.reshape(1)
        u = x @ a.index_select(0, i)[0].to(x.dtype).t()        # (..., r)
        return ((u @ b.index_select(0, i)[0].to(x.dtype).t())
                * sc.index_select(0, i).to(x.dtype))
    ga = a.index_select(0, slots).to(x.dtype)                  # (B, r, i)
    gb = b.index_select(0, slots).to(x.dtype)                  # (B, o, r)
    s = sc.index_select(0, slots).to(x.dtype)
    if x.ndim == 2:
        u = torch.einsum("bi,bri->br", x, ga)
        return torch.einsum("br,bor->bo", u, gb) * s[:, None]
    u = torch.einsum("bki,bri->bkr", x, ga)
    return torch.einsum("bkr,bor->bko", u, gb) * s[:, None, None]


def _awfc(params, adp, stem, x, slots):
    """:func:`_wfc` plus the rows' LoRA delta when the program binds the
    adapter stacks (``adp`` None: adapters off, the plain projection)."""
    base = _wfc(params, stem, x)
    if adp is None:
        return base
    return base + _lora_delta(adp, stem, x, slots)


def _kv_quant_vals(vals):
    """Per-slot-per-head symmetric int8 of K/V rows ``(..., Hkv, Dh)`` ->
    (int8 rows, float32 scales ``(..., Hkv)``).  Each slot is quantized
    over its own head vector, so the cache is a function of the values
    written, not of the order of the writes (preemption and chunked
    prefill stay token-stable).  ``torch.round`` rounds half to even, as
    ``jnp.round`` does; a zero vector keeps scale 1.0."""
    vf = vals.float()
    amax = vf.abs().amax(dim=-1)
    sc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(vf / sc[..., None]).clamp(-127, 127).to(torch.int8)
    return q, sc


def _kv_dequant(q, sc, dtype):
    """Invert :func:`_kv_quant_vals`: int8 rows ``(..., Hkv, Dh)`` and
    scales ``(..., Hkv)`` -> rows in ``dtype`` (product in float32, one
    rounding)."""
    return (q.float() * sc.float()[..., None]).to(dtype)


# -- sampling (the sampling-mode programs' warp and draw) --------------------
def _cap(cfg, V):
    """The candidate width: ``sample_cap`` clamped to the vocabulary."""
    return min(cfg.sample_cap, V) if cfg.sample_cap else V


def _filter_logits(cfg, logits, temp, top_p, top_k):
    """Temperature, top-k and top-p warping with per-row inputs (the
    reference's ``_filter_logits``).

    ``logits`` (..., V); ``temp``/``top_p`` float32 and ``top_k`` int32
    broadcastable over the leading dims (top_k 0 = off).  Returns
    ``(masked, idx)``: the top ``sample_cap`` candidates' warped logits
    in descending order, filtered ones at -inf, and their vocab ids.  A
    nucleus keeps a candidate while the mass before it is under top_p.
    A greedy row (temp <= 0) comes out one-hot on candidate 0, whose id
    is ``argmax`` of its logits (the first maximal one, as the greedy
    programs pick: ``topk`` promises no order among ties).  Constants
    are fills and scalar arguments: a host-made tensor would be a copy,
    which a CUDA graph capture refuses."""
    V = logits.shape[-1]
    cap = _cap(cfg, V)
    greedy = temp <= 0.0
    lg = logits.float()
    scaled = lg / torch.where(greedy, torch.ones_like(temp), temp)[..., None]
    vals, idx = torch.topk(scaled, cap, dim=-1)        # descending
    j = torch.arange(cap, device=logits.device)
    k_eff = torch.where(top_k > 0, top_k.clamp(max=cap),
                        torch.full_like(top_k, cap))
    keep = j < k_eff[..., None]
    ninf = float("-inf")
    probs = torch.softmax(vals.masked_fill(~keep, ninf), dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep = keep & ((csum - probs) < top_p[..., None])
    masked = vals.masked_fill(~keep, ninf)
    onehot = torch.zeros(cap, device=logits.device).masked_fill(j != 0, ninf)
    masked = torch.where(greedy[..., None], onehot, masked)
    first = greedy[..., None] & (j == 0)
    idx = torch.where(first, lg.argmax(dim=-1, keepdim=True), idx)
    return masked, idx


def _draw(masked, seed, purpose):
    """One categorical draw a row over ``masked`` (..., cap) logits:
    Gumbel-max with the counter-based noise of (seed, purpose, element
    index).  Returns the candidate positions (...,)."""
    return torch.argmax(masked + _gumbel(seed, purpose, masked.shape,
                                         masked.device), dim=-1)


def _sample_ops(cfg, logits, temp, top_p, top_k, seed, purpose=_SAMPLE):
    """One token a row from the warped distribution (greedy rows: their
    argmax); int32 ids of the leading shape."""
    masked, idx = _filter_logits(cfg, logits, temp, top_p, top_k)
    choice = _draw(masked, seed, purpose)
    return idx.gather(-1, choice[..., None])[..., 0].to(torch.int32)


def _scatter_probs(probs, idx, V):
    """Candidate probabilities ``(..., cap)`` scattered onto their vocab
    ids: a full ``(..., V)`` vector, zero off the candidates."""
    full = torch.zeros(probs.shape[:-1] + (V,), dtype=torch.float32,
                       device=probs.device)
    return full.scatter(-1, idx.long(), probs.float())


def _filtered_probs_full(cfg, logits, temp, top_p, top_k):
    """The warped sampling distribution as a full-vocab vector (the
    reference view the tests and chip_smoke hold the draws against; the
    programs sample from the candidates)."""
    masked, idx = _filter_logits(cfg, logits, temp, top_p, top_k)
    return _scatter_probs(torch.softmax(masked, dim=-1), idx,
                          logits.shape[-1])


def _safe_log(p):
    """log(p) with exact -inf at p == 0."""
    return torch.log(p.clamp(min=1e-38)).masked_fill(p <= 0, float("-inf"))


def _logprob_outs(logits, toks):
    """The logprob outputs of a sampled position: the chosen token's
    log-softmax and the ``TOP_LOGPROBS`` best (values, ids), raw model
    logprobs (before temperature and filtering)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    chosen = lp.gather(-1, toks.long()[..., None])[..., 0]
    tv, ti = torch.topk(lp, min(TOP_LOGPROBS, lp.shape[-1]), dim=-1)
    return chosen, tv, ti.to(torch.int32)


def _sampled(cfg, logits, temp, topp, topk, seed):
    """The sampling-mode programs' tail: (tokens, chosen logprobs, top
    values, top ids)."""
    tok = _sample_ops(cfg, logits, temp, topp, topk, seed)
    return (tok,) + _logprob_outs(logits, tok)


def _cfg_fields(cfg):
    """A ``_ModelCfg`` as its fingerprint dict: ``kv_quant``,
    ``sampling`` and ``sample_cap``, and ``numeric_watch``, only when
    on."""
    d = cfg._asdict()
    # the layout enters the engine's fingerprint as its tp degree, mesh
    # and rules digest (at tp > 1 only)
    del d["tp"], d["split"]
    if not d["kv_quant"]:
        del d["kv_quant"]
    if not d["sampling"]:
        del d["sampling"], d["sample_cap"]
    if not d["numeric_watch"]:
        del d["numeric_watch"]
    return d


def _watch(cfg, out, logits):
    """A body's outputs ``out`` (a tensor or a tuple), plus under
    ``cfg.numeric_watch`` the flag ``isfinite(logits).all()``, copied to
    the host with the tokens (one more all-reduce; no sync of its
    own)."""
    if not cfg.numeric_watch:
        return out
    outs = (out,) if torch.is_tensor(out) else tuple(out)
    return outs + (torch.isfinite(logits).all(),)


def _write_kv(cfg, i, ck, cv, ksc, vsc, blk, off, kh, vh):
    """Write layer ``i``'s K/V rows at (blk, off) in place (the
    reference's ``.at[].set`` on a donated cache), quantized with their
    scales under ``cfg.kv_quant``.  Returns None, or under int8 what was
    written: ``(kq, k_scales, vq, v_scales)``."""
    if not cfg.kv_quant:
        ck[i].index_put_((blk, off), kh)
        cv[i].index_put_((blk, off), vh)
        return None
    kq, ks = _kv_quant_vals(kh)
    vq, vs = _kv_quant_vals(vh)
    ck[i].index_put_((blk, off), kq)
    ksc[i].index_put_((blk, off), ks)
    cv[i].index_put_((blk, off), vq)
    vsc[i].index_put_((blk, off), vs)
    return kq, ks, vq, vs


# -- program bodies (the reference's jit programs) ---------------------------
# Each reads its inputs from device tensors only (no host read, which a
# capture forbids) and writes the cache in place.  ``ksc``/``vsc`` are
# the int8 cache's scale tensors (None without ``cfg.kv_quant``);
# ``adp`` the adapter stacks and ``slots`` the rows' slots (None with
# adapters off, and in the draft's bodies).
def _norm(cfg, params, key, x):
    """Layer norm (or RMS norm) ``key`` (``..._ln1``) of ``x``."""
    return _ln(x, _full(cfg, params, f"{key}_gamma"),
               None if cfg.rmsnorm else _full(cfg, params, f"{key}_beta"))


def _silu_mul(g, u):
    gf = g.float()                               # f32 silu == sym.silu
    return (gf * torch.sigmoid(gf)).to(g.dtype) * u


def _mlp(cfg, params, p, x, adp=None, slots=None):
    h2 = _norm(cfg, params, f"{p}_ln2", x)
    if cfg.swiglu:
        up = _elementwise(cfg, _silu_mul,
                          _proj(cfg, params, adp, f"{p}_ff_gate", h2, slots),
                          _proj(cfg, params, adp, f"{p}_ff_up", h2, slots))
    else:
        up = _elementwise(cfg, _gelu,
                          _proj(cfg, params, adp, f"{p}_ff_up", h2, slots))
    return _joined(_proj(cfg, params, adp, f"{p}_ff_down", up, slots))


def _logits(cfg, params, x):
    name = cfg.name
    final = _norm(cfg, params, f"{name}_ln_f", x)
    if cfg.tied:
        return final @ _full(cfg, params, f"{name}_tok_embed_weight").t().to(
            final.dtype)
    return _joined(_proj(cfg, params, None, f"{name}_head", final, None))


def _embed(cfg, params, toks, pos):
    """Token rows (and learned positions, clamped: a padded row's may
    run past the table)."""
    name = cfg.name
    x = _full(cfg, params, f"{name}_tok_embed_weight")[toks.long()]
    if cfg.pos_table is not None:
        x = x + _full(cfg, params, f"{name}_pos_embed_weight")[
            0, pos.clamp(max=cfg.pos_table - 1)]
    return x


def _qkv(cfg, params, p, x, n, adp=None, slots=None):
    """Layer ``p``'s q, k and v heads of rows ``x``: one ``(*n, heads,
    head_dim)`` triple a shard (``n`` an int or a tuple of leading
    dims)."""
    lead = tuple(n) if isinstance(n, tuple) else (n,)
    h = _norm(cfg, params, f"{p}_ln1", x)
    q = _proj(cfg, params, adp, f"{p}_q", h, slots)
    k = _proj(cfg, params, adp, f"{p}_k", h, slots)
    v = _proj(cfg, params, adp, f"{p}_v", h, slots)
    return list(zip(_head_shards(cfg, q, cfg.num_heads, lead),
                    _head_shards(cfg, k, cfg.kv_heads, lead),
                    _head_shards(cfg, v, cfg.kv_heads, lead)))


def _token_layers(cfg, params, ck, cv, toks, pos, tables, ksc=None,
                  vsc=None, adp=None, slots=None):
    """The decode layers: write each row's K/V at its position (in
    place), attend through the block tables, return the final hidden
    rows (B, D).  The table column is clamped and the learned position
    too, so a draft step past the table reads and writes in range (its
    zeroed table row sends the write to the null block)."""
    name = cfg.name
    B = toks.shape[0]
    pos = pos.long()
    x = _embed(cfg, params, toks, pos)                       # (B, D)
    col = (pos // cfg.block_size).clamp(max=tables.shape[1] - 1)
    blk = tables.long().gather(1, col[:, None])[:, 0]
    off = pos % cfg.block_size
    ctx = (pos + 1).to(torch.int32)
    for i in range(cfg.n_layers):
        p = f"{name}_l{i}"
        outs = []
        # one paged-attention call a shard, on that shard's cache
        for s, (qh, kh, vh) in enumerate(_qkv(cfg, params, p, x, B, adp,
                                              slots)):
            if cfg.pos_table is None:
                qh, kh = _rope(qh, pos), _rope(kh, pos)
            sk, sv = _shard(ck, s), _shard(cv, s)
            sks = svs = None
            if cfg.kv_quant:
                sks, svs = _shard(ksc, s), _shard(vsc, s)
            _write_kv(cfg, i, sk, sv, sks, svs, blk, off, kh, vh)
            scales = ({"k_scale": sks[i], "v_scale": svs[i]}
                      if cfg.kv_quant else {})
            attn = paged_attention(qh, sk[i], sv[i], tables, ctx,
                                   window=cfg.window, impl=cfg.paged_impl,
                                   **scales)
            outs.append(attn.reshape(B, qh.shape[1] * cfg.head_dim))
        x = x + _joined(_proj(cfg, params, adp, f"{p}_proj", outs, slots))
        x = x + _mlp(cfg, params, p, x, adp, slots)
    return x


def _forward_token_batch(cfg, params, ck, cv, toks, pos, tables, ksc=None,
                         vsc=None, adp=None, slots=None):
    """Shared decode math: :func:`_token_layers`, then the logits
    (B, V)."""
    return _logits(cfg, params, _token_layers(cfg, params, ck, cv, toks,
                                              pos, tables, ksc, vsc, adp,
                                              slots))


def _decode(cfg, toks, pos, tables, *, params, ck, cv, ksc=None, vsc=None,
            temp=None, topp=None, topk=None, seed=None, adp=None,
            slots=None):
    """One batched decode step (the reference's ``_build_decode``
    program): the (B,) int32 next tokens, argmax; in sampling mode
    drawn per row, with their logprob outputs."""
    logits = _forward_token_batch(cfg, params, ck, cv, toks, pos, tables,
                                  ksc, vsc, adp, slots)
    if cfg.sampling:
        return _watch(cfg, _sampled(cfg, logits, temp, topp, topk, seed),
                      logits)
    return _watch(cfg, torch.argmax(logits, dim=-1).to(torch.int32), logits)


def _prefill(cfg, P, toks, plen, blk, off, *, params, ck, cv, ksc=None,
             vsc=None, temp=None, topp=None, topk=None, seed=None, adp=None,
             slot=None):
    """Whole-prompt pass at padded length P for ONE request (the
    reference's ``_build_prefill`` program): writes K/V for positions
    [0, P) through (blk, off) — padded rows land in the null block —
    and returns the (1,) int32 token after position ``plen - 1`` (in
    sampling mode drawn, with its logprob outputs)."""
    logits = _prefill_logits(cfg, P, params, ck, cv, toks, plen, blk, off,
                             ksc, vsc, adp, _scalar(slot))
    if cfg.sampling:
        return _watch(cfg, _sampled(cfg, logits, temp, topp, topk, seed),
                      logits)
    return _watch(cfg, torch.argmax(logits, dim=-1).to(torch.int32), logits)


def _restore(blks, hk, hv, hks=None, hvs=None, *, ck, cv, ksc=None,
             vsc=None):
    """The host tier's restore program (the reference's
    ``_build_restore``): scatter R parked blocks' K/V (and int8 scales)
    into the cache at ``blks`` along the block axis.  Padding rows carry
    block 0, the null block, whose contents are garbage by design (their
    duplicate writes land in any order).  No output: nothing waits."""
    b = blks.long()
    bufs = [(ck, hk), (cv, hv)]
    if hks is not None:
        bufs += [(ksc, hks), (vsc, hvs)]
    for buf, h in bufs:
        if not isinstance(buf, list):
            buf.index_copy_(1, b, h)
            continue
        # each shard takes its heads of the parked block (axis 3)
        for shard, piece in zip(buf, torch.chunk(h, len(buf), dim=3)):
            shard.index_copy_(1, b, piece)


def _scalar(slot):
    """A (1,) slot input as the 0-dim slot of one request's rows."""
    return None if slot is None else slot[0]


def _last_row(x, n):
    """Row ``n - 1`` of ``x`` as (1, D): ``n`` an int, or a (1,) device
    tensor (read on the device; indexing with it could read it on the
    host, which a capture forbids), clamped to row 0 for the all-zero
    inputs of a program's warm-up runs."""
    if torch.is_tensor(n):
        return x.index_select(0, (n - 1).clamp(min=0))
    return x[n - 1][None]


def _prefill_logits(cfg, P, params, ck, cv, toks, plen, blk, off, ksc=None,
                    vsc=None, adp=None, slot=None):
    """:func:`_prefill`'s body up to the (1, V) logits of position
    ``plen - 1`` (``plen`` an int or a (1,) device tensor): dense causal
    attention within the prompt's own rows."""
    pos = torch.arange(P, device=toks.device)
    keep = pos[:, None] >= pos[None, :]                     # causal
    if cfg.window:
        keep = keep & (pos[:, None] - pos[None, :] < cfg.window)
    return _dense_logits(cfg, params, ck, cv, ksc, vsc, toks, pos, blk, off,
                         keep, plen, adp=adp, slots=slot)


def _chunk(cfg, C, toks, start, n_valid, table, blk, off, *, params, ck,
           cv, ksc=None, vsc=None, temp=None, topp=None, topk=None,
           seed=None, adp=None, slot=None):
    """Suffix/chunk prefill (the reference's ``_build_chunk`` program):
    the (1,) int32 token after position ``start + n_valid - 1`` (in
    sampling mode drawn, with its logprob outputs), meaningful on a
    prompt's final chunk only."""
    logits = _chunk_logits(cfg, C, params, ck, cv, toks, start, n_valid,
                           table, blk, off, ksc, vsc, adp, _scalar(slot))
    if cfg.sampling:
        return _watch(cfg, _sampled(cfg, logits, temp, topp, topk, seed),
                      logits)
    return _watch(cfg, torch.argmax(logits, dim=-1).to(torch.int32), logits)


def _chunk_logits(cfg, C, params, ck, cv, toks, start, n_valid, table,
                  blk, off, ksc=None, vsc=None, adp=None, slot=None):
    """C token rows of ONE request whose earlier positions' K/V already
    sit in the cache (a prefix-cache hit, or earlier chunks).  Rows hold
    positions [start, start + n_valid); rows past ``n_valid`` are
    padding, written into the null block through (blk, off) and
    discarded.  Each row's K/V is written through the block table
    FIRST, then the request's whole table (``table``, (W,)) is gathered
    once a layer and each row keeps the cache positions <= its own
    (within ``window``): in-chunk causality is exact without a dense
    (C, C) score matrix.  ``start`` and ``n_valid`` are (1,) device
    tensors.  Returns the (1, V) logits of position ``start + n_valid -
    1``."""
    pos = start.long() + torch.arange(C, device=toks.device)
    S = table.shape[0] * cfg.block_size
    spos = torch.arange(S, device=toks.device)[None, :]  # cache positions
    keep = spos <= pos[:, None]                   # causal, self included
    if cfg.window:
        keep = keep & (spos > pos[:, None] - cfg.window)
    return _dense_logits(cfg, params, ck, cv, ksc, vsc, toks, pos, blk, off,
                         keep, n_valid, table=table.long(), adp=adp,
                         slots=slot)


def _dense_logits(cfg, params, ck, cv, ksc, vsc, toks, pos, blk, off, keep,
                  last, table=None, adp=None, slots=None):
    """The prefill and chunk programs' layers: the rows at positions
    ``pos`` write their K/V through (blk, off), then attend densely
    (float32 softmax) under ``keep`` (rows x keys) to this pass's own
    K/V, or, given ``table`` (W,), to the request's whole block table
    gathered from the cache after the write.  Under ``cfg.kv_quant``
    both see the cache's int8 round trip: prefill attends to its own
    rows dequantized, chunk dequantizes the gathered table.  Returns the
    (1, V) logits of row ``last - 1``."""
    name = cfg.name
    Dh = cfg.head_dim
    group = cfg.num_heads // cfg.kv_heads
    n = toks.shape[0]
    blk, off = blk.long(), off.long()
    x = _embed(cfg, params, toks, pos)                       # (n, D)
    for i in range(cfg.n_layers):
        p = f"{name}_l{i}"
        outs = []
        for s, (qh, kh, vh) in enumerate(_qkv(cfg, params, p, x, n, adp,
                                              slots)):
            if cfg.pos_table is None:
                qh, kh = _rope(qh, pos), _rope(kh, pos)
            sk, sv = _shard(ck, s), _shard(cv, s)
            sks = svs = None
            if cfg.kv_quant:
                sks, svs = _shard(ksc, s), _shard(vsc, s)
            Hkv = kh.shape[1]
            written = _write_kv(cfg, i, sk, sv, sks, svs, blk, off, kh, vh)
            if table is not None:
                kh = sk[i][table].reshape(-1, Hkv, Dh)
                vh = sv[i][table].reshape(-1, Hkv, Dh)
                if cfg.kv_quant:
                    kh = _kv_dequant(kh, sks[i][table].reshape(-1, Hkv),
                                     x.dtype)
                    vh = _kv_dequant(vh, svs[i][table].reshape(-1, Hkv),
                                     x.dtype)
            elif written is not None:
                kq, ks, vq, vs = written
                kh = _kv_dequant(kq, ks, x.dtype)
                vh = _kv_dequant(vq, vs, x.dtype)
            # grouped-query attention: (kv head, group) x rows x keys
            qg = qh.reshape(n, Hkv, group, Dh)
            sc = torch.einsum("qkgd,skd->kgqs", qg, kh) / math.sqrt(Dh)
            sc = sc.masked_fill(~keep, float("-inf"))
            pr = torch.softmax(sc.float(), dim=-1).to(x.dtype)
            at = torch.einsum("kgqs,skd->qkgd", pr, vh)
            outs.append(at.reshape(n, Hkv * group * Dh))
        x = x + _joined(_proj(cfg, params, adp, f"{p}_proj", outs, slots))
        x = x + _mlp(cfg, params, p, x, adp, slots)
    return _logits(cfg, params, _last_row(x, last))
