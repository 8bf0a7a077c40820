"""The serving engine: continuous batching over a paged KV-cache.

The port of ``mxnet_tpu/serve/engine.py``'s greedy core:

  eng = Engine(params, num_heads=12, device="cuda")
  req = eng.submit(prompt_ids, max_new_tokens=64)   # may raise QueueFull
  for tok in eng.stream(req):
      ...
  eng.shutdown()

Each ``step()`` is one scheduler iteration: at most
``max_prefills_per_step`` whole-prompt prefills, then ONE batched
single-token decode over every running request.  Shapes are padded to
the reference's power-of-two buckets and the block-table width is fixed
at ``max_model_len / block_size``.  Cache-pressure policy (preemption by
recomputation, back-pressure) lives in ``scheduler.Scheduler``; the
engine executes the schedule it is handed.

The KV-cache is ONE device tensor pair per engine, (layers, num_blocks,
block_size, kv_heads, head_dim), carved into blocks by
``kv_block_manager.BlockManager``.  The reference's jit programs
(``_build_prefill``, ``_build_decode``) are plain functions here that run
eagerly and write the cache in place (``index_put_``) where the
reference used ``.at[].set`` under buffer donation.  Decode attends
through ``ops.attention.paged_attention`` — the Hopper kernel on CUDA;
prefill attention is dense torch, as the reference's is dense jnp.

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP §A item: the prefix cache and chunked prefill (6), quantized
weights/KV (7), the host KV tier (8), sampling (9), speculative decoding
(10), LoRA adapters (11), AOT program stores (12), tensor parallelism
(13), and Symbol-driven config (15).
"""

from __future__ import annotations

import collections
import math
import os
import time

import numpy as np
import torch

from .. import telemetry
from ..base import env_flag, env_int
from ..context import resolve_device
from ..convert import params_from_numpy
from ..models.generate import _fc, _gelu, _ln, detect_gpt_variant
from ..ops.attention import paged_attention, resolve_paged_impl
from .kv_block_manager import BlockManager
from .scheduler import CANCELLED, FINISHED, QueueFull, Request, Scheduler
from .stats import StatsRecorder

__all__ = ["Engine"]

# the static model config the program bodies close over; ``paged_impl``
# is the decode attention's implementation ("cuda" or "torch")
_ModelCfg = collections.namedtuple("_ModelCfg", [
    "name", "n_layers", "num_heads", "head_dim", "kv_heads", "pos_table",
    "swiglu", "tied", "rmsnorm", "window", "block_size", "paged_impl"])


def _next_bucket(n, cap):
    """Smallest power-of-two >= n, clamped to cap."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


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


def _unported(what, item):
    return NotImplementedError(
        f"serve.Engine: {what} is not ported yet (ROADMAP §A item {item})")


class Engine:
    """Continuous-batching greedy inference engine over a paged KV-cache.

    Args:
      params: gpt() parameter dict (numpy arrays or torch tensors;
        fused-qkv and ``*_wscale`` checkpoints are normalized at load).
      num_heads / window: decode config not recoverable from weight
        shapes (window = the trained sliding-window radius, 0 = full).
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
      clock: injectable monotonic clock (tests drive deadlines).
      device: where weights, cache and programs live (default
        ``"cuda"``; raises when CUDA is absent — no CPU fallback).
      dtype: parameter/activation dtype (default: the checkpoint's).
    """

    def __init__(self, params, num_heads=None, window=None, name="gpt",
                 block_size=None, num_blocks=None, max_batch=None,
                 max_queue=None, max_model_len=None,
                 max_prefills_per_step=1, clock=time.monotonic,
                 device="cuda", dtype=None, tenant_share=None,
                 prefix_cache=None, prefill_chunk=None, temperature=0.0,
                 top_k=None, top_p=None, sampling=None, tp=None,
                 quantize=None, kv_dtype=None, spec_k=None, adapters=None,
                 host_kv_bytes=None, aot_dir=None, symbol=None):
        if symbol is not None:
            raise _unported("symbol= (decode config from a Symbol)", 15)
        if (prefix_cache if prefix_cache is not None
                else env_flag("MXTPU_SERVE_PREFIX_CACHE", False)):
            raise _unported("the prefix cache", 6)
        if (prefill_chunk if prefill_chunk is not None
                else env_int("MXTPU_SERVE_PREFILL_CHUNK", 0)):
            raise _unported("chunked prefill", 6)
        if (quantize or os.environ.get("MXTPU_SERVE_QUANT")
                or kv_dtype or os.environ.get("MXTPU_SERVE_KV_DTYPE")):
            raise _unported("quantized serving (quantize/kv_dtype)", 7)
        if host_kv_bytes or env_int("MXTPU_SERVE_HOST_KV_BYTES", 0):
            raise _unported("the host-DRAM KV tier (host_kv_bytes)", 8)
        if (temperature or top_k or (top_p is not None and top_p < 1.0)
                or sampling or env_flag("MXTPU_SERVE_SAMPLING", False)):
            raise _unported("sampling", 9)
        if spec_k or env_int("MXTPU_SERVE_SPEC", 0):
            raise _unported("speculative decoding (spec_k)", 10)
        if adapters or env_int("MXTPU_SERVE_ADAPTERS", 0):
            raise _unported("LoRA adapters", 11)
        if aot_dir is not None or os.environ.get("MXTPU_AOT_DIR"):
            raise _unported("AOT program stores (aot_dir)", 12)
        if (tp if tp is not None else env_int("MXTPU_SERVE_TP", 1)) != 1:
            raise _unported("tensor-parallel serving (tp > 1)", 13)
        if num_heads is None:
            raise ValueError("num_heads is required")
        window = 0 if window is None else int(window)
        if window < 0:
            raise ValueError(f"window must be >= 0 (got {window})")

        self.device = resolve_device(device)
        self.block_size = (int(block_size) if block_size is not None
                           else env_int("MXTPU_SERVE_BLOCK_SIZE", 16))
        self.num_blocks = (int(num_blocks) if num_blocks is not None
                           else env_int("MXTPU_SERVE_NUM_BLOCKS", 512))
        self.max_batch = (int(max_batch) if max_batch is not None
                          else env_int("MXTPU_SERVE_MAX_BATCH", 8))
        max_queue = (int(max_queue) if max_queue is not None
                     else env_int("MXTPU_SERVE_MAX_QUEUE", 64))

        self.params = params_from_numpy(params, self.device, dtype=dtype,
                                        name=name)
        self.spec = detect_gpt_variant(self.params, num_heads, name)
        self.name = name
        self.num_heads = int(num_heads)
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

        self.blocks = BlockManager(self.num_blocks, self.block_size,
                                   prefix_cache=False)
        self.scheduler = Scheduler(self.blocks, self.max_batch, max_queue,
                                   max_prefills_per_step, clock=clock,
                                   tenant_share=tenant_share,
                                   prefill_chunk=0)
        self._stats = StatsRecorder(clock=clock)
        self.clock = clock
        self._step_id = 0
        self.decode_steps = 0          # batched decode passes run
        self._noop_steps = 0
        self._alive = True

        L = self.spec["n_layers"]
        dt = self.params[f"{name}_tok_embed_weight"].dtype
        shape = (L, self.num_blocks, self.block_size,
                 self.spec["kv_heads"], self.spec["head_dim"])
        self._cache_k = torch.zeros(shape, dtype=dt, device=self.device)
        self._cache_v = torch.zeros(shape, dtype=dt, device=self.device)
        self._cfg = _ModelCfg(
            name=name, n_layers=L, num_heads=self.num_heads,
            head_dim=self.spec["head_dim"], kv_heads=self.spec["kv_heads"],
            pos_table=self.spec["pos_table"], swiglu=self.spec["swiglu"],
            tied=self.spec["tied"], rmsnorm=self.spec["rmsnorm"],
            window=self.window, block_size=self.block_size,
            paged_impl=resolve_paged_impl(self.block_size,
                                          self.spec["head_dim"],
                                          device=self.device))

    @property
    def paged_impl(self):
        """Decode attention's implementation: "cuda" or "torch"."""
        return self._cfg.paged_impl

    # -- public API ----------------------------------------------------------
    def submit(self, prompt, max_new_tokens=64, deadline_s=None,
               tenant=None, trace_id=None, handoff=False, temperature=None,
               top_p=None, top_k=None, n=1, logprobs=0, adapter_id=None):
        """Queue one generation request; returns its ``Request`` handle.

        Raises ``QueueFull`` when the admission queue is at capacity
        (back-pressure — retry later).  A request that could never fit
        (longer than ``max_model_len`` or the whole cache) is returned
        already REJECTED rather than queued to deadlock.  This engine is
        greedy-only: stochastic sampling params, ``logprobs``, ``n > 1``
        and ``adapter_id`` raise ``ValueError``, as on the reference's
        greedy engines."""
        if not self._alive:
            raise RuntimeError("engine is shut down")
        if ((temperature or 0.0) > 0.0 or (top_p is not None and top_p < 1.0)
                or top_k or logprobs):
            raise ValueError(
                "per-request sampling/logprobs require a sampling-mode "
                "engine, which is not ported yet (ROADMAP §A item 9)")
        if int(n) != 1:
            raise ValueError("n > 1 requires the prefix cache (ROADMAP §A "
                             "item 6)")
        if adapter_id is not None:
            raise ValueError("adapter_id requires an adapters-mode engine "
                             "(ROADMAP §A item 11)")
        req = Request(prompt, max_new_tokens, deadline_s=deadline_s,
                      tenant=tenant, handoff=handoff)
        if trace_id:
            req.trace_id = str(trace_id)
        if req.target_len() > self.max_model_len:
            self.scheduler._reject(req, "exceeds_max_len")
            return req
        try:
            return self.scheduler.submit(req)
        except QueueFull:
            self._stats.on_reject()      # back-pressure event counter
            raise

    def step(self):
        """One scheduler iteration: admit + prefill, then one batched
        decode.  Returns the number of tokens emitted."""
        if not self._alive:
            raise RuntimeError("engine is shut down")
        with torch.no_grad():
            return self._step_inner()

    def _step_inner(self):
        self._step_id += 1
        with telemetry.span("serve.step"):
            prefills, decodes = self.scheduler.schedule()
            # blocks for this iteration are all held right now — the
            # honest high-water sample
            self._stats.on_utilization(self.blocks.utilization())
            emitted = 0
            for req in prefills:
                emitted += self._run_prefill(req)
            if decodes:
                emitted += self._run_decode(decodes)
            if emitted == 0 and not prefills and not decodes:
                self._noop_steps += 1
                if self._noop_steps > 1000 and self.scheduler.has_work():
                    raise RuntimeError(
                        "scheduler stalled: work queued but 1000 consecutive "
                        "steps scheduled nothing (cache/queue misconfigured?)")
            else:
                self._noop_steps = 0
            self._stats.on_step(emitted, decode_batch=len(decodes))
        return emitted

    def has_work(self):
        """Whether ``step()`` still has anything to do."""
        return self.scheduler.has_work()

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
        """Cancel in-flight work and release the device cache and
        weights."""
        if not self._alive:
            return
        for req in (list(self.scheduler.running)
                    + list(self.scheduler.prefilling)):
            self.scheduler.finish(req, status=CANCELLED)
        for req in self.scheduler.drain_waiting():
            req.status = CANCELLED
            req.finish_t = self.clock()
        self._cache_k = self._cache_v = None
        self.params = None
        self._alive = False

    # -- execution -----------------------------------------------------------
    def _tensor(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _slots(self, table, n, pad_to):
        """(block, offset) scatter targets for logical slots [0, n),
        padded to ``pad_to`` with null-block writes."""
        blk = np.zeros(pad_to, np.int32)
        off = np.arange(pad_to, dtype=np.int32) % self.block_size
        pos = np.arange(n)
        blk[:n] = np.asarray(table, np.int32)[pos // self.block_size]
        return blk, off

    def _run_prefill(self, req):
        """Cold whole-prompt prefill of ``req`` (prompt plus, after a
        preemption, everything generated so far); emits its next
        token."""
        ids = req.prefill_ids()
        n = int(ids.size)
        if req.cache_len:
            raise RuntimeError("suffix prefill needs the prefix cache "
                               "(ROADMAP §A item 6)")
        bucket = _next_bucket(n, self.max_model_len)
        toks = np.zeros(bucket, np.int32)
        toks[:n] = ids
        blk, off = self._slots(self.blocks.table(req.rid), n, bucket)
        tok = _prefill(self._cfg, bucket, self.params, self._cache_k,
                       self._cache_v, self._tensor(toks), n,
                       self._tensor(blk), self._tensor(off))
        tok = int(tok)                 # the host needs the token: sync
        req.cache_len = n
        self._stats.on_prefill(n)
        self.blocks.note_tokens(req.rid, ids)
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
        self._maybe_finish(req)
        return 1

    def _run_decode(self, reqs):
        B = len(reqs)
        bucket = _next_bucket(B, self.max_batch)
        toks = np.zeros(bucket, np.int32)
        pos = np.zeros(bucket, np.int32)
        tables = np.zeros((bucket, self.table_width), np.int32)
        for i, req in enumerate(reqs):
            toks[i] = req.tokens[-1]
            pos[i] = req.cache_len
            t = self.blocks.table(req.rid)
            tables[i, :len(t)] = t
        out = _decode(self._cfg, self.params, self._cache_k, self._cache_v,
                      self._tensor(toks), self._tensor(pos),
                      self._tensor(tables))
        out = out.cpu().numpy()        # the host needs the tokens: sync
        self.decode_steps += 1
        now = self.clock()
        for i, req in enumerate(reqs):
            req.cache_len += 1
            req.tokens.append(int(out[i]))
            self._stats.on_tokens(req, 1, now=now)
            self._maybe_finish(req)
        return B

    def _maybe_finish(self, req):
        if len(req.tokens) >= req.max_new_tokens:
            self.scheduler.finish(req, status=FINISHED)
            self._stats.on_complete(req)


# -- program bodies (the reference's jit programs, run eagerly) --------------
def _mlp(cfg, params, p, x):
    h2 = _ln(x, params[f"{p}_ln2_gamma"],
             None if cfg.rmsnorm else params[f"{p}_ln2_beta"])
    if cfg.swiglu:
        g = _fc(h2, params[f"{p}_ff_gate_weight"], params[f"{p}_ff_gate_bias"])
        gf = g.float()                           # f32 silu == sym.silu
        up = ((gf * torch.sigmoid(gf)).to(g.dtype)
              * _fc(h2, params[f"{p}_ff_up_weight"],
                    params[f"{p}_ff_up_bias"]))
    else:
        up = _gelu(_fc(h2, params[f"{p}_ff_up_weight"],
                       params[f"{p}_ff_up_bias"]))
    return _fc(up, params[f"{p}_ff_down_weight"], params[f"{p}_ff_down_bias"])


def _logits(cfg, params, x):
    name = cfg.name
    final = _ln(x, params[f"{name}_ln_f_gamma"],
                None if cfg.rmsnorm else params[f"{name}_ln_f_beta"])
    if cfg.tied:
        return final @ params[f"{name}_tok_embed_weight"].t().to(final.dtype)
    return _fc(final, params[f"{name}_head_weight"],
               params[f"{name}_head_bias"])


def _qkv(cfg, params, p, x, n):
    h = _ln(x, params[f"{p}_ln1_gamma"],
            None if cfg.rmsnorm else params[f"{p}_ln1_beta"])
    q = _fc(h, params[f"{p}_q_weight"], params[f"{p}_q_bias"])
    k = _fc(h, params[f"{p}_k_weight"], params[f"{p}_k_bias"])
    v = _fc(h, params[f"{p}_v_weight"], params[f"{p}_v_bias"])
    return (q.reshape(n, cfg.num_heads, cfg.head_dim),
            k.reshape(n, cfg.kv_heads, cfg.head_dim),
            v.reshape(n, cfg.kv_heads, cfg.head_dim))


def _forward_token_batch(cfg, params, ck, cv, toks, pos, tables):
    """Shared decode math: write each row's K/V at its position (in
    place), attend through the block tables, return logits (B, V)."""
    name = cfg.name
    B = toks.shape[0]
    pos = pos.long()
    x = params[f"{name}_tok_embed_weight"][toks.long()]     # (B, D)
    if cfg.pos_table is not None:
        x = x + params[f"{name}_pos_embed_weight"][0, pos]
    blk = tables.long().gather(1, (pos // cfg.block_size)[:, None])[:, 0]
    off = pos % cfg.block_size
    ctx = (pos + 1).to(torch.int32)
    for i in range(cfg.n_layers):
        p = f"{name}_l{i}"
        qh, kh, vh = _qkv(cfg, params, p, x, B)
        if cfg.pos_table is None:
            qh, kh = _rope(qh, pos), _rope(kh, pos)
        # in-place writes: the reference's .at[].set on a donated cache
        ck[i].index_put_((blk, off), kh)
        cv[i].index_put_((blk, off), vh)
        attn = paged_attention(qh, ck[i], cv[i], tables, ctx,
                               window=cfg.window, impl=cfg.paged_impl)
        x = x + _fc(attn.reshape(B, cfg.num_heads * cfg.head_dim),
                    params[f"{p}_proj_weight"], params[f"{p}_proj_bias"])
        x = x + _mlp(cfg, params, p, x)
    return _logits(cfg, params, x)


def _decode(cfg, params, ck, cv, toks, pos, tables):
    """One batched decode step (the reference's ``_build_decode``
    program, greedy): returns the (B,) int32 next tokens."""
    logits = _forward_token_batch(cfg, params, ck, cv, toks, pos, tables)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _prefill(cfg, P, params, ck, cv, toks, plen, blk, off):
    """Whole-prompt pass at padded length P for ONE request (the
    reference's ``_build_prefill`` program, greedy): writes K/V for
    positions [0, P) through (blk, off) — padded rows land in the null
    block — and returns the token after position ``plen - 1``."""
    logits = _prefill_logits(cfg, P, params, ck, cv, toks, plen, blk, off)
    return torch.argmax(logits, dim=-1)[0]


def _prefill_logits(cfg, P, params, ck, cv, toks, plen, blk, off):
    """:func:`_prefill`'s body up to the (1, V) logits of position
    ``plen - 1``."""
    name = cfg.name
    Hq, Hkv, Dh = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    group = Hq // Hkv
    pos = torch.arange(P, device=toks.device)
    blk, off = blk.long(), off.long()
    x = params[f"{name}_tok_embed_weight"][toks.long()]     # (P, D)
    if cfg.pos_table is not None:
        x = x + params[f"{name}_pos_embed_weight"][0, :P]
    keep = pos[:, None] >= pos[None, :]                     # causal
    if cfg.window:
        keep = keep & (pos[:, None] - pos[None, :] < cfg.window)
    for i in range(cfg.n_layers):
        p = f"{name}_l{i}"
        qh, kh, vh = _qkv(cfg, params, p, x, P)
        if cfg.pos_table is None:
            qh, kh = _rope(qh, pos), _rope(kh, pos)
        ck[i].index_put_((blk, off), kh)
        cv[i].index_put_((blk, off), vh)
        # grouped-query dense causal attention within the prompt
        qg = qh.reshape(P, Hkv, group, Dh)
        sc = torch.einsum("qkgd,skd->kgqs", qg, kh) / math.sqrt(Dh)
        sc = sc.masked_fill(~keep, float("-inf"))
        pr = torch.softmax(sc.float(), dim=-1).to(x.dtype)
        at = torch.einsum("kgqs,skd->qkgd", pr, vh)
        x = x + _fc(at.reshape(P, Hq * Dh), params[f"{p}_proj_weight"],
                    params[f"{p}_proj_bias"])
        x = x + _mlp(cfg, params, p, x)
    return _logits(cfg, params, x[plen - 1][None])
