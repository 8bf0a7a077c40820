"""Draft-model speculative decoding for the serving engine.

The port of ``mxnet_tpu/serve/spec.py``.  Plain decode
emits ONE token per running request per iteration.  With ``spec_k = k``
an iteration instead runs

  1 draft program   (``k+1`` single-token steps of a small draft model,
                     unrolled in one program: one CUDA graph on CUDA)
  1 verify program  (the target model over ``k+1`` rows per request,
                     write-then-attend through the paged block table)

and emits between 1 and ``k+1`` tokens per request.  Greedy acceptance
keeps the longest prefix of drafted tokens the target's argmax agrees
with, plus the target's own token at the first disagreement, so the
emitted stream is token-identical to plain decode: the target's argmax
decides every token, the draft only how many arrive per dispatch.  The
drafted ids come back to the host between the two programs, as in the
reference.

On a sampling engine the draft samples each proposal from its warped
distribution q and returns q in candidate space (the drawn token's
q(x) and the ``sample_cap`` candidates' probabilities and ids); the host
stages them into the verify program, which accepts draft j with
probability ``min(1, p(x_j)/q(x_j))``, resamples the first rejection
from the normalized residual ``max(p - q, 0)`` and draws a bonus token
from the last row's p when all are accepted (rejection sampling,
Leviathan et al. 2023): the emitted stream is distributed as plain
sampling from p.  Greedy rows (one-hot p and q) accept the agreeing
prefix exactly.

:class:`DraftWorker` owns the draft side: its parameters on the engine's
device, its own K/V cache pair (floating point even when the target's is
int8) with the target's block geometry, and the per-request ingest
ledger.  The draft shares the target's per-request block tables
verbatim; the target's ``BlockManager`` keeps them disjoint.  Draft-cache
contents move only the acceptance rate, never a token, so the draft may
re-ingest context lazily (admission, resume after preemption, a
prefix-cache hit's shared blocks).

Rollback: verify writes target K/V for all ``k+1`` candidate positions;
the engine then truncates the request's table to the accepted length
(``BlockManager.truncate``).  Stale K/V inside kept blocks is rewritten
before any later position reads it.
"""

from __future__ import annotations

import collections
import threading

import torch

from ..base import env_float
from ..convert import params_from_numpy
from ..models.generate import (detect_gpt_variant, normalize_gpt_params,
                               reconcile_decode_config)
from ..ops.attention import resolve_paged_impl
from ..telemetry import flight as flight_mod

__all__ = ["DraftWorker", "accept_greedy", "ENV_SPEC", "ENV_MIN_ACCEPT"]

ENV_SPEC = "MXTPU_SERVE_SPEC"
ENV_MIN_ACCEPT = "MXTPU_SPEC_MIN_ACCEPT"

# rolling acceptance-rate window length (verify events); the low-
# acceptance dump waits for MIN_WINDOW events before judging
WINDOW = 256
MIN_WINDOW = 32


class DraftWorker:
    """The draft-model half of speculative decoding.

    Owns the draft checkpoint's parameters (``params_from_numpy`` on the
    engine's device, in the engine's ``dtype``) and its K/V cache pair
    ``(draft_layers, num_blocks, block_size, draft_kv_heads,
    draft_head_dim)``.  Its programs are the engine's ``_Program``\\ s of
    kinds ``draft`` (the k-step proposal loop, over decode-batch buckets)
    and ``draft_chunk`` (context ingest: the chunk body over the draft
    config).  The ingest ledger and the acceptance window are guarded by
    a lock, as in the reference (statusz scrapes read them from other
    threads).
    """

    def __init__(self, engine, params, num_heads=None, window=None,
                 name="gpt", dtype=None, symbol=None):
        if symbol is not None:
            num_heads, window = reconcile_decode_config(symbol, num_heads,
                                                        window)
        if num_heads is None:
            raise ValueError(
                "draft num_heads is required (pass draft_num_heads=, or "
                "draft_symbol= to read it from the draft's trained graph)")
        window = 0 if window is None else int(window)
        if window < 0:
            raise ValueError(f"draft window must be >= 0 (got {window})")
        params = normalize_gpt_params(params, name)
        spec = detect_gpt_variant(params, num_heads, name)
        if spec["vocab"] != engine.spec["vocab"]:
            raise ValueError(
                f"draft vocab ({spec['vocab']}) must match the target's "
                f"({engine.spec['vocab']}) — drafted token ids feed the "
                "target verify program directly")
        if (spec["pos_table"] is not None
                and spec["pos_table"] < engine.max_model_len):
            raise ValueError(
                f"draft positional table ({spec['pos_table']}) is shorter "
                f"than max_model_len ({engine.max_model_len}) — the draft "
                "must be able to read every position the target serves")
        from .engine import _ModelCfg

        self.name = name
        # the draft cache stays floating point under kv_dtype="int8": it
        # is small by design, and its contents move only acceptance
        self.cfg = _ModelCfg(
            name=name, n_layers=spec["n_layers"], num_heads=int(num_heads),
            head_dim=spec["head_dim"], kv_heads=spec["kv_heads"],
            pos_table=spec["pos_table"], swiglu=spec["swiglu"],
            tied=spec["tied"], rmsnorm=spec["rmsnorm"], window=window,
            block_size=engine.block_size, kv_quant=False,
            paged_impl=resolve_paged_impl(engine.block_size,
                                          spec["head_dim"],
                                          device=engine.device))
        self.params = params_from_numpy(params, engine.device, dtype=dtype,
                                        name=name)
        dt = self.params[f"{name}_tok_embed_weight"].dtype
        shape = (spec["n_layers"], engine.num_blocks, engine.block_size,
                 spec["kv_heads"], spec["head_dim"])
        self.cache_k = torch.zeros(shape, dtype=dt, device=engine.device)
        self.cache_v = torch.zeros(shape, dtype=dt, device=engine.device)
        self.min_accept = env_float(ENV_MIN_ACCEPT, 0.0)
        self._lock = threading.Lock()
        # rid -> (preemption epoch, draft-valid positions): which prefix
        # of the request's context the draft cache holds.  A resume by
        # recomputation bumps the epoch and forces a full re-ingest into
        # the request's new block table.
        self._valid = {}                          # guarded-by: _lock
        # rolling (k, accepted) per verify
        self._window = collections.deque(maxlen=WINDOW)  # guarded-by: _lock

    # -- context ingest ------------------------------------------------------
    def context_gap(self, req):
        """Positions ``[0, req.cache_len)`` the draft cache does NOT yet
        hold for ``req`` (0 when drafting can start right away)."""
        with self._lock:
            state = self._valid.get(req.rid)
        if (state is not None and state[0] == req.n_preemptions
                and state[1] >= req.cache_len):
            return 0
        return int(req.cache_len)

    def note_ingested(self, req, n_positions):
        with self._lock:
            self._valid[req.rid] = (req.n_preemptions, int(n_positions))

    def note_drafted(self, req, n_positions):
        """The draft program just wrote K/V through ``n_positions`` (the
        k-step loop writes every candidate position, so the next
        iteration has no ingest gap whatever was accepted)."""
        self.note_ingested(req, n_positions)

    def forget(self, rid):
        """The request left the engine: drop its ledger entry."""
        with self._lock:
            self._valid.pop(rid, None)

    def prune(self, live_rids):
        """Drop ledger entries of rids no longer running (requests that
        left between decode iterations never pass :meth:`forget`)."""
        with self._lock:
            for rid in [r for r in self._valid if r not in live_rids]:
                del self._valid[rid]

    # -- acceptance accounting ----------------------------------------------
    def on_verify(self, k, accepted):
        """One verify pass proposed ``k`` tokens and the target accepted
        ``accepted``.  Feeds the rolling window; when the windowed rate
        sits below ``MXTPU_SPEC_MIN_ACCEPT`` (after ``MIN_WINDOW``
        verifies) the flight recorder dumps ``spec_low_acceptance``
        (rate-limited per reason, to ``MXTPU_FLIGHT_DIR``)."""
        with self._lock:
            self._window.append((int(k), int(accepted)))
            rate = self._window_rate_locked()
            n = len(self._window)
        if (self.min_accept > 0.0 and n >= MIN_WINDOW
                and rate is not None and rate < self.min_accept):
            flight_mod.recorder().dump(
                "spec_low_acceptance",
                extra={"accept_rate": round(rate, 4),
                       "threshold": self.min_accept, "window": n})

    def _window_rate_locked(self):
        drafted = sum(k for k, _ in self._window)
        if not drafted:
            return None
        return sum(a for _, a in self._window) / drafted

    def accept_rate_window(self):
        """Acceptance rate over the rolling window (None before any
        verify)."""
        with self._lock:
            rate = self._window_rate_locked()
        return None if rate is None else round(rate, 4)

    # -- introspection -------------------------------------------------------
    def statusz(self, engine):
        """The engine's ``/statusz`` ``spec`` section (host reads only:
        byte counts are tensor metadata)."""
        cfg = self.cfg
        with self._lock:
            window_n = len(self._window)
            rate = self._window_rate_locked()
            tracked = len(self._valid)
        rate_greedy, rate_stochastic = engine._stats.spec_mode_rates()
        return {
            "k": engine.spec_k,
            "accept_rate_greedy": rate_greedy,
            "accept_rate_stochastic": rate_stochastic,
            "draft": {
                "name": self.name,
                "n_layers": cfg.n_layers,
                "d_model": cfg.num_heads * cfg.head_dim,
                "kv_heads": cfg.kv_heads,
                "params_bytes": sum(int(v.nbytes)
                                    for v in self.params.values()),
                "kv_cache_bytes": 2 * int(self.cache_k.nbytes),
            },
            "accept_rate_window": (None if rate is None
                                   else round(rate, 4)),
            "window_verifies": window_n,
            "min_accept": self.min_accept,
            "tracked_requests": tracked,
            "verify_buckets": engine.verify_buckets(),
        }

    def shutdown(self):
        """Release the draft's parameters and cache."""
        self.cache_k = self.cache_v = None
        self.params = None
        with self._lock:
            self._valid.clear()


# -- acceptance rule (host side) ---------------------------------------------
def accept_greedy(drafted_row, target_row, k):
    """Greedy acceptance for one request: ``drafted_row`` holds the k
    drafted tokens, ``target_row`` the target's k+1 argmax tokens (row j
    scored after consuming row j's input).  Returns ``(accepted,
    emit)``: the agreeing-prefix length and the tokens to emit — the
    accepted drafts plus the target's own token at the first
    disagreement (or its bonus token when everything agreed)."""
    a = 0
    while a < k and int(drafted_row[a]) == int(target_row[a]):
        a += 1
    return a, [int(x) for x in drafted_row[:a]] + [int(target_row[a])]


# -- program bodies ------------------------------------------------------------
# Device tensors in, one device tensor out, no host read (a capture
# forbids one); caches written in place.
def _rope_rows(u, pos):
    """RoPE over arbitrary leading dims: flatten the rows, rotate each
    by its own position, restore the shape."""
    from .engine import _rope

    flat = u.reshape((-1,) + tuple(u.shape[-2:]))
    return _rope(flat, pos.reshape(-1)).reshape(u.shape)


def _draft(cfg, k, toks, pos, tables, *, params, ck, cv, ksc=None,
           vsc=None):
    """The k-step draft proposal (the reference's ``_build_draft``,
    greedy): ``k+1`` single-token steps of the draft model.  Step ``j``
    writes the fed token's K/V at ``pos + j`` through the shared block
    table and attends through ``paged_attention``; its argmax feeds step
    ``j + 1``.  A step past the table's last slot gets a zeroed table
    row (computed on the device), so it writes into the null block
    instead of aliasing the request's last block.  Steps ``0..k-1``
    give the (B, k) int32 drafts; step ``k`` only parks the last draft's
    K/V (its head is skipped), so the next iteration has no ingest gap.
    The draft cache is never quantized (``ksc``/``vsc`` unused)."""
    from .engine import _logits, _token_layers

    S = tables.shape[1] * cfg.block_size
    zero = torch.zeros((), dtype=tables.dtype, device=tables.device)
    cur, outs = toks, []
    for j in range(k + 1):
        tbl = torch.where((pos + j < S)[:, None], tables, zero)
        x = _token_layers(cfg, params, ck, cv, cur, pos + j, tbl)
        if j < k:
            cur = torch.argmax(_logits(cfg, params, x),
                               dim=-1).to(torch.int32)
            outs.append(cur)
    return torch.stack(outs, dim=1)


def _draft_rs(cfg, k, cap, toks, pos, tables, temp, topp, topk, seed, *,
              params, ck, cv, ksc=None, vsc=None):
    """The sampling engine's draft (the reference's ``draft_rs``): as
    :func:`_draft`, but step ``j`` samples its proposal from the draft's
    warped distribution q (the target's per-row temperature, top-p and
    top-k, candidate width ``cap``) and keeps that q.  Returns the
    drafts (B, k) int32, q of each draft (B, k), and the candidates'
    probabilities (B, k, cap) and vocab ids (B, k, cap) int32."""
    from .engine import _DRAFT, _draw, _filter_logits, _logits, _token_layers

    scfg = cfg._replace(sample_cap=cap)
    S = tables.shape[1] * cfg.block_size
    zero = torch.zeros((), dtype=tables.dtype, device=tables.device)
    cur, outs, q_at, q_vals, q_idx = toks, [], [], [], []
    for j in range(k + 1):
        tbl = torch.where((pos + j < S)[:, None], tables, zero)
        x = _token_layers(cfg, params, ck, cv, cur, pos + j, tbl)
        if j < k:
            masked, idx = _filter_logits(scfg, _logits(cfg, params, x),
                                         temp, topp, topk)
            probs = torch.softmax(masked, dim=-1)
            choice = _draw(masked, seed, _DRAFT + j)[:, None]
            cur = idx.gather(1, choice)[:, 0].to(torch.int32)
            outs.append(cur)
            q_at.append(probs.gather(1, choice)[:, 0])
            q_vals.append(probs)
            q_idx.append(idx.to(torch.int32))
    return (torch.stack(outs, dim=1), torch.stack(q_at, dim=1),
            torch.stack(q_vals, dim=1), torch.stack(q_idx, dim=1))


def _verify(cfg, k, rows, pos0, tables, *, params, ck, cv, ksc=None,
            vsc=None, adp=None, slots=None):
    """The target's verify pass (the reference's ``_build_verify``,
    greedy): ``rows`` (B, k+1) holds each request's last token and its k
    drafts.  Returns the (B, k+1) int32 argmax, row j's token decided
    after consuming rows 0..j.  ``adp``/``slots``: the adapter stacks
    and each request's slot (adapters mode).  Under
    ``cfg.numeric_watch``, also the logits-finite flag."""
    from .engine import _watch

    logits = _verify_logits(cfg, k, rows, pos0, tables, params, ck, cv,
                            ksc, vsc, adp, slots)
    return _watch(cfg, torch.argmax(logits, dim=-1).to(torch.int32),
                  logits)


def _verify_rs(cfg, k, toks, drafted, q_at, q_vals, q_idx, pos0, tables,
               temp, topp, topk, seed, *, params, ck, cv, ksc=None,
               vsc=None, adp=None, slots=None):
    """The sampling engine's verify (the reference's ``_build_verify``
    in sampling mode): the target scores ``toks`` and the drafts, then
    accepts by rejection sampling in candidate space (never vocab-wide).
    Draft j is accepted when ``u * q(x_j) < p(x_j)``; the first
    rejection is resampled from the normalized residual ``max(p - q,
    0)`` over the target's candidates (q read at them by id); a run with
    every draft accepted adds a bonus token from the last row's p.
    Returns the emit rows (B, k+1), accepted counts (B,), and the
    emitted rows' logprob outputs (chosen (B, k+1), top values and ids
    (B, k+1, TOP_LOGPROBS)); under ``cfg.numeric_watch`` also the
    logits-finite flag."""
    from .engine import (_ACCEPT, _BONUS, _RESIDUAL, _draw, _filter_logits,
                         _logprob_outs, _safe_log, _watch)
    from ..models.generate import _uniform

    K1 = k + 1
    rows = torch.cat([toks[:, None], drafted], dim=1)
    logits = _verify_logits(cfg, k, rows, pos0, tables, params, ck, cv, ksc,
                            vsc, adp, slots)                 # (B, K1, V)
    masked_p, idx_p = _filter_logits(cfg, logits, temp[:, None],
                                     topp[:, None], topk[:, None])
    p_cand = torch.softmax(masked_p, dim=-1)                 # (B, K1, cap)
    idx_k = idx_p[:, :k]                                     # (B, k, cap)
    dr = drafted.long()
    # p(x_j): the draft's token under the target's filtered p (0 outside
    # the target's candidates); q(x_j) came from the draft
    p_at = torch.where(idx_k == dr[..., None], p_cand[:, :k],
                       torch.zeros((), device=logits.device)).sum(-1)
    u = _uniform(seed, _ACCEPT, dr.shape, logits.device)
    accept = u * q_at < p_at
    acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)   # (B,)
    # q at the target's candidate ids, by id (ids unique a row)
    q_cand = torch.where(idx_k[..., :, None] == q_idx.long()[..., None, :],
                         q_vals[..., None, :],
                         torch.zeros((), device=logits.device)).sum(-1)
    res = (p_cand[:, :k] - q_cand).clamp(min=0.0)
    rsum = res.sum(dim=-1, keepdim=True)
    # an all-zero residual means p == q there: acceptance was certain,
    # the row is never read; p keeps the draw well defined
    res = torch.where(rsum > 0, res / rsum.clamp(min=1e-38), p_cand[:, :k])
    corr_c = _draw(_safe_log(res), seed, _RESIDUAL)          # (B, k)
    corr = idx_k.gather(-1, corr_c[..., None])[..., 0]
    bonus_c = _draw(masked_p[:, K1 - 1], seed, _BONUS)       # (B,)
    bonus = idx_p[:, K1 - 1].gather(-1, bonus_c[:, None])[:, 0]
    first_rej = acc.clamp(max=K1 - 2)
    corr_at = corr.gather(1, first_rej[:, None].long())[:, 0]
    fixed = torch.where(acc < K1 - 1, corr_at, bonus)
    jj = torch.arange(K1, device=logits.device)[None, :]
    pad = torch.cat([dr, torch.zeros_like(dr[:, :1])], dim=1)
    emit = torch.where(jj < acc[:, None], pad,
                       fixed[:, None]).to(torch.int32)
    return _watch(cfg, (emit, acc.to(torch.int32))
                  + _logprob_outs(logits, emit), logits)


def _verify_logits(cfg, k, rows, pos0, tables, params, ck, cv, ksc, vsc,
                   adp=None, slots=None):
    """The verify pass's body up to its (B, k+1, V) logits: ``rows``
    holds each request's last token and its k drafts at positions
    ``pos0 .. pos0 + k``.  Every row's K/V is written FIRST (int8 with
    scales under ``cfg.kv_quant``); a row past the table (``pos >= S``)
    writes into the null block.  Then each layer gathers each request's
    whole table once and masks it per row by position (and window):
    in-window causality is exact without a dense score matrix.  Under
    tp each shard writes and attends over its own heads and cache."""
    from .engine import (_embed, _joined, _kv_dequant, _logits, _mlp,
                         _proj, _qkv, _shard, _write_kv)

    name = cfg.name
    Dh, bs = cfg.head_dim, cfg.block_size
    group = cfg.num_heads // cfg.kv_heads
    B, K1 = rows.shape
    dev = rows.device
    pos = pos0.long()[:, None] + torch.arange(K1, device=dev)[None, :]
    # rows past the table are clamped: their outputs are dropped
    x = _embed(cfg, params, rows, pos)                    # (B, K1, D)
    tables = tables.long()
    W = tables.shape[1]
    S = W * bs
    bidx = (pos // bs).clamp(max=W - 1)
    blk = torch.where(pos < S, tables.gather(1, bidx),
                      torch.zeros((), dtype=torch.long, device=dev))
    off = pos % bs
    spos = torch.arange(S, device=dev)[None, None, :]
    keep = spos <= pos[:, :, None]                        # (B, K1, S)
    if cfg.window:
        keep = keep & (spos > pos[:, :, None] - cfg.window)
    keep = keep[:, None, None]                            # (B, 1, 1, K1, S)
    scale = 1.0 / (Dh ** 0.5)
    for i in range(cfg.n_layers):
        p = f"{name}_l{i}"
        outs = []
        for s, (qh, kh, vh) in enumerate(_qkv(cfg, params, p, x, (B, K1),
                                              adp, slots)):
            if cfg.pos_table is None:
                qh, kh = _rope_rows(qh, pos), _rope_rows(kh, pos)
            sk, sv = _shard(ck, s), _shard(cv, s)
            sks = svs = None
            if cfg.kv_quant:
                sks, svs = _shard(ksc, s), _shard(vsc, s)
            Hkv = kh.shape[2]
            _write_kv(cfg, i, sk, sv, sks, svs, blk, off, kh, vh)
            kb = sk[i][tables].reshape(B, S, Hkv, Dh)
            vb = sv[i][tables].reshape(B, S, Hkv, Dh)
            if cfg.kv_quant:
                kb = _kv_dequant(kb, sks[i][tables].reshape(B, S, Hkv),
                                 x.dtype)
                vb = _kv_dequant(vb, svs[i][tables].reshape(B, S, Hkv),
                                 x.dtype)
            qg = qh.reshape(B, K1, Hkv, group, Dh)
            sc = torch.einsum("bckgd,bskd->bkgcs", qg, kb) * scale
            sc = sc.masked_fill(~keep, float("-inf"))
            pr = torch.softmax(sc.float(), dim=-1).to(x.dtype)
            at = torch.einsum("bkgcs,bskd->bckgd", pr, vb)
            outs.append(at.reshape(B, K1, Hkv * group * Dh))
        x = x + _joined(_proj(cfg, params, adp, f"{p}_proj", outs, slots))
        x = x + _mlp(cfg, params, p, x, adp, slots)
    return _logits(cfg, params, x)
