"""Serving observability: counters + the ``ServeStats`` snapshot.

The port's copy of ``mxnet_tpu/serve/stats.py``; its telemetry bridge
feeds the port's registry (no-op objects while telemetry is off).

The engine owns one ``StatsRecorder`` and stamps it from the serving
loop; ``snapshot()`` freezes the current view into an immutable
``ServeStats`` for dashboards, ``tools/serve_bench.py``'s JSON record,
and the periodic ``mxnet_tpu.monitor.ServeMonitor`` log line (the
serving-side analog of ``Speedometer``'s samples/sec callback).

Tokens/sec is reported two ways: ``decode_tok_per_sec`` over a sliding
window of recent steps (the live rate a dashboard wants) and
``total_tok_per_sec`` over the engine's whole life (the benchmark
aggregate).
"""

from __future__ import annotations

import random
import time
from collections import deque
from dataclasses import asdict, dataclass, field

from .. import telemetry

__all__ = ["ServeStats", "StatsRecorder", "Reservoir"]


class Reservoir:
    """Bounded uniform sample of a stream (Vitter's algorithm R) with
    EXACT running count/sum/max — so means and maxima never degrade
    while the percentile view stays O(capacity) memory however long
    the engine serves.  Seeded RNG: two engines fed identical streams
    report identical percentiles (deterministic tests).

    Not locked: every writer is the engine step thread (the same
    single-writer discipline as the rest of StatsRecorder); snapshot
    readers copy under the GIL."""

    __slots__ = ("capacity", "_sample", "_rng", "count", "sum", "max")

    def __init__(self, capacity=2048, seed=0):
        self.capacity = max(1, int(capacity))
        self._sample = []
        self._rng = random.Random(seed)
        self.count = 0
        self.sum = 0.0
        self.max = None

    def add(self, value):
        value = float(value)
        self.count += 1
        self.sum += value
        if self.max is None or value > self.max:
            self.max = value
        if len(self._sample) < self.capacity:
            self._sample.append(value)
        else:
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self._sample[j] = value

    @property
    def mean(self):
        return self.sum / self.count if self.count else None

    def percentile(self, q):
        """Nearest-rank percentile of the retained sample (exact until
        ``count`` exceeds ``capacity``, a uniform estimate after)."""
        from ..telemetry.timeseries import nearest_rank

        return nearest_rank(sorted(self._sample), q)


@dataclass(frozen=True)
class ServeStats:
    """One immutable snapshot of the serving engine."""
    steps: int
    queue_depth: int
    running: int
    completed: int
    rejected: int
    preemptions: int
    evictions: int
    tokens_generated: int
    prompt_tokens: int
    blocks_in_use: int
    blocks_total: int
    block_utilization: float           # right now
    peak_block_utilization: float      # high-water mark across steps
    ttft_ms_mean: float | None
    ttft_ms_max: float | None
    decode_tok_per_sec: float | None   # sliding window over recent steps
    total_tok_per_sec: float | None    # engine lifetime aggregate
    # prefix-cache view (BlockManager.prefix_stats): prompt tokens the
    # engine actually ran prefill compute over vs tokens whose K/V was
    # reused from the content-addressed radix cache — the shared-prefix
    # workload's headline ratio (tools/serve_bench.py --workload
    # shared-prefix)
    prefill_tokens_computed: int = 0
    prefix_hits: int = 0
    prefix_misses: int = 0
    # hits whose first reused block was sitting on the evictable LRU
    # (refcount 0) — reuse that only exists because eviction had not
    # reached it yet; split out from plain hits so cache-route benches
    # can tell "still referenced" from "brought back from the brink"
    prefix_resurrections: int = 0
    prefix_hit_rate: float | None = None
    prefix_tokens_saved: int = 0
    prefix_evictions: int = 0
    # tokens whose cached K/V eviction threw away for good (device
    # discards plus the host tier's own final evictions) — the
    # recompute debt the DRAM offload tier exists to drive down
    prefix_discarded_tokens: int = 0
    # host-DRAM offload tier (BlockManager.host / HostKVPool): lookups
    # that restored at least one parked block, the restored token
    # total, and the pool's live occupancy.  All zero with the tier
    # off (MXTPU_SERVE_HOST_KV_BYTES=0).
    host_kv_hits: int = 0
    host_kv_restored_tokens: int = 0
    host_kv_offloads: int = 0
    host_kv_evictions: int = 0
    host_kv_degraded: int = 0
    # pool inserts rejected for size (offloads AND handoff imports —
    # a decode-role replica whose pool rejects ingests re-pays the
    # prefill compute the handoff was meant to ship)
    host_kv_rejects: int = 0
    host_kv_bytes_used: int = 0
    host_kv_entries: int = 0
    # speculative decoding (serve/spec.py): draft-proposed tokens and
    # the target's accept/reject split, plus the per-verify mean run
    # length and lifetime acceptance rate.  Zero/None with spec off.
    # tokens_generated and the tok/s rates above are fed from ACTUAL
    # emitted-token counts per iteration, so they stay correct when a
    # verify step emits up to k+1 tokens per request.
    spec_drafted_tokens: int = 0
    spec_accepted_tokens: int = 0
    spec_rejected_tokens: int = 0
    spec_verifies: int = 0
    accepted_per_verify: float | None = None
    spec_accept_rate: float | None = None
    # the greedy-vs-stochastic acceptance split: rejection-sampled
    # (temperature>0) verifies accept by min(1, p/q) while greedy ones
    # accept by exact argmax match, and a draft can diverge on one
    # class of traffic while looking healthy on the other.  Stochastic
    # raw counts ride along (greedy = total - stochastic).
    spec_drafted_tokens_stochastic: int = 0
    spec_accepted_tokens_stochastic: int = 0
    spec_accept_rate_greedy: float | None = None
    spec_accept_rate_stochastic: float | None = None
    # tail latency (bounded-reservoir percentiles — the SLO inputs):
    # TTFT is submit -> first token; TPOT (time-per-output-token /
    # inter-token latency) is the gap between consecutive token
    # emissions for one request, divided by the tokens the step
    # emitted (so a speculative verify's k+1-token step contributes
    # k+1 honest per-token observations, not one giant gap)
    ttft_ms_p50: float | None = None
    ttft_ms_p90: float | None = None
    ttft_ms_p99: float | None = None
    tpot_ms_mean: float | None = None
    tpot_ms_p50: float | None = None
    tpot_ms_p90: float | None = None
    tpot_ms_p99: float | None = None
    # mean decode-batch occupancy over the recent-step window (decode
    # slots scheduled / max_batch) — slot-based, so it stays honest
    # whatever the per-slot token yield is
    decode_occupancy: float | None = None
    # cumulative rejections by reason code (queue_full / deadline /
    # deadline_at_submit / tenant_share / exceeds_cache /
    # exceeds_max_len) — the same codes the request trace and
    # mxtpu_serve_rejections_total{reason} carry
    reject_reasons: dict = field(default_factory=dict)
    # per-tenant admission/outcome/latency table
    # (Scheduler.tenant_stats) — empty until requests carry tenants
    tenants: dict = field(default_factory=dict)
    # per-adapter goodput ({adapter_id: {completed, tokens}}) — empty
    # until requests carry adapter ids (the fleet catalog's per-model
    # traffic ground truth)
    adapters: dict = field(default_factory=dict)

    def as_dict(self):
        return asdict(self)


def _pct_ms(res, q):
    v = res.percentile(q)
    return None if v is None else round(v * 1e3, 3)


class StatsRecorder:
    def __init__(self, clock=time.monotonic, window_steps=64):
        self.clock = clock
        self.steps = 0
        self.completed = 0
        self.rejected = 0
        self.tokens_generated = 0
        self.prompt_tokens = 0
        self.prefill_tokens_computed = 0
        # bounded tail-latency reservoirs (mean/max stay exact): the
        # unbounded per-request TTFT list a long-lived replica would
        # otherwise grow is exactly what these replace
        self._ttft_res = Reservoir()
        self._tpot_res = Reservoir(seed=1)
        self._start_t = None
        self.peak_block_utilization = 0.0
        # (t, tokens_emitted) per step for the sliding-window rate
        self._window = deque(maxlen=window_steps)
        # telemetry bridge: every recorder event ALSO feeds the
        # process-wide registry, so ServeStats and the Prometheus
        # exposition agree by construction (no-op objects when
        # MXTPU_TELEMETRY is unset)
        self._m_steps = telemetry.counter(
            "mxtpu_serve_steps_total", "engine scheduler iterations")
        self._m_tokens = telemetry.counter(
            "mxtpu_serve_tokens_generated_total", "decode tokens emitted")
        self._m_completed = telemetry.counter(
            "mxtpu_serve_completed_total", "requests finished")
        self._m_prompt_tokens = telemetry.counter(
            "mxtpu_serve_prompt_tokens_total",
            "prompt tokens of completed requests")
        self._m_rejected = telemetry.counter(
            "mxtpu_serve_backpressure_rejects_total",
            "submits rejected by admission-queue back-pressure")
        self._m_ttft = telemetry.histogram(
            "mxtpu_serve_ttft_seconds", "time to first token")
        self._m_tpot = telemetry.histogram(
            "mxtpu_serve_tpot_seconds",
            "inter-token latency (per emitted token)")
        self._m_prefill_tokens = telemetry.counter(
            "mxtpu_serve_prefill_tokens_computed_total",
            "prompt tokens actually run through a prefill program "
            "(prefix-cache hits never reach here)")
        # speculative decoding: the draft/accept/reject token split —
        # agrees with ServeStats.spec_* by construction (one feed)
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_rejected_tokens = 0
        self.spec_verifies = 0
        # the greedy-vs-stochastic split (rejection-sampled verifies
        # vs exact argmax ones) — same single feed as the totals
        self.spec_drafted_tokens_stochastic = 0
        self.spec_accepted_tokens_stochastic = 0
        self._m_spec_mode_drafted = telemetry.counter(
            "mxtpu_serve_spec_mode_drafted_tokens_total",
            "draft-model tokens proposed, split by sampling mode",
            ("mode",))
        self._m_spec_mode_accepted = telemetry.counter(
            "mxtpu_serve_spec_mode_accepted_tokens_total",
            "accepted drafted tokens, split by sampling mode",
            ("mode",))
        self._m_spec_drafted = telemetry.counter(
            "mxtpu_serve_spec_drafted_tokens_total",
            "draft-model tokens proposed to the verify program")
        self._m_spec_accepted = telemetry.counter(
            "mxtpu_serve_spec_accepted_tokens_total",
            "drafted tokens the target model accepted")
        self._m_spec_rejected = telemetry.counter(
            "mxtpu_serve_spec_rejected_tokens_total",
            "drafted tokens the target model rejected")
        # per-adapter goodput: rows appear only for requests that
        # carried an adapter id, so adapter-less serving keeps the
        # historical snapshot/registry shape
        self.adapters = {}
        self._m_adapter_completed = telemetry.counter(
            "mxtpu_serve_adapter_completed_total",
            "completed requests by LoRA adapter", ("adapter",))
        self._m_adapter_tokens = telemetry.counter(
            "mxtpu_serve_adapter_tokens_total",
            "decode tokens emitted by LoRA adapter", ("adapter",))

    def on_verify(self, drafted, accepted, stochastic=False):
        """One speculative verify pass: ``drafted`` tokens proposed,
        ``accepted`` of them kept (the +1 corrected/bonus token is
        counted by ``on_step``'s emitted total, not here).
        ``stochastic`` marks a rejection-sampled (temperature>0)
        verify — the per-mode split rides the same single feed."""
        drafted, accepted = int(drafted), int(accepted)
        self.spec_verifies += 1
        self.spec_drafted_tokens += drafted
        self.spec_accepted_tokens += accepted
        self.spec_rejected_tokens += drafted - accepted
        if stochastic:
            self.spec_drafted_tokens_stochastic += drafted
            self.spec_accepted_tokens_stochastic += accepted
        mode = "stochastic" if stochastic else "greedy"
        if drafted:
            self._m_spec_mode_drafted.labels(mode=mode).inc(drafted)
        if accepted:
            self._m_spec_mode_accepted.labels(mode=mode).inc(accepted)
        self._m_spec_drafted.inc(drafted)
        if accepted:
            self._m_spec_accepted.inc(accepted)
        if drafted - accepted:
            self._m_spec_rejected.inc(drafted - accepted)

    def spec_mode_rates(self):
        """(greedy, stochastic) acceptance rates — the ONE formula
        both ``snapshot()`` and the statusz ``spec`` section read, so
        the two views cannot drift (None with no drafted tokens in
        that mode)."""
        drafted_g = (self.spec_drafted_tokens
                     - self.spec_drafted_tokens_stochastic)
        accepted_g = (self.spec_accepted_tokens
                      - self.spec_accepted_tokens_stochastic)
        greedy = round(accepted_g / drafted_g, 4) if drafted_g else None
        stochastic = (
            round(self.spec_accepted_tokens_stochastic
                  / self.spec_drafted_tokens_stochastic, 4)
            if self.spec_drafted_tokens_stochastic else None)
        return greedy, stochastic

    def on_prefill(self, tokens_computed):
        """One prefill pass (whole prompt, suffix, or one chunk) ran
        compute over ``tokens_computed`` prompt tokens."""
        self.prefill_tokens_computed += int(tokens_computed)
        self._m_prefill_tokens.inc(int(tokens_computed))

    def on_step(self, new_tokens, decode_batch=0):
        """One engine iteration emitted ``new_tokens`` tokens (the
        ACTUAL count — a speculative verify step contributes up to
        ``k+1`` per request) with ``decode_batch`` decode slots
        scheduled."""
        now = self.clock()
        if self._start_t is None:
            self._start_t = now
        self.steps += 1
        self.tokens_generated += new_tokens
        self._window.append((now, new_tokens, int(decode_batch)))
        self._m_steps.inc()
        if new_tokens:
            self._m_tokens.inc(new_tokens)

    def on_utilization(self, frac):
        """Stamp the cache high-water mark (the engine samples right
        after scheduling, when this step's blocks are all held —
        sampling after a drain would always read ~0)."""
        if frac > self.peak_block_utilization:
            self.peak_block_utilization = frac

    def on_first_token(self, ttft_s):
        self._ttft_res.add(ttft_s)
        self._m_ttft.observe(ttft_s)

    def on_tokens(self, req, n, now=None):
        """``n`` decode tokens just landed on ``req``: record their
        per-token gap (TPOT) since the request's previous emission.
        The first token has no gap — it is the TTFT observation — so
        callers invoke this only from the second emission on (the
        engine stamps ``_last_token_t`` at the first)."""
        if n < 1:
            return
        now = self.clock() if now is None else now
        last = getattr(req, "_last_token_t", None)
        if last is None:
            last = req.first_token_t
        req._last_token_t = now
        if last is None:
            return
        gap = max(0.0, (now - last) / n)
        # the histogram is per EMITTED token, like the reservoir: a
        # k+1-token speculative verify contributes k+1 observations to
        # BOTH, or the registry-derived TPOT would diverge from the
        # ServeStats percentiles exactly when spec decoding is on
        for _ in range(n):
            self._tpot_res.add(gap)
            self._m_tpot.observe(gap)

    def on_complete(self, req):
        self.completed += 1
        self.prompt_tokens += int(req.prompt.size)
        self._m_completed.inc()
        self._m_prompt_tokens.inc(int(req.prompt.size))
        adapter = getattr(req, "adapter_id", None)
        if adapter is not None:
            row = self.adapters.setdefault(
                adapter, {"completed": 0, "tokens": 0})
            row["completed"] += 1
            row["tokens"] += len(req.tokens)
            self._m_adapter_completed.labels(adapter=adapter).inc()
            self._m_adapter_tokens.labels(adapter=adapter).inc(
                len(req.tokens))

    def on_reject(self):
        """Counts the Prometheus back-pressure series only.  The
        rejected TOTAL is owned by ``Scheduler.rejections`` (which
        counts queue-full at submit too), so ServeStats never
        double-counts and a bare Scheduler stays self-consistent."""
        self.rejected += 1
        self._m_rejected.inc()

    def _window_rate(self):
        if len(self._window) < 2:
            return None
        dt = self._window[-1][0] - self._window[0][0]
        if dt <= 0:
            return None
        # the first entry's tokens predate the window's time span
        toks = sum(n for _, n, _ in list(self._window)[1:])
        return toks / dt

    def _window_occupancy(self, max_batch):
        """Mean decode-slot occupancy over the recent-step window."""
        if not self._window or not max_batch:
            return None
        slots = sum(b for _, _, b in self._window)
        return slots / (len(self._window) * max_batch)

    def snapshot(self, scheduler, blocks):
        now = self.clock()
        rate_greedy, rate_stochastic = self.spec_mode_rates()
        pfx = blocks.prefix_stats()
        host = blocks.host_stats() or {}
        total_rate = None
        if self._start_t is not None and now > self._start_t:
            total_rate = self.tokens_generated / (now - self._start_t)
        ttft_mean = self._ttft_res.mean
        occupancy = self._window_occupancy(scheduler.max_batch)
        if occupancy is not None:
            occupancy = round(occupancy, 4)
        return ServeStats(
            steps=self.steps,
            queue_depth=scheduler.queue_depth,
            running=len(scheduler.running),
            completed=self.completed,
            rejected=scheduler.rejections,
            preemptions=scheduler.preemptions,
            evictions=blocks.evictions,
            tokens_generated=self.tokens_generated,
            prompt_tokens=self.prompt_tokens,
            blocks_in_use=blocks.blocks_in_use,
            blocks_total=blocks.total_blocks,
            block_utilization=round(blocks.utilization(), 4),
            peak_block_utilization=round(self.peak_block_utilization, 4),
            ttft_ms_mean=(round(ttft_mean * 1e3, 3)
                          if ttft_mean is not None else None),
            ttft_ms_max=(round(self._ttft_res.max * 1e3, 3)
                         if self._ttft_res.max is not None else None),
            ttft_ms_p50=_pct_ms(self._ttft_res, 0.50),
            ttft_ms_p90=_pct_ms(self._ttft_res, 0.90),
            ttft_ms_p99=_pct_ms(self._ttft_res, 0.99),
            tpot_ms_mean=(round(self._tpot_res.mean * 1e3, 3)
                          if self._tpot_res.mean is not None else None),
            tpot_ms_p50=_pct_ms(self._tpot_res, 0.50),
            tpot_ms_p90=_pct_ms(self._tpot_res, 0.90),
            tpot_ms_p99=_pct_ms(self._tpot_res, 0.99),
            decode_tok_per_sec=(round(self._window_rate(), 1)
                                if self._window_rate() else None),
            total_tok_per_sec=(round(total_rate, 1)
                               if total_rate else None),
            spec_drafted_tokens=self.spec_drafted_tokens,
            spec_accepted_tokens=self.spec_accepted_tokens,
            spec_rejected_tokens=self.spec_rejected_tokens,
            spec_verifies=self.spec_verifies,
            accepted_per_verify=(
                round(self.spec_accepted_tokens / self.spec_verifies, 4)
                if self.spec_verifies else None),
            spec_accept_rate=(
                round(self.spec_accepted_tokens
                      / self.spec_drafted_tokens, 4)
                if self.spec_drafted_tokens else None),
            spec_drafted_tokens_stochastic=(
                self.spec_drafted_tokens_stochastic),
            spec_accepted_tokens_stochastic=(
                self.spec_accepted_tokens_stochastic),
            spec_accept_rate_greedy=rate_greedy,
            spec_accept_rate_stochastic=rate_stochastic,
            decode_occupancy=occupancy,
            reject_reasons=dict(scheduler.reject_reasons),
            tenants=scheduler.tenant_stats(),
            adapters={a: dict(row) for a, row in self.adapters.items()},
            prefill_tokens_computed=self.prefill_tokens_computed,
            prefix_hits=pfx["hits"],
            prefix_misses=pfx["misses"],
            prefix_resurrections=pfx.get("resurrections", 0),
            prefix_hit_rate=pfx["hit_rate"],
            prefix_tokens_saved=pfx["tokens_saved"],
            prefix_evictions=pfx["evictions"],
            prefix_discarded_tokens=pfx["discarded_tokens"],
            host_kv_hits=pfx["host_hits"],
            host_kv_restored_tokens=pfx["host_restored_tokens"],
            host_kv_offloads=host.get("offloads", 0),
            host_kv_evictions=host.get("evictions", 0),
            host_kv_degraded=host.get("degraded", 0),
            host_kv_rejects=host.get("rejects", 0),
            host_kv_bytes_used=host.get("bytes_used", 0),
            host_kv_entries=host.get("entries", 0),
        )
