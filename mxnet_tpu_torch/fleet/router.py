"""The fleet front: SLO-aware routing with retries over N replicas.

A copy of the reference's ``mxnet_tpu/fleet/router.py`` over the port's
modules (telemetry, ``RequestTracer``, ``RadixSummary`` and
``chain_keys``): the same scoring, picks, retries, breaker, deadlines,
trace propagation, handoff orchestration and affinity plan, so a router
of either package drives replicas of either.

The router turns "one excellent engine process" into a service a
client can trust: it picks the least-loaded READY replica (live queue
depth + decode occupancy + KV occupancy scraped from each replica's
``/statusz.json``), bounds each hop with a timeout, and retries
rejected/failed/timed-out requests on a sibling with capped
exponential backoff — so a single-replica failure (crash, drain,
back-pressure, hang) is invisible to the caller.  A replica whose hops
fail ``breaker_fails`` times consecutively at the TRANSPORT level
(timeout, disconnect, internal 500 — structured 503 back-pressure is a
healthy replica and never counts) trips a circuit breaker and leaves
rotation for ``breaker_reset_s`` (one half-open probe at a time
re-admits it), so a dying replica cannot eat every request's first
attempt.

Retries are safe because they are idempotent by construction: every
client request carries one ``request_id`` across all attempts (the
replica dedups on it) and one ``trace_id`` propagated in the
``X-MXTPU-Trace-Id`` header, so each hop's request-trace JSONL line
shares the id and ``tools/trace_report.py --stitch`` reassembles the
cross-replica story.

Disaggregated fleets: replicas advertise a ``role`` in their scraped
load signal ("both"/"prefill"/"decode" — replica.py).  Prompts route
least-loaded among prefill-capable replicas; when the chosen replica
is prefill-role its 200 answer is a *handoff envelope* (the prompt's
KV chain as content-keyed records) and the router moves it to the
least-loaded decode-capable replica via ``POST /handoff`` — after a
``/handoff_probe`` dedup round that skips the bytes of blocks the
target already caches (the radix key IS the transfer dedup).  The
handoff hop keeps every fleet guarantee: remaining end-to-end
deadline forwarded, same trace id (one stitched timeline across both
roles), same request-id idempotency, and retry-on-sibling — a handoff
that times out or lands on a dead decode replica is re-sent to
another one from the payload still in hand, and a payload that
arrives truncated degrades to recompute-from-prompt on the receiver
(token-identical either way).

Cache-aware routing (``MXTPU_ROUTE_AFFINITY`` > 0): every scrape also
captures the replica's advertised ``kv_summary`` (a RadixSummary —
counting bloom over its published KV block keys + top-K recent chain
keys).  The router hashes each prompt's block chain tokenizer-side
(``serve.kv_block_manager.chain_keys`` — the same
``H(parent, block_tokens)`` chain as the radix index, no model
loaded), probes each candidate's summary for the longest advertised
ancestor, and ranks on ``load − affinity × advertised_fraction`` —
sticky enough that a returning conversation lands on its prefix,
load-aware enough that a hot prefix doesn't melt one replica.  When
the pick holds less of the chain than a sibling advertises, the
``/generate`` body carries a ``kv_pull`` hint and the serving replica
pulls the chain peer-to-peer (``/chain_export``) into its host tier.
At affinity 0 (the default) all of this is byte-inert: no chain keys
computed, no summary probed, wire bodies and pick order identical to
the pre-affinity router.  Summaries older than
``MXTPU_ROUTE_SUMMARY_STALE`` scrape intervals score zero.

Pure stdlib (urllib + a persistent per-replica keep-alive scrape
connection); no background machinery unless ``start()`` is called
(the scrape thread).  All knobs take constructor arguments first,
``MXTPU_FLEET_*`` / ``MXTPU_ROUTE_*`` env defaults second.
"""

from __future__ import annotations

import http.client
import itertools
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid

from .. import telemetry
from ..base import env_flag, env_float, env_int
from ..telemetry.request_trace import RequestTracer
from .replica import TRACE_HEADER

__all__ = ["Router", "RouterResult", "FleetError", "PermanentError",
           "NoReplicaAvailable"]


class FleetError(RuntimeError):
    """Base class for router-visible request failures."""


class PermanentError(FleetError):
    """The request can never succeed on any replica (e.g. longer than
    the model serves) — retrying would only burn capacity."""


class NoReplicaAvailable(FleetError):
    """Every attempt failed (replicas down/draining/rejecting) within
    the retry budget."""


class RouterResult:
    """One successful routed generation."""

    __slots__ = ("tokens", "replica", "trace_id", "request_id",
                 "attempts", "hops", "wall_s", "added_s", "samples",
                 "token_logprobs", "top_logprobs")

    def __init__(self, tokens, replica, trace_id, request_id, attempts,
                 hops, wall_s, added_s, samples=None,
                 token_logprobs=None, top_logprobs=None):
        self.tokens = tokens
        self.replica = replica
        self.trace_id = trace_id
        self.request_id = request_id
        self.attempts = attempts
        self.hops = hops           # [{"replica", "status", "wall_s"}]
        self.wall_s = wall_s
        self.added_s = added_s     # router-added latency (non-HTTP time)
        # per-request sampling extras (None unless the request asked):
        # n>1 sample list and the emitted tokens' logprob views
        self.samples = samples
        self.token_logprobs = token_logprobs
        self.top_logprobs = top_logprobs


class _ReplicaState:
    """Router-side view of one replica: scrape signal + breaker."""

    __slots__ = ("url", "name", "state", "role", "load",
                 "consecutive_failures", "open_until", "probing",
                 "last_scrape_t", "summary", "summary_t", "conn",
                 "scrape_lock", "connects", "model", "adapters")

    def __init__(self, url):
        self.url = url.rstrip("/")
        self.name = self.url
        self.state = "unknown"      # ready/draining/down/unknown
        # "both" until a scrape says otherwise: a legacy replica that
        # never advertises a role serves everything
        self.role = "both"
        # catalog advertisement: the carried checkpoint id and the
        # registered adapter ids.  None until a scrape says otherwise —
        # an uncataloged/legacy replica matches model-less requests
        # only, and a None adapter list never filters (the replica may
        # still know the adapter; its own 400 is the backstop)
        self.model = None
        self.adapters = None
        self.load = 0.0
        self.consecutive_failures = 0
        self.open_until = None      # breaker-open deadline (monotonic)
        self.probing = False        # half-open probe in flight
        self.last_scrape_t = None
        # cache-aware routing: the replica's advertised RadixSummary
        # snapshot and the scrape time it was captured (None until a
        # scrape sees one; a summary past the staleness cap scores
        # zero affinity: never route on data the fleet stopped
        # refreshing)
        self.summary = None
        self.summary_t = None
        # persistent scrape connection (keep-alive: the affinity
        # probe raises scrape frequency, so per-poll TCP connects
        # would be pure overhead); `connects` counts socket setups —
        # the connection-reuse regression pin reads it
        self.conn = None
        # non-blocking ownership of `conn`: an overlapping scrape
        # pass (a blackholed sibling can make passes overlap) skips a
        # replica whose connection is still mid-request rather than
        # interleaving two HTTP exchanges on one socket
        self.scrape_lock = threading.Lock()
        self.connects = 0


class Router:
    """Load-balancing, retrying front over replica URLs.

    Args (env default in parens):
      replicas: iterable of base URLs (``http://host:port``).
      timeout_s: per-hop HTTP timeout (``MXTPU_FLEET_TIMEOUT``, 30).
      retries: max attempts per request across replicas
        (``MXTPU_FLEET_RETRIES``, 3; the first try counts).
      backoff_s / backoff_max_s: capped exponential backoff between
        attempts (``MXTPU_FLEET_BACKOFF`` 0.05 /
        ``MXTPU_FLEET_BACKOFF_MAX`` 1.0) — attempt k (k >= 2) sleeps
        ``min(backoff_max_s, backoff_s * 2**(k-2))`` first.
      breaker_fails: consecutive hop failures that open a replica's
        circuit breaker (``MXTPU_FLEET_BREAKER_FAILS``, 3).
      breaker_reset_s: how long an open breaker keeps the replica out
        of rotation before one probe request may re-close it
        (``MXTPU_FLEET_BREAKER_RESET``, 5.0).
      scrape_interval_s: background statusz scrape period
        (``MXTPU_FLEET_SCRAPE_INTERVAL``, 0.5); ``start()`` launches
        the thread, or call ``scrape()`` manually (tests).
      affinity: cache-aware routing weight (``MXTPU_ROUTE_AFFINITY``,
        0.0 = byte-inert least-loaded): subtracts
        ``affinity × advertised_prefix_fraction`` from a candidate's
        load score.
      pull: attach ``kv_pull`` peer-hints when a sibling advertises
        more of the prompt's chain than the pick
        (``MXTPU_ROUTE_PULL``, on; effective only with affinity > 0).
      summary_stale: advertised summaries older than this many scrape
        intervals score zero affinity
        (``MXTPU_ROUTE_SUMMARY_STALE``, 3.0).
      clock: injectable monotonic clock (breaker/backoff tests).
      sleep: injectable sleep (backoff tests).
    """

    def __init__(self, replicas, timeout_s=None, retries=None,
                 backoff_s=None, backoff_max_s=None, breaker_fails=None,
                 breaker_reset_s=None, scrape_interval_s=None,
                 affinity=None, pull=None, summary_stale=None,
                 clock=time.monotonic, sleep=time.sleep):
        self.timeout_s = (float(timeout_s) if timeout_s is not None
                          else env_float("MXTPU_FLEET_TIMEOUT", 30.0))
        self.retries = (int(retries) if retries is not None
                        else env_int("MXTPU_FLEET_RETRIES", 3))
        self.backoff_s = (float(backoff_s) if backoff_s is not None
                          else env_float("MXTPU_FLEET_BACKOFF", 0.05))
        self.backoff_max_s = (
            float(backoff_max_s) if backoff_max_s is not None
            else env_float("MXTPU_FLEET_BACKOFF_MAX", 1.0))
        self.breaker_fails = (
            int(breaker_fails) if breaker_fails is not None
            else env_int("MXTPU_FLEET_BREAKER_FAILS", 3))
        self.breaker_reset_s = (
            float(breaker_reset_s) if breaker_reset_s is not None
            else env_float("MXTPU_FLEET_BREAKER_RESET", 5.0))
        self.scrape_interval_s = (
            float(scrape_interval_s) if scrape_interval_s is not None
            else env_float("MXTPU_FLEET_SCRAPE_INTERVAL", 0.5))
        # cache-aware routing weight: each candidate's score becomes
        # ``load - affinity * advertised_prefix_fraction`` (fraction
        # of the prompt's tokens the replica's RadixSummary says it
        # caches, 0..1 — same scale as one unit of load).  0 is the
        # BYTE-INERT default: no chain keys computed, no summary
        # probed, the pick identical to least-loaded by construction
        self.affinity = (float(affinity) if affinity is not None
                         else env_float("MXTPU_ROUTE_AFFINITY", 0.0))
        # peer-to-peer pull hints (effective only with affinity > 0):
        # when the pick holds less of the prompt's chain than the best
        # advertiser, the /generate body carries a kv_pull hint and
        # the serving replica pulls the chain from that sibling
        self.pull = (bool(pull) if pull is not None
                     else env_flag("MXTPU_ROUTE_PULL", True))
        # summaries older than this many scrape intervals contribute
        # ZERO affinity (the stale-data rule: never route on
        # data the fleet stopped refreshing)
        self.summary_stale = (
            float(summary_stale) if summary_stale is not None
            else env_float("MXTPU_ROUTE_SUMMARY_STALE", 3.0))
        self.clock = clock
        self.sleep = sleep
        self._lock = threading.RLock()
        # membership + each entry's breaker/scrape fields are mutated
        # from request threads AND the scrape thread
        self._replicas = [_ReplicaState(u) for u in replicas]  # guarded-by: _lock
        self._rr = itertools.count()
        self._scrape_thread = None
        self._stop_evt = threading.Event()
        self._m_requests = telemetry.counter(
            "mxtpu_fleet_requests_total", "routed client requests",
            ("outcome",))
        self._m_hops = telemetry.counter(
            "mxtpu_fleet_hops_total", "per-replica attempt outcomes",
            ("replica", "status"))
        self._m_retries = telemetry.counter(
            "mxtpu_fleet_retries_total", "attempts after the first")
        self._m_breaker = telemetry.counter(
            "mxtpu_fleet_breaker_opens_total", "circuit-breaker trips",
            ("replica",))
        self._m_added = telemetry.histogram(
            "mxtpu_fleet_router_added_seconds",
            "router-added latency (request wall minus replica HTTP time)")
        self._m_handoffs = telemetry.counter(
            "mxtpu_fleet_handoffs_total",
            "prefill->decode KV handoffs routed", ("outcome",))
        self._m_handoff_dedup = telemetry.counter(
            "mxtpu_fleet_handoff_dedup_blocks_total",
            "handoff blocks whose bytes the dedup probe skipped")
        self._m_affinity = telemetry.counter(
            "mxtpu_fleet_affinity_picks_total",
            "affinity-routed picks by whether the chosen replica "
            "advertised any of the prompt's chain", ("outcome",))
        self._m_pull_hints = telemetry.counter(
            "mxtpu_fleet_pull_hints_total",
            "kv_pull hints attached to routed requests (a sibling "
            "advertised more of the chain than the pick)")
        # per-hop wall time by outcome: the stitched-view "router time"
        # a replica-side trace can never see (ok / reject = structured
        # 503 back-pressure / timeout / retry = transport failure that
        # moves to a sibling)
        self._m_hop_seconds = telemetry.histogram(
            "mxtpu_fleet_router_hop_seconds",
            "per-replica hop HTTP wall time by outcome", ("outcome",))
        self._m_breaker_state = telemetry.gauge(
            "mxtpu_fleet_breaker_state",
            "replica circuit breaker: 0 closed, 0.5 half-open probe, "
            "1 open", ("replica",))
        # router-side trace lines (the same MXTPU_REQUEST_TRACE /
        # MXTPU_TRACE_PUSH_URL opt-ins the serve engine honors): one
        # complete timeline per routed request — pick / hop / probe /
        # handoff events — under the SAME trace id as the replica-side
        # lines, so `trace_report --stitch` shows router time next to
        # replica time.  Inert (no events, no file, no pusher) when
        # neither knob is set.
        self._trace = RequestTracer(source="router")
        self._trace.identity = "router"
        self._trace_rid = itertools.count(1)

    # -- membership ----------------------------------------------------------
    def replicas(self):
        with self._lock:
            return list(self._replicas)

    def add_replica(self, url):
        with self._lock:
            self._replicas.append(_ReplicaState(url))

    def remove_replica(self, url):
        url = url.rstrip("/")
        with self._lock:
            self._replicas = [r for r in self._replicas if r.url != url]

    # -- scraping ------------------------------------------------------------
    def start(self):
        """Launch the background scrape thread (no-op when the
        interval is 0 — drive ``scrape()`` manually instead)."""
        if self.scrape_interval_s <= 0 or self._scrape_thread is not None:
            return self
        self._scrape_thread = threading.Thread(
            target=self._scrape_loop, daemon=True,
            name="mxtpu-fleet-router-scrape")
        self._scrape_thread.start()
        return self

    def stop(self):
        self._stop_evt.set()
        if self._scrape_thread is not None:
            self._scrape_thread.join(timeout=5)
            self._scrape_thread = None
        self._trace.close()
        for r in self.replicas():
            with self._lock:
                conn, r.conn = r.conn, None
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass

    def _scrape_loop(self):
        while not self._stop_evt.wait(self.scrape_interval_s):
            self.scrape()

    def scrape(self):
        """One pass over every replica's ``/statusz.json``: refresh
        readiness + load.  Unreachable replicas go ``down``.

        Replicas are scraped CONCURRENTLY (one short-lived thread
        each): a single blackholed replica eating its full probe
        timeout must not stall drain/down detection on every sibling
        past the scrape interval."""
        replicas = self.replicas()
        if not replicas:
            return self.snapshot()
        threads = [threading.Thread(target=self._scrape_one, args=(r,),
                                    daemon=True) for r in replicas]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=min(self.timeout_s, 5.0) + 1.0)
        return self.snapshot()

    def _scrape_one(self, r):
        """One replica's scrape over its PERSISTENT keep-alive
        connection (opened lazily, reused across passes — the
        affinity probe raises scrape frequency, and paying a TCP
        connect per poll per replica was pure overhead).  Any
        transport or parse failure closes the connection (it may be
        half-broken) and marks the replica down; the next pass
        reconnects.  Guarded by a non-blocking per-replica lock so an
        overlapping pass never interleaves two exchanges on one
        socket — it just skips this replica for one round."""
        if not r.scrape_lock.acquire(blocking=False):
            return                      # an older pass still owns conn
        try:
            conn = r.conn
            if conn is None:
                parsed = urllib.parse.urlsplit(r.url)
                conn = http.client.HTTPConnection(
                    parsed.hostname, parsed.port,
                    timeout=min(self.timeout_s, 5.0))
                with self._lock:
                    r.conn = conn
                    r.connects += 1
            conn.request("GET", "/statusz.json")
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status != 200:
                raise OSError(f"statusz http {resp.status}")
            snap = json.loads(raw)
            sec = snap.get("replica") or {}
            summary = sec.get("kv_summary")
            with self._lock:
                r.state = ("ready" if sec.get("state") == "ready"
                           else sec.get("state") or "down")
                r.name = sec.get("replica") or r.name
                r.role = sec.get("role") or "both"
                r.model = sec.get("model")
                adp = sec.get("adapters")
                r.adapters = (list(adp.get("ids") or [])
                              if isinstance(adp, dict) else None)
                r.load = self._load_score(sec)
                r.last_scrape_t = self.clock()
                if isinstance(summary, dict):
                    r.summary = summary
                    r.summary_t = r.last_scrape_t
        except (OSError, ValueError, http.client.HTTPException):
            try:
                if r.conn is not None:
                    r.conn.close()
            except OSError:
                pass
            with self._lock:
                r.conn = None
                r.state = "down"
                r.last_scrape_t = self.clock()
        finally:
            r.scrape_lock.release()

    @staticmethod
    def _load_score(sec):
        """Scalar routing score from a replica's statusz section:
        queued work normalized by batch width plus KV occupancy — both
        saturate at ~1, so an idle replica scores ~0 and a saturated
        one ~2+.  In-flight handoff ingests (mid-import, not yet
        queued) count as queued work: a decode replica swallowing a
        large KV payload must not under-report and attract the next
        handoff too."""
        width = max(1, int(sec.get("max_batch") or 1))
        queued = (int(sec.get("queue_depth") or 0)
                  + int(sec.get("running") or 0)
                  + int(sec.get("waiting_handoffs") or 0))
        return queued / width + float(sec.get("kv_utilization") or 0.0)

    def snapshot(self):
        """Router-side fleet view (statusz provider shape)."""
        with self._lock:
            now = self.clock()
            return [{"url": r.url, "replica": r.name, "state": r.state,
                     "role": r.role,
                     "model": r.model,
                     "adapters": r.adapters,
                     "load": round(r.load, 4),
                     "consecutive_failures": r.consecutive_failures,
                     "breaker_open": bool(r.open_until is not None
                                          and r.open_until > now)}
                    for r in self._replicas]

    # -- cache-aware routing (affinity > 0 only) -----------------------------
    def _affinity_plan(self, prompt, salt=None):
        """Per-replica advertised-prefix match for ``prompt``: probe
        each FRESH ``kv_summary`` (stale ones score zero — the stale-data
        rule: never route on data the fleet stopped refreshing) for
        the longest advertised ancestor of the prompt's chain.  The
        chain keys are computed ONCE per distinct advertised
        block_size (the tokenizer-side ``chain_keys`` helper — same
        ``H(parent, block_tokens)`` hash as the radix index, no model
        loaded).  Returns ``{"scores": {url: {"tokens", "frac"}},
        "best": {...}}`` or None when nothing matched anywhere (the
        pick then degenerates to pure least-loaded).  Never called
        with ``affinity == 0`` — the byte-inert path skips it
        entirely."""
        from ..serve.kv_block_manager import RadixSummary, chain_keys

        now = self.clock()
        stale_after = (self.summary_stale
                       * max(self.scrape_interval_s, 1.0))
        with self._lock:
            rows = [(r.url, r.name, r.summary, r.summary_t)
                    for r in self._replicas]
        keys_by_bs = {}
        scores = {}
        best = None
        for url, name, summary, summary_t in rows:
            if not summary or summary_t is None:
                continue
            if now - summary_t > stale_after:
                continue                # stale: zero affinity
            bs = int(summary.get("block_size") or 0)
            if bs < 1:
                continue
            if bs not in keys_by_bs:
                # the replicas salt adapter chains (disjoint key
                # space per adapter); probe with the same salt or an
                # adapter request would score base-chain affinity
                keys_by_bs[bs] = chain_keys(prompt, bs, salt=salt)
            depth = RadixSummary.match(summary, keys_by_bs[bs])
            if depth <= 0:
                continue
            tokens = depth * bs
            scores[url] = {"tokens": tokens,
                           "frac": tokens / max(1, len(prompt))}
            if best is None or tokens > best["tokens"]:
                best = {"url": url, "name": name, "tokens": tokens}
        if not scores:
            return None
        return {"scores": scores, "best": best}

    def _pull_hint(self, plan, r):
        """The ``kv_pull`` hint for pick ``r`` under ``plan``: the
        best-advertising SIBLING's url + advertised token span, or
        None when the pick already matches the fleet's best (or pull
        is disabled).  The serving replica does the actual fetch —
        the router never moves KV bytes on this path."""
        best = plan["best"]
        if not self.pull or best is None or best["url"] == r.url:
            return None
        mine = plan["scores"].get(r.url)
        if mine is not None and mine["tokens"] >= best["tokens"]:
            return None
        return {"peer": best["url"], "tokens": int(best["tokens"])}

    # -- picking -------------------------------------------------------------
    def _pick(self, exclude, want=None, weights=None, model=None,
              adapter=None):
        """Least-loaded READY replica with a closed (or probe-ready)
        breaker, excluding already-tried ones; round-robin tiebreak.
        ``want`` filters by role capability: ``"prefill"`` skips
        decode-only replicas, ``"decode"`` skips prefill-only ones
        (role "both" — and never-scraped legacy replicas — serve
        either).  ``model`` filters by catalog identity: a model-tagged
        request only lands on replicas advertising that checkpoint
        (composing with role and affinity; model-less requests rank
        every replica, the historical pick).  ``adapter`` filters by
        advertised adapter ids when the replica advertises any — a
        replica with no advertisement passes (its own validation is
        the backstop).  ``weights`` (affinity routing) maps replica
        url -> score credit subtracted from its load before ranking;
        None — the affinity-off path — ranks on raw load,
        bit-identically to the pre-affinity router."""
        with self._lock:
            now = self.clock()
            rr = next(self._rr)
            n = max(1, len(self._replicas))
            ranked = []
            for i, r in enumerate(self._replicas):
                if r.url in exclude:
                    continue
                if r.state in ("draining", "down"):
                    continue
                if want == "prefill" and r.role == "decode":
                    continue
                if want == "decode" and r.role == "prefill":
                    continue
                if model is not None and r.model != model:
                    continue
                if (adapter is not None and r.adapters is not None
                        and adapter not in r.adapters):
                    continue
                if r.open_until is not None:
                    if r.open_until > now:
                        continue        # breaker open
                    if r.probing:
                        continue        # half-open: ONE probe at a time
                score = r.load
                if weights:
                    score -= weights.get(r.url, 0.0)
                ranked.append((score, (i - rr) % n, r))
            if not ranked:
                return None
            ranked.sort(key=lambda t: (t[0], t[1]))
            best = ranked[0][2]
            probing = best.open_until is not None
            if probing:
                best.probing = True     # this attempt IS the probe
        if probing:
            self._m_breaker_state.labels(replica=best.name).set(0.5)
        return best

    @staticmethod
    def _counts_for_breaker(code, payload):
        """Only TRANSPORT-level failures trip the breaker: timeouts,
        disconnects, garbage responses, and replica-internal 500s.  A
        structured 503 rejection (queue_full / tenant_share / draining
        / fault_refuse) is a healthy replica applying back-pressure —
        it must be retried on a sibling, but counting it as a failure
        would let one overload burst open EVERY breaker and take the
        whole fleet out for well-behaved clients."""
        if code in ("timeout", "disconnect", "bad_response"):
            return True
        return isinstance(code, int) and code >= 500 and code != 503

    def _hop_failed(self, r, status, breaker=True):
        with self._lock:
            r.probing = False
            if breaker:
                now = self.clock()
                r.consecutive_failures += 1
                # (re-)arm whenever the breaker is not CURRENTLY open:
                # a stale past deadline means a half-open probe just
                # failed, and the breaker must open again, not retire
                if r.consecutive_failures >= self.breaker_fails \
                        and (r.open_until is None or r.open_until <= now):
                    r.open_until = now + self.breaker_reset_s
                    self._m_breaker.labels(replica=r.name).inc()
            open_now = (r.open_until is not None
                        and r.open_until > self.clock())
        self._m_breaker_state.labels(replica=r.name).set(
            1.0 if open_now else 0.0)
        self._m_hops.labels(replica=r.name, status=status).inc()

    def _hop_ok(self, r, status="ok"):
        with self._lock:
            r.consecutive_failures = 0
            r.open_until = None
            r.probing = False
        self._m_breaker_state.labels(replica=r.name).set(0.0)
        self._m_hops.labels(replica=r.name, status=status).inc()

    @staticmethod
    def _hop_outcome(code):
        """The ``mxtpu_fleet_router_hop_seconds`` outcome label:
        structured rejections (503-class back-pressure and permanent
        400s) are ``reject``; transport failures that will move to a
        sibling are ``retry``; timeouts get their own bucket."""
        if code == 200:
            return "ok"
        if code == "timeout":
            return "timeout"
        if code == "rejected_permanent" or code == 503:
            return "reject"
        return "retry"

    def _observe_hop(self, code, wall_s):
        self._m_hop_seconds.labels(
            outcome=self._hop_outcome(code)).observe(wall_s)

    # -- router-side trace timeline (hop-level events) -----------------------
    def _trace_begin(self, prompt_len, max_new, tenant, trace_id):
        """Open a router-side timeline for one routed request (None
        when tracing is off — every hook below no-ops on None)."""
        if not self._trace.enabled:
            return None
        import types

        req = types.SimpleNamespace(
            rid=next(self._trace_rid), trace_id=trace_id, tenant=tenant,
            prompt=types.SimpleNamespace(size=int(prompt_len)),
            max_new_tokens=int(max_new), tokens=[], n_preemptions=0)
        self._trace.submitted(req)
        return req

    def _trace_ev(self, rt, name, **args):
        if rt is not None:
            self._trace.event(rt, name, **args)

    def _trace_end(self, rt, name, **args):
        # terminal names: "finished" for a served request, "cancelled"
        # for a router-level failure — never "rejected", which would
        # double-count mxtpu_serve_rejections_total against the
        # replica-side line that already owns the rejection
        if rt is not None:
            self._trace.terminal(rt, name, **args)

    # -- the request path ----------------------------------------------------
    def generate(self, prompt, max_new_tokens=64, deadline_s=None,
                 tenant=None, request_id=None, trace_id=None,
                 temperature=None, top_p=None, top_k=None, n=None,
                 logprobs=None, model=None, adapter=None):
        """Route one generation; returns :class:`RouterResult`.

        ``temperature``/``top_p``/``top_k``/``n``/``logprobs`` are the
        per-request sampling params — forwarded to the serving replica
        verbatim (and re-forwarded on a prefill→decode handoff, which
        reuses the same base body), only-when-set so plain requests'
        wire bodies stay byte-identical to pre-sampling releases.
        ``model``/``adapter`` (catalog params) ride the same rule, and
        additionally FILTER the pick: a model id no scraped replica
        advertises is a :class:`PermanentError` before any hop —
        routing it anywhere could only produce per-replica 400s.

        Raises :class:`PermanentError` for requests no replica can
        serve and :class:`NoReplicaAvailable` once the retry budget is
        exhausted."""
        request_id = request_id or uuid.uuid4().hex
        trace_id = trace_id or f"fleet-{uuid.uuid4().hex[:16]}"
        if model is not None:
            model = str(model)[:64]
            with self._lock:
                known = any(r.model == model for r in self._replicas)
            if not known:
                self._m_requests.labels(outcome="permanent").inc()
                raise PermanentError(
                    f"unknown model: {model!r} (no replica in the "
                    "fleet advertises it)")
        if adapter is not None:
            adapter = str(adapter)[:64]
        base = {"prompt": [int(t) for t in prompt],
                "max_new_tokens": int(max_new_tokens),
                "deadline_s": deadline_s, "tenant": tenant,
                "request_id": request_id}
        for key, val in (("temperature", temperature), ("top_p", top_p),
                         ("top_k", top_k), ("n", n),
                         ("logprobs", logprobs), ("model", model),
                         ("adapter", adapter)):
            if val is not None:
                base[key] = val
        body = json.dumps(base).encode()
        t0 = time.perf_counter()
        rt = self._trace_begin(len(base["prompt"]), max_new_tokens,
                               tenant, trace_id)
        # cache-aware routing: with affinity ON, score every fresh
        # advertised summary against this prompt's chain ONCE (not per
        # attempt — the fleet view only changes at scrape cadence).
        # With affinity 0 this whole plane is byte-inert: no chain
        # keys, no weights, no body growth, the pre-affinity pick
        plan = weights = None
        if self.affinity > 0:
            plan = self._affinity_plan(base["prompt"], salt=adapter)
            if plan is not None:
                weights = {u: self.affinity * s["frac"]
                           for u, s in plan["scores"].items()}
        hops = []
        tried = set()
        last_error = "no_replica"
        remaining = None
        for attempt in range(1, max(1, self.retries) + 1):
            if attempt > 1:
                self._m_retries.inc()
                self._trace_ev(rt, "retry", attempt=attempt,
                               last_error=last_error)
                self.sleep(min(self.backoff_max_s,
                               self.backoff_s * 2 ** (attempt - 2)))
            if deadline_s is not None:
                # the deadline is an END-TO-END SLO: each hop gets the
                # REMAINING budget, not a fresh one — and once it is
                # spent, retrying anywhere is pointless
                remaining = deadline_s - (time.perf_counter() - t0)
                if remaining <= 0:
                    self._m_requests.labels(outcome="deadline").inc()
                    self._trace_end(rt, "cancelled", reason="deadline")
                    raise PermanentError(
                        f"deadline_s={deadline_s} exhausted after "
                        f"{attempt - 1} attempt(s) (last error: "
                        f"{last_error})")
                body = json.dumps(dict(base,
                                       deadline_s=remaining)).encode()
            r = self._pick(tried, want="prefill", weights=weights,
                           model=model, adapter=adapter)
            if r is None and tried:
                # every replica tried once: second pass may retry one
                # (it may have recovered / stopped rejecting)
                tried = set()
                r = self._pick(tried, want="prefill", weights=weights,
                               model=model, adapter=adapter)
            if r is None:
                last_error = "no_replica"
                continue
            tried.add(r.url)
            send_body = body
            if plan is not None:
                sc = plan["scores"].get(r.url)
                mine = sc["tokens"] if sc else 0
                self._m_affinity.labels(
                    outcome="hit" if mine else "cold").inc()
                hint = self._pull_hint(plan, r)
                if hint is not None:
                    extra = dict(base, kv_pull=hint)
                    if deadline_s is not None:
                        extra["deadline_s"] = remaining
                    send_body = json.dumps(extra).encode()
                    self._m_pull_hints.inc()
                self._trace_ev(
                    rt, "pick", replica=r.name, attempt=attempt,
                    affinity_tokens=mine,
                    **({"pull_peer": hint["peer"],
                        "pull_tokens": hint["tokens"]}
                       if hint is not None else {}))
            else:
                self._trace_ev(rt, "pick", replica=r.name,
                               attempt=attempt)
            h0 = time.perf_counter()
            code, payload = self._post(r, send_body, trace_id)
            hop_wall = time.perf_counter() - h0
            self._observe_hop(code, hop_wall)
            self._trace_ev(rt, "hop", replica=r.name, status=str(code),
                           wall_ms=round(hop_wall * 1e3, 3))
            hops.append({"replica": r.name, "status": code,
                         "wall_s": round(hop_wall, 6)})
            if code == 200 and "handoff" in payload:
                # a prefill-role replica answered with the KV handoff
                # envelope, not tokens: move it (and the remaining
                # deadline + the same trace id) to a decode replica
                self._hop_ok(r, status="prefill_ok")
                return self._route_handoff(
                    payload["handoff"], base, request_id, trace_id,
                    deadline_s, t0, hops, attempt, rt=rt)
            if code == 200:
                self._hop_ok(r)
                wall = time.perf_counter() - t0
                added = max(0.0, wall - sum(h["wall_s"] for h in hops))
                self._m_added.observe(added)
                self._m_requests.labels(outcome="ok").inc()
                if rt is not None:
                    rt.tokens = list(payload.get("tokens") or [])
                    self._trace_end(rt, "finished",
                                    replica=payload.get("replica"),
                                    attempts=attempt)
                return RouterResult(
                    tokens=payload["tokens"], replica=payload["replica"],
                    trace_id=trace_id, request_id=request_id,
                    attempts=attempt, hops=hops, wall_s=wall,
                    added_s=added, samples=payload.get("samples"),
                    token_logprobs=payload.get("token_logprobs"),
                    top_logprobs=payload.get("top_logprobs"))
            if code == "rejected_permanent":
                # the replica is ALIVE and answered correctly — clear
                # its breaker state before giving the caller its 400
                self._hop_ok(r, status="rejected_permanent")
                self._m_requests.labels(outcome="permanent").inc()
                self._trace_end(rt, "cancelled", reason="permanent",
                                error=str(payload.get("error")))
                raise PermanentError(
                    f"request rejected as unservable: "
                    f"{payload.get('error')} (replica {r.name})")
            # retriable: 503-class rejection, timeout, disconnect
            last_error = (payload or {}).get("error", str(code))
            self._hop_failed(r, str(code),
                             breaker=self._counts_for_breaker(code,
                                                              payload))
            if last_error == "draining":
                # fast rotation exit — don't wait for the next scrape
                with self._lock:
                    r.state = "draining"
        self._m_requests.labels(outcome="exhausted").inc()
        self._trace_end(rt, "cancelled", reason="exhausted",
                        error=str(last_error))
        raise NoReplicaAvailable(
            f"request {request_id} failed after {self.retries} attempts "
            f"(last error: {last_error}); hops: "
            + ", ".join(f"{h['replica']}:{h['status']}" for h in hops))

    def _route_handoff(self, ho, base, request_id, trace_id,
                       deadline_s, t0, hops, attempts, rt=None):
        """Move one prefill replica's handoff envelope to a decode
        replica and return the completed generation.

        Own sibling-retry loop: the KV payload stays in the router's
        hand, so a handoff that times out, disconnects, or lands on a
        dead/draining decode replica is simply re-sent to another one
        (request-id idempotency makes the re-send safe, content-keyed
        records make a partial first delivery harmless).  The deadline
        is the SAME end-to-end budget the prefill hop was already
        drawing down; each attempt first runs the ``/handoff_probe``
        dedup round and skips the bytes of blocks the target already
        caches."""
        records = list(ho.get("records") or [])
        keys = [rec.get("key") for rec in records]
        # catalog params ride `base`, so they re-forward on this hop
        # automatically; the decode pick must honor them too
        model = base.get("model")
        adapter = base.get("adapter")
        tried = set()
        last_error = "no_decode_replica"
        for attempt in range(1, max(1, self.retries) + 1):
            if attempt > 1:
                self._m_retries.inc()
                self._trace_ev(rt, "retry", attempt=attempt,
                               hop="handoff", last_error=last_error)
                self.sleep(min(self.backoff_max_s,
                               self.backoff_s * 2 ** (attempt - 2)))
            remaining = None
            if deadline_s is not None:
                remaining = deadline_s - (time.perf_counter() - t0)
                if remaining <= 0:
                    self._m_requests.labels(outcome="deadline").inc()
                    self._m_handoffs.labels(outcome="deadline").inc()
                    self._trace_end(rt, "cancelled", reason="deadline")
                    raise PermanentError(
                        f"deadline_s={deadline_s} exhausted during "
                        f"handoff after {attempt - 1} attempt(s) "
                        f"(last error: {last_error})")
            r = self._pick(tried, want="decode", model=model,
                           adapter=adapter)
            if r is None and tried:
                tried = set()
                r = self._pick(tried, want="decode", model=model,
                               adapter=adapter)
            if r is None:
                last_error = "no_decode_replica"
                continue
            tried.add(r.url)
            self._trace_ev(rt, "pick", replica=r.name, attempt=attempt,
                           hop="handoff")
            send = records
            if keys and all(keys):
                missing = self._probe_handoff(r, keys)
                if missing is not None:
                    miss = set(missing)
                    skipped = sum(1 for k in keys if k not in miss)
                    if skipped:
                        self._m_handoff_dedup.inc(skipped)
                    self._trace_ev(rt, "probe", replica=r.name,
                                   skipped=skipped,
                                   missing=len(miss))
                    # the radix key IS the dedup: blocks the target
                    # already caches travel as key+tokens only (the
                    # receiver re-verifies the chain either way)
                    send = [rec if rec["key"] in miss else
                            {k: rec[k]
                             for k in ("key", "parent", "tokens")}
                            for rec in records]
            body = json.dumps(dict(base, records=send,
                                   deadline_s=remaining)).encode()
            h0 = time.perf_counter()
            code, payload = self._post(r, body, trace_id,
                                       path="/handoff")
            hop_wall = time.perf_counter() - h0
            self._observe_hop(code, hop_wall)
            self._trace_ev(rt, "handoff", replica=r.name,
                           status=str(code),
                           wall_ms=round(hop_wall * 1e3, 3),
                           records=len(send))
            hops.append({"replica": r.name, "status": code,
                         "wall_s": round(hop_wall, 6),
                         "hop": "handoff"})
            if code == 200:
                self._hop_ok(r)
                wall = time.perf_counter() - t0
                added = max(0.0, wall - sum(h["wall_s"] for h in hops))
                self._m_added.observe(added)
                self._m_requests.labels(outcome="ok").inc()
                self._m_handoffs.labels(outcome="ok").inc()
                if rt is not None:
                    rt.tokens = list(payload.get("tokens") or [])
                    self._trace_end(rt, "finished",
                                    replica=payload.get("replica"),
                                    attempts=attempts + attempt)
                return RouterResult(
                    tokens=payload["tokens"],
                    replica=payload["replica"], trace_id=trace_id,
                    request_id=request_id, attempts=attempts + attempt,
                    hops=hops, wall_s=wall, added_s=added,
                    samples=payload.get("samples"),
                    token_logprobs=payload.get("token_logprobs"),
                    top_logprobs=payload.get("top_logprobs"))
            if code == "rejected_permanent":
                self._hop_ok(r, status="rejected_permanent")
                self._m_requests.labels(outcome="permanent").inc()
                self._m_handoffs.labels(outcome="permanent").inc()
                self._trace_end(rt, "cancelled", reason="permanent",
                                error=str(payload.get("error")))
                raise PermanentError(
                    f"handoff rejected as unservable: "
                    f"{payload.get('error')} (replica {r.name})")
            last_error = (payload or {}).get("error", str(code))
            self._hop_failed(r, str(code),
                             breaker=self._counts_for_breaker(code,
                                                              payload))
            if last_error == "draining":
                with self._lock:
                    r.state = "draining"
        self._m_requests.labels(outcome="exhausted").inc()
        self._m_handoffs.labels(outcome="exhausted").inc()
        self._trace_end(rt, "cancelled", reason="exhausted",
                        error=str(last_error))
        raise NoReplicaAvailable(
            f"handoff for {request_id} failed after {self.retries} "
            f"attempt(s) (last error: {last_error}); hops: "
            + ", ".join(f"{h['replica']}:{h['status']}" for h in hops))

    def _probe_handoff(self, r, keys):
        """``/handoff_probe`` dedup round: the subset of ``keys`` the
        target does NOT cache (those need their bytes).  None when the
        probe itself fails — the probe is purely a bytes optimization,
        so failure means "send everything", never an error."""
        req = urllib.request.Request(
            f"{r.url}/handoff_probe",
            data=json.dumps({"keys": keys}).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=min(self.timeout_s, 5.0)) as resp:
                out = json.loads(resp.read())
            missing = out.get("missing")
            return missing if isinstance(missing, list) else None
        except (OSError, ValueError):
            return None

    def _post(self, r, body, trace_id, path="/generate"):
        """One hop.  Returns ``(200, payload)``,
        ``("rejected_permanent", payload)`` for a 400-class rejection,
        or ``(status_label, payload_or_None)`` for retriable failures
        (503 rejections, timeouts, disconnects)."""
        req = urllib.request.Request(
            f"{r.url}{path}", data=body, method="POST",
            headers={"Content-Type": "application/json",
                     TRACE_HEADER: trace_id})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                return 200, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read())
            except ValueError:
                payload = {"error": f"http_{e.code}"}
            if e.code == 400 or not payload.get("retriable", True):
                return "rejected_permanent", payload
            return e.code, payload
        except TimeoutError:
            return "timeout", {"error": "timeout"}
        except (urllib.error.URLError, OSError) as e:
            # URLError wraps socket timeouts on some Python versions
            reason = getattr(e, "reason", e)
            if isinstance(reason, TimeoutError) or "timed out" in str(e):
                return "timeout", {"error": "timeout"}
            return "disconnect", {"error": f"disconnect: {e}"}
        except ValueError:
            return "bad_response", {"error": "bad_response"}
