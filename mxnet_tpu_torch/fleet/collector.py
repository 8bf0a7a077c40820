"""FleetCollector: the fleet's live sensor plane.

A copy of the reference's ``mxnet_tpu/fleet/collector.py`` over the
port's telemetry, time-series ring and flight recorder: the same
scrape, aggregation, trace ingest, annotations, capture requests and
``/fleetz`` pages, so a collector of either package watches replicas
of either, and ``tools/fleet_report.py`` renders its ``/fleetz.json``.

Until now every fleet-level signal was post-hoc: per-replica request
traces were stitched from JSONL files after the run, router hop
latency existed only inside a bench payload, and nobody could read
"total queue depth across the decode pool right now" anywhere.  The
collector turns the fleet from benchmarkable into operable — and is
deliberately the *sensor* half of autoscaling: the
follow-up autoscaler reads this plane and is pure policy.

One ``FleetCollector`` (owned by whoever owns the Router/Supervisor)
does four things:

* **Scrapes** every replica's ``GET /statusz.json`` (the ``replica``
  section: queue depth, running, ``waiting_handoffs``, KV + host-KV
  utilization, and the ``stats`` ground truth — token/reject totals,
  TTFT/TPOT percentiles, per-tenant completions) and ``GET /metrics``
  (Prometheus text) on an interval into one bounded
  :class:`~mxnet_tpu_torch.telemetry.timeseries.TimeSeriesRing` per replica.
  A scrape failure is isolated to ITS replica — counted, marked stale
  after ``stale_after`` missed intervals, never holing a sibling's
  series.
* **Aggregates** a fleet view keyed by role (prefill / decode / both):
  summed queue depth and token/reject totals, windowed tokens/sec,
  mean KV and host-KV utilization, ``waiting_handoffs``, per-tenant
  goodput — served at ``GET /fleetz`` (HTML) + ``GET /fleetz.json``
  and rendered by ``tools/fleet_report.py``.  Stale replicas are
  listed but EXCLUDED from totals (a dead replica's last scrape must
  not count as live queue depth forever).
* **Receives** pushed terminal request-trace lines (replicas set
  ``MXTPU_TRACE_PUSH_URL`` to this collector's ``/trace``), so
  cross-role stitched timelines — and the SLO layer's per-request
  good/bad events — exist live instead of only from files.
* **Annotates** a fleet timeline: supervisor lifecycle events
  (crash-restart, drain, rolling-restart phases) and firing SLO
  alerts land as annotations next to the series they explain.

With ``MXTPU_SLO_SPEC`` set (see ``fleet/slo.py``) the collector owns
an :class:`~mxnet_tpu_torch.fleet.slo.SLOEvaluator` and evaluates it after
every scrape pass.

Fully inert when unconfigured: nothing in the serving stack constructs
a collector — no object, no thread, no endpoint — and replicas answer
scrapes with the same bytes whether a collector exists or not.  Pure
stdlib (urllib + http.server), like the rest of the fleet layer.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from collections import deque

from .. import telemetry
from ..base import env_float, env_int
from ..telemetry import flight as flight_mod
from ..telemetry.timeseries import (TimeSeriesRing, nearest_rank,
                                    parse_prometheus_text)
from .slo import group_requests, request_failed

__all__ = ["FleetCollector", "ENV_INTERVAL", "ENV_PORT"]

ENV_INTERVAL = "MXTPU_FLEET_COLLECT_INTERVAL"
ENV_PORT = "MXTPU_FLEET_COLLECT_PORT"

# scraped statusz "replica"-section fields recorded verbatim into the
# per-replica ring (gauges: current level each sample)
_GAUGE_FIELDS = ("queue_depth", "running", "in_flight",
                 "waiting_handoffs", "kv_utilization",
                 "host_kv_utilization", "max_batch")
# "stats" ground-truth fields (mixed: monotonic totals + percentiles)
_STATS_FIELDS = ("tokens_generated", "prompt_tokens", "completed",
                 "rejected", "preemptions", "decode_tok_per_sec",
                 "total_tok_per_sec", "ttft_ms_p50", "ttft_ms_p99",
                 "tpot_ms_p50", "tpot_ms_p99", "decode_occupancy",
                 "prefix_hits", "prefix_misses",
                 "prefix_resurrections", "prefix_tokens_saved",
                 "prefill_tokens_computed")


class _ReplicaView:
    """Collector-side view of one replica: identity + its ring."""

    __slots__ = ("url", "name", "role", "state", "version", "model",
                 "adapters", "ring",
                 "last_attempt_t", "last_success_t",
                 "consecutive_failures", "total_failures", "scrapes")

    def __init__(self, url, ring_capacity, clock):
        self.url = url.rstrip("/")
        self.name = self.url
        self.role = "both"
        self.state = "unknown"
        self.version = None
        # catalog identity: carried checkpoint + registered adapter
        # ids (None until a scrape advertises them)
        self.model = None
        self.adapters = None
        self.ring = TimeSeriesRing(ring_capacity, clock=clock)
        self.last_attempt_t = None
        self.last_success_t = None
        self.consecutive_failures = 0
        self.total_failures = 0
        self.scrapes = 0


class FleetCollector:
    """Scrape + aggregate + ingest + serve; see the module docstring.

    Args (env default in parens):
      urls: replica base URLs to scrape (grow/shrink later with
        ``add_replica``/``remove_replica``).
      router: optional ``fleet.Router`` — membership then FOLLOWS the
        router's (supervisor respawns propagate automatically).
      interval_s: scrape period (``MXTPU_FLEET_COLLECT_INTERVAL``, 1.0).
        ``start()`` launches the scrape thread; tests drive
        ``scrape()`` manually.
      port: HTTP port for ``/fleetz`` + ``/trace``
        (``MXTPU_FLEET_COLLECT_PORT``; 0 = ephemeral — read ``.port``;
        None/unset = no server).
      timeout_s: per-replica scrape timeout (2.0) — one hung replica
        costs its own thread this much, never the pass.
      ring_capacity: samples kept per replica (256).
      stale_after: missed intervals before a replica's series is
        marked stale and excluded from totals (3.0).
      rate_window_s: trailing window for the windowed rates (30.0).
      slo_spec: ``MXTPU_SLO_SPEC`` override; a non-empty spec attaches
        an ``SLOEvaluator`` evaluated after every scrape pass.
      clock: injectable monotonic clock (fake-clock tests drive
        staleness, windows and burn rates deterministically).
    """

    def __init__(self, urls=(), router=None, interval_s=None, port=None,
                 timeout_s=2.0, ring_capacity=256, stale_after=3.0,
                 rate_window_s=30.0, trace_capacity=4096,
                 annotation_capacity=512, slo_spec=None,
                 clock=time.monotonic):
        self.interval_s = (float(interval_s) if interval_s is not None
                           else env_float(ENV_INTERVAL, 1.0))
        if port is None:
            env_port = env_int(ENV_PORT, -1)
            port = env_port if env_port >= 0 else None
        self._requested_port = port
        self.port = None
        self.timeout_s = float(timeout_s)
        self.ring_capacity = int(ring_capacity)
        self.stale_after = float(stale_after)
        self.rate_window_s = float(rate_window_s)
        self.router = router
        self.clock = clock
        self._lock = threading.RLock()
        self._views = {}                     # guarded-by: _lock
        self._scrape_passes = 0              # guarded-by: _lock
        self._traces = deque(maxlen=int(trace_capacity))  # guarded-by: _lock
        self._traces_received = 0            # guarded-by: _lock
        self._traces_bad = 0                 # guarded-by: _lock
        self._annotations = deque(maxlen=int(annotation_capacity))  # guarded-by: _lock
        for u in urls:
            self._views[u.rstrip("/")] = _ReplicaView(
                u, self.ring_capacity, clock)
        self._server = None
        self._scrape_thread = None
        self._stop_evt = threading.Event()
        self._m_scrape_failures = telemetry.counter(
            "mxtpu_fleet_scrape_failures_total",
            "per-replica collector scrape failures", ("replica",))
        self._m_traces = telemetry.counter(
            "mxtpu_fleet_collector_traces_total",
            "request-trace lines received on /trace", ("outcome",))
        # SLO layer (fleet/slo.py): attached when a spec is configured
        self.slo = None
        if slo_spec is None:
            import os

            slo_spec = os.environ.get("MXTPU_SLO_SPEC") or ""
        if slo_spec:
            from .slo import SLOEvaluator, parse_slo_spec

            self.slo = SLOEvaluator(parse_slo_spec(slo_spec), self,
                                    clock=clock)

    # -- membership ----------------------------------------------------------
    def add_replica(self, url):
        with self._lock:
            url = url.rstrip("/")
            if url not in self._views:
                self._views[url] = _ReplicaView(url, self.ring_capacity,
                                                self.clock)

    def remove_replica(self, url):
        with self._lock:
            self._views.pop(url.rstrip("/"), None)

    def views(self):
        with self._lock:
            return list(self._views.values())

    def _sync_membership(self):
        """With a router attached, membership follows ITS replica list
        (supervisor respawns propagate without extra wiring)."""
        if self.router is None:
            return
        urls = {r.url for r in self.router.replicas()}
        with self._lock:
            for u in urls - set(self._views):
                self._views[u] = _ReplicaView(u, self.ring_capacity,
                                              self.clock)
            for u in set(self._views) - urls:
                del self._views[u]

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        """Launch the HTTP endpoint (when a port is configured) and
        the background scrape thread."""
        if self._requested_port is not None and self._server is None:
            self._server = _serve(self)
            self.port = self._server.server_address[1]
        if self.interval_s > 0 and self._scrape_thread is None:
            self._scrape_thread = threading.Thread(
                target=self._scrape_loop, daemon=True,
                name="mxtpu-fleet-collector")
            self._scrape_thread.start()
        return self

    def stop(self):
        self._stop_evt.set()
        if self._scrape_thread is not None:
            self._scrape_thread.join(timeout=5)
            self._scrape_thread = None
        server, self._server = self._server, None
        if server is not None:
            threading.Thread(target=server.shutdown,
                             daemon=True).start()
            try:
                server.server_close()
            except OSError:
                pass  # mxtpu-lint: disable=swallowed-exception (port
                # already torn down; nothing to record at shutdown)

    @property
    def url(self):
        return (f"http://127.0.0.1:{self.port}"
                if self.port is not None else None)

    def _scrape_loop(self):
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.scrape()
            except Exception:
                telemetry.counter(
                    "mxtpu_fleet_collector_errors_total",
                    "collector scrape-pass failures").inc()

    # -- scraping ------------------------------------------------------------
    def scrape(self):
        """One concurrent pass over every replica (each isolated in
        its own thread + try block: a hung replica burns its own
        timeout, a broken one only its own series), then refresh the
        aggregate gauges and — when configured — evaluate the SLOs.
        Returns ``{"replicas": n, "ok": n, "failed": n}``."""
        self._sync_membership()
        views = self.views()
        results = {}
        threads = [threading.Thread(target=self._scrape_one,
                                    args=(v, results), daemon=True)
                   for v in views]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.timeout_s + 1.0)
        with self._lock:
            self._scrape_passes += 1
        self._update_agg_gauges()
        if self.slo is not None:
            self.slo.evaluate()
        ok = sum(1 for v in results.values() if v)
        return {"replicas": len(views), "ok": ok,
                "failed": len(views) - ok}

    def _scrape_one(self, view, results):
        now = self.clock()
        with self._lock:
            view.last_attempt_t = now
        try:
            with urllib.request.urlopen(f"{view.url}/statusz.json",
                                        timeout=self.timeout_s) as resp:
                snap = json.loads(resp.read())
            sec = snap.get("replica") or {}
            values = self._flatten_replica(sec)
        except (OSError, ValueError):
            with self._lock:
                view.consecutive_failures += 1
                view.total_failures += 1
            self._m_scrape_failures.labels(replica=view.name).inc()
            results[view.url] = False
            return
        # /metrics is best-effort on top: a replica predating the
        # endpoint (or with an empty registry) must not fail the
        # statusz scrape that carries the ground truth
        try:
            with urllib.request.urlopen(f"{view.url}/metrics",
                                        timeout=self.timeout_s) as resp:
                values.update(parse_prometheus_text(
                    resp.read().decode("utf-8", "replace")))
        except (OSError, ValueError):
            pass  # mxtpu-lint: disable=swallowed-exception (optional
            # second endpoint; the statusz scrape above already
            # succeeded and failures there ARE counted)
        view.ring.append(values, now=self.clock())
        with self._lock:
            view.name = sec.get("replica") or view.name
            view.role = sec.get("role") or "both"
            view.state = sec.get("state") or "unknown"
            view.version = sec.get("version")
            view.model = sec.get("model")
            adp = sec.get("adapters")
            view.adapters = (list(adp.get("ids") or [])
                             if isinstance(adp, dict) else None)
            view.consecutive_failures = 0
            view.last_success_t = self.clock()
            view.scrapes += 1
        results[view.url] = True

    @staticmethod
    def _flatten_replica(sec):
        """Flatten one scraped ``replica`` statusz section into ring
        series (same ``name{label=value}`` keying the registry
        flattener uses)."""
        values = {}
        for f in _GAUGE_FIELDS:
            v = sec.get(f)
            if v is not None:
                values[f] = v
        stats = sec.get("stats") or {}
        for f in _STATS_FIELDS:
            v = stats.get(f)
            if v is not None:
                values[f] = v
        for reason, n in (stats.get("reject_reasons") or {}).items():
            values[f"rejected{{reason={reason}}}"] = n
        for tenant, done in (stats.get("tenants") or {}).items():
            values[f"tenant_completed{{tenant={tenant}}}"] = done
        # per-adapter goodput (catalog traffic attribution — rows
        # exist only for requests that carried an adapter id; the
        # replica wire schema pre-flattens the engine's nested
        # ``adapters`` rows into these two series)
        for a, done in (stats.get("adapter_completed") or {}).items():
            values[f"adapter_completed{{adapter={a}}}"] = done
        for a, toks in (stats.get("adapter_tokens") or {}).items():
            values[f"adapter_tokens{{adapter={a}}}"] = toks
        for k, v in (sec.get("handoff") or {}).items():
            if isinstance(v, (int, float)):
                values[f"handoff_{k}"] = v
        # performance-attribution summary (replicas predating it, or
        # running MXTPU_PERF_ATTRIB=0, ship no section — None-skipped
        # like every other absent field)
        for k, v in (sec.get("perf") or {}).items():
            if isinstance(v, (int, float)):
                values[f"perf_{k}"] = v
        # fleet KV fabric: peer-to-peer pull counters plus the size of
        # the radix summary the replica is advertising to the router
        # (replicas predating the fabric — or running with the prefix
        # cache off — ship neither section)
        for k, v in (sec.get("pull") or {}).items():
            if isinstance(v, (int, float)):
                values[f"pull_{k}"] = v
        summary = sec.get("kv_summary")
        if isinstance(summary, dict) \
                and isinstance(summary.get("keys"), (int, float)):
            values["summary_keys"] = summary["keys"]
        return values

    def is_stale(self, view, now=None):
        """A replica is stale once ``stale_after`` intervals passed
        without a successful scrape (or it never answered one).
        Manually-driven collectors (``interval_s=0``, tests/benches)
        measure staleness against a 1-second floor."""
        now = self.clock() if now is None else now
        if view.last_success_t is None:
            return view.last_attempt_t is not None
        return now - view.last_success_t > self.stale_after * \
            max(self.interval_s, 1.0)

    # -- pushed request traces ----------------------------------------------
    def on_trace_line(self, rec):
        """Ingest one terminal request-trace line (the JSONL record
        shape ``telemetry/request_trace.py`` writes).  Returns True
        when the record parsed into a usable summary."""
        try:
            summary = _trace_summary(rec, self.clock())
        except (TypeError, ValueError, KeyError, AttributeError):
            with self._lock:
                self._traces_bad += 1
            self._m_traces.labels(outcome="bad").inc()
            return False
        with self._lock:
            self._traces.append(summary)
            self._traces_received += 1
        self._m_traces.labels(outcome="ok").inc()
        return True

    def trace_records(self, window_s=None, now=None):
        """Trace summaries received within the trailing window (all
        when ``window_s`` is None), oldest first."""
        now = self.clock() if now is None else now
        with self._lock:
            if window_s is None:
                return list(self._traces)
            cutoff = now - window_s
            return [t for t in self._traces if t["t"] >= cutoff]

    # -- fleet timeline annotations ------------------------------------------
    def annotate(self, kind, **fields):
        """Append one annotation to the fleet timeline (supervisor
        lifecycle events, firing SLO alerts).  Also lands in the
        process flight-recorder ring, so post-mortems see it."""
        ev = dict(fields)
        ev["kind"] = str(kind)
        # operators correlate annotations with their logs by wall time;
        # the monotonic stamp drives windowing
        # mxtpu-lint: disable=wall-clock (display timestamp)
        ev["time"] = round(time.time(), 3)
        ev["t"] = self.clock()
        with self._lock:
            self._annotations.append(ev)
        flight_mod.recorder().record(
            "fleet_annotation", annotation=str(kind),
            **{k: v for k, v in ev.items()
               if k not in ("kind", "t", "time")})
        return ev

    def annotations(self, limit=50):
        with self._lock:
            return list(self._annotations)[-int(limit):]

    # -- SLO support ---------------------------------------------------------
    def request_flight_dump(self, url, reason, capture_id=None):
        """Ask one replica to dump its flight-recorder ring (``POST
        /flight_dump`` — the replica's recorder rate-limits per
        reason).  ``capture_id`` names a profiler capture fired
        alongside, so the dump links to its device trace.  Returns
        the remote path or None; never raises."""
        body = {"reason": reason}
        if capture_id:
            body["capture_id"] = capture_id
        try:
            req = urllib.request.Request(
                f"{url.rstrip('/')}/flight_dump",
                data=json.dumps(body).encode(),
                method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                return json.loads(resp.read()).get("path")
        except (OSError, ValueError):
            return None

    def request_profile_capture(self, url, duration_s=1.0,
                                reason="fleet_capture"):
        """Ask one replica to open a bounded profiler capture window
        (``POST /profilez``).  Returns the response payload (carrying
        the capture ``id``) on 200, None on any refusal (409 conflict,
        429 rate limit) or wire failure; never raises — the SLO layer
        calls this from its evaluation loop."""
        try:
            req = urllib.request.Request(
                f"{url.rstrip('/')}/profilez",
                data=json.dumps({"duration_s": float(duration_s),
                                 "reason": str(reason)[:64]}).encode(),
                method="POST",
                headers={"Content-Type": "application/json"})
            # profiler cold-start can take seconds before the 200 comes
            # back, so don't reuse the (tight) scrape timeout here
            with urllib.request.urlopen(
                    req, timeout=max(self.timeout_s, 15.0)) as resp:
                return json.loads(resp.read())
        except (OSError, ValueError):
            return None

    def capture_fleet(self, duration_s=1.0, roles=None,
                      reason="fleet_capture"):
        """Open wall-clock-aligned capture windows across the fleet:
        one concurrent ``POST /profilez`` per (optionally role-
        filtered) replica, so every accepted window starts within one
        request round-trip of the others and each capture's
        ``started_epoch`` places it on the shared timeline.

        Returns ``{replica_name: payload-or-None}`` — None marks a
        replica that refused (active window, rate limit) or failed;
        accepted payloads carry the capture ``id`` to poll via ``GET
        /profilez/<id>``.  The fleet annotation ring records the sweep
        so /fleetz readers see which captures belong together."""
        with self._lock:
            targets = [(v.name, v.url) for v in self._views.values()
                       if roles is None or v.role in roles]
        results = {}
        threads = []

        def one(name, url):
            results[name] = self.request_profile_capture(
                url, duration_s=duration_s, reason=reason)

        for name, url in targets:
            t = threading.Thread(target=one, args=(name, url),
                                 daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=max(self.timeout_s, 15.0) + float(duration_s))
        self.annotate(
            "fleet_capture", reason=str(reason)[:64],
            duration_s=float(duration_s),
            captures=[{"replica": n,
                       "id": (r or {}).get("id"),
                       "accepted": r is not None}
                      for n, r in sorted(results.items())])
        return results

    def url_for_replica(self, name):
        """Replica name -> base URL (trace lines carry names; flight
        dumps need URLs)."""
        with self._lock:
            for v in self._views.values():
                if v.name == name:
                    return v.url
        return None

    # -- aggregation ---------------------------------------------------------
    def _replica_row(self, view, now):
        ring = view.ring
        row = {"url": view.url, "replica": view.name, "role": view.role,
               "state": view.state,
               "version": view.version,
               "model": view.model,
               "adapters": view.adapters,
               "stale": self.is_stale(view, now),
               "consecutive_failures": view.consecutive_failures,
               "total_failures": view.total_failures,
               "scrapes": view.scrapes,
               "age_s": (round(now - view.last_success_t, 3)
                         if view.last_success_t is not None else None),
               "samples": len(ring)}
        if row["stale"]:
            # a stale replica's last-scraped load signals are dead
            # data: past the age cap the row keeps identity/failure
            # fields only, so neither the role aggregates nor a policy
            # reader (the autoscaler) can scale on a corpse's queue
            return row
        latest = {f: ring.latest(f) for f in _GAUGE_FIELDS}
        totals = {f: ring.latest(f)
                  for f in ("tokens_generated", "completed", "rejected")}
        row.update({k: v for k, v in latest.items() if v is not None})
        row.update({k: int(v) for k, v in totals.items()
                    if v is not None})
        rate = ring.rate("tokens_generated", self.rate_window_s,
                         now=now)
        if rate is not None:
            row["tok_per_sec"] = round(rate, 3)
        for f in ("ttft_ms_p99", "tpot_ms_p99", "perf_mfu",
                  "perf_achieved_tflops", "perf_tok_flops",
                  "perf_cost_per_1k_tokens_s", "perf_sampled",
                  "prefix_hits", "prefix_resurrections",
                  "prefix_tokens_saved", "summary_keys",
                  "pull_attempts", "pull_blocks_imported"):
            v = ring.latest(f)
            if v is not None:
                row[f] = v
        return row

    def fleet_view(self):
        """The ``/fleetz.json`` payload: per-replica rows, per-role and
        whole-fleet aggregates (fresh replicas only — stale ones are
        listed and counted but never summed), SLO state, the recent
        annotation tail and the pushed-trace window summary."""
        now = self.clock()
        # ONE membership snapshot for the whole assembly: the scrape
        # thread may add/remove replicas concurrently, and a row built
        # from one snapshot must never be looked up in another
        views = self.views()
        by_url = {v.url: v for v in views}
        rows = [self._replica_row(v, now) for v in views]
        roles = {}
        # model-catalog aggregates: per-model traffic/goodput across
        # fresh replicas carrying that checkpoint tag, plus adapter
        # placement counts (how many replicas host each adapter id)
        models = {}
        for row in rows:
            tag = row.get("model")
            if tag is not None:
                m = models.setdefault(tag, {
                    "replicas": 0, "stale": 0, "completed": 0,
                    "tokens_generated": 0, "tok_per_sec": 0.0,
                    "adapters": {}, "adapter_goodput": {},
                    "adapter_tokens": {}})
                m["replicas"] += 1
                if row["stale"]:
                    m["stale"] += 1
                else:
                    m["completed"] += int(row.get("completed") or 0)
                    m["tokens_generated"] += \
                        int(row.get("tokens_generated") or 0)
                    m["tok_per_sec"] = round(
                        m["tok_per_sec"]
                        + (row.get("tok_per_sec") or 0.0), 3)
                    for a in row.get("adapters") or []:
                        m["adapters"][a] = m["adapters"].get(a, 0) + 1
                    mview = by_url[row["url"]]
                    for key in mview.ring.names():
                        for series, out in (
                                ("adapter_completed", "adapter_goodput"),
                                ("adapter_tokens", "adapter_tokens")):
                            pre = f"{series}{{adapter="
                            if key.startswith(pre):
                                a = key[len(pre):-1]
                                m[out][a] = m[out].get(a, 0) \
                                    + int(mview.ring.latest(key) or 0)
            agg = roles.setdefault(row["role"], {
                "replicas": 0, "stale": 0, "queue_depth": 0,
                "running": 0, "waiting_handoffs": 0,
                "tokens_generated": 0, "completed": 0, "rejected": 0,
                "tok_per_sec": 0.0, "achieved_tflops": 0.0,
                "_kv": [], "_hkv": [],
                "_ttft": [], "_tpot": [], "_mfu": [],
                "tenant_goodput": {}, "versions": {}})
            agg["replicas"] += 1
            if row["stale"]:
                agg["stale"] += 1
                continue
            if row.get("version"):
                # fresh replicas by deploy tag: >1 key mid-rollout
                agg["versions"][row["version"]] = \
                    agg["versions"].get(row["version"], 0) + 1
            for f in ("queue_depth", "running", "waiting_handoffs",
                      "tokens_generated", "completed", "rejected"):
                agg[f] += int(row.get(f) or 0)
            agg["tok_per_sec"] = round(
                agg["tok_per_sec"] + (row.get("tok_per_sec") or 0.0), 3)
            if row.get("kv_utilization") is not None:
                agg["_kv"].append(row["kv_utilization"])
            if row.get("host_kv_utilization") is not None:
                agg["_hkv"].append(row["host_kv_utilization"])
            if row.get("ttft_ms_p99") is not None:
                agg["_ttft"].append(row["ttft_ms_p99"])
            if row.get("tpot_ms_p99") is not None:
                agg["_tpot"].append(row["tpot_ms_p99"])
            # role-keyed goodput: MFU averages over the role's fresh
            # replicas, achieved TFLOP/s sums to the role's delivered
            # compute rate (both absent until a replica has sampled)
            if row.get("perf_mfu") is not None:
                agg["_mfu"].append(row["perf_mfu"])
            agg["achieved_tflops"] = round(
                agg["achieved_tflops"]
                + (row.get("perf_achieved_tflops") or 0.0), 6)
            view = by_url[row["url"]]
            for key in view.ring.names():
                if key.startswith("tenant_completed{tenant="):
                    tenant = key[len("tenant_completed{tenant="):-1]
                    agg["tenant_goodput"][tenant] = \
                        agg["tenant_goodput"].get(tenant, 0) \
                        + int(view.ring.latest(key) or 0)
        for agg in roles.values():
            agg["kv_utilization_mean"] = _mean(agg.pop("_kv"))
            agg["host_kv_utilization_mean"] = _mean(agg.pop("_hkv"))
            ttfts, tpots = agg.pop("_ttft"), agg.pop("_tpot")
            agg["ttft_ms_p99_max"] = max(ttfts) if ttfts else None
            agg["tpot_ms_p99_max"] = max(tpots) if tpots else None
            agg["mfu_mean"] = _mean(agg.pop("_mfu"))
        totals = {"replicas": len(rows),
                  "stale": sum(1 for r in rows if r["stale"])}
        for f in ("queue_depth", "running", "waiting_handoffs",
                  "tokens_generated", "completed", "rejected"):
            totals[f] = sum(a[f] for a in roles.values())
        totals["tok_per_sec"] = round(
            sum(a["tok_per_sec"] for a in roles.values()), 3)
        with self._lock:
            passes = self._scrape_passes
            received, bad = self._traces_received, self._traces_bad
        window = self._trace_window_summary(now)
        return {
            # mxtpu-lint: disable=wall-clock (display timestamp)
            "time": round(time.time(), 3),
            "interval_s": self.interval_s,
            "scrape_passes": passes,
            "rate_window_s": self.rate_window_s,
            "replicas": rows,
            "roles": roles,
            "models": models,
            "totals": totals,
            "slo": None if self.slo is None else self.slo.statusz(),
            "annotations": self.annotations(),
            "traces": dict(received=received, bad=bad, **window),
        }

    def _trace_window_summary(self, now):
        """Trailing-window request summary — counted per CLIENT
        request (lines grouped by trace id, the SLO layer's unit),
        never per line: one request observed by its engine AND the
        router is one request."""
        recs = self.trace_records(self.rate_window_s, now=now)
        verdicts = [request_failed(g) for g in group_requests(recs)]
        finished = sum(1 for v in verdicts if v is False)
        failed = sum(1 for v in verdicts if v is True)
        ttfts = sorted(r["ttft_s"] for r in recs
                       if r["status"] == "finished"
                       and r.get("ttft_s") is not None)
        tpots = sorted(r["tpot_s"] for r in recs
                       if r["status"] == "finished"
                       and r.get("tpot_s") is not None)
        return {
            "window_requests": len(verdicts),
            "window_finished": finished,
            "window_rejected": failed,
            "window_availability": (
                round(finished / (finished + failed), 4)
                if finished + failed else None),
            "window_ttft_p99_ms": _p99_ms(ttfts),
            "window_tpot_p99_ms": _p99_ms(tpots),
        }

    def _update_agg_gauges(self):
        """Mirror the per-role aggregates into the collector process's
        metrics registry — the third face of the three-view agreement
        (fleet view == sum of replica ground truth == registry
        series).  No-ops unless MXTPU_TELEMETRY is on."""
        view = self.fleet_view()
        for role, agg in view["roles"].items():
            for field, value in (
                    ("queue_depth", agg["queue_depth"]),
                    ("running", agg["running"]),
                    ("waiting_handoffs", agg["waiting_handoffs"]),
                    ("tokens_generated", agg["tokens_generated"]),
                    ("completed", agg["completed"]),
                    ("rejected", agg["rejected"]),
                    ("tok_per_sec", agg["tok_per_sec"]),
                    ("replicas", agg["replicas"]),
                    ("stale", agg["stale"]),
                    ("achieved_tflops", agg["achieved_tflops"]),
                    ("mfu_mean", agg["mfu_mean"])):
                if value is None:     # no replica has sampled yet
                    continue
                telemetry.gauge(
                    f"mxtpu_fleet_agg_{field}",
                    f"fleet-aggregated {field} by role",
                    ("role",)).labels(role=role).set(value)

    def statusz(self):
        """Compact collector self-description (registered nowhere by
        default; embedders may hook it onto their /statusz)."""
        with self._lock:
            return {"replicas": len(self._views),
                    "scrape_passes": self._scrape_passes,
                    "traces_received": self._traces_received,
                    "interval_s": self.interval_s,
                    "port": self.port,
                    "slo": None if self.slo is None
                    else [o.key for o in self.slo.objectives]}


def _mean(vals):
    return round(sum(vals) / len(vals), 4) if vals else None


def _p99_ms(sorted_vals):
    v = nearest_rank(sorted_vals, 0.99)
    return None if v is None else round(v * 1e3, 3)


def _trace_summary(rec, now):
    """Fold one pushed trace line into the collector's summary shape:
    terminal status, reason, replica identity, TTFT and mean TPOT.

    TTFT is ``submitted -> first prefill_end`` (the engine emits the
    request's first token at prefill end); TPOT is the decode span
    divided by the tokens it emitted."""
    events = rec.get("events") or []
    status = str(rec.get("status"))
    reason = None
    t0 = events[0]["t"] if events else None
    first_tok_t = None
    last_decode_t = None
    replica = rec.get("replica")
    for ev in events:
        name = ev.get("ev")
        if name == "prefill_end" and first_tok_t is None:
            first_tok_t = ev["t"]
        elif name == "decode":
            last_decode_t = ev["t"]
        elif name == "rejected":
            reason = ev.get("reason")
        if name in ("finished", "rejected", "cancelled") \
                and ev.get("replica"):
            # a router-side line attributes its terminal to the replica
            # that actually served the request — SLO offenders must be
            # the serving replica, never the literal string "router"
            replica = ev["replica"]
    ttft = (first_tok_t - t0
            if first_tok_t is not None and t0 is not None else None)
    generated = int(rec.get("generated") or 0)
    tpot = None
    if (first_tok_t is not None and last_decode_t is not None
            and generated > 1):
        tpot = max(0.0, (last_decode_t - first_tok_t) / (generated - 1))
    total = (events[-1]["t"] - t0 if len(events) > 1 else None)
    return {"t": now, "trace_id": rec.get("trace_id"),
            "rid": rec.get("rid"), "replica": replica,
            # which tracer wrote the line: "serve" (an engine — its
            # own schema omits the field) vs "router" (the client-
            # truth line the SLO availability verdict prefers)
            "source": rec.get("source") or "serve",
            "tenant": rec.get("tenant"), "status": status,
            "reason": reason, "generated": generated,
            "ttft_s": ttft, "tpot_s": tpot, "total_s": total}


# -- the /fleetz + /trace HTTP front ----------------------------------------
def _serve(collector):
    """Start the collector's stdlib HTTP server (daemon thread)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/fleetz.json", "/fleetz"):
                view = collector.fleet_view()
                if self.path.endswith(".json"):
                    self._send(200, json.dumps(view,
                                               default=str).encode())
                else:
                    self._send(200, render_fleetz_html(view).encode(),
                               "text/html; charset=utf-8")
            elif self.path == "/healthz":
                self._send(200, json.dumps(
                    {"status": "ok",
                     "replicas": len(collector.views())}).encode())
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path not in ("/trace", "/annotate"):
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
            except (ValueError, OSError):
                self._send(400, b'{"error": "bad_body"}')
                return
            if self.path == "/annotate":
                try:
                    rec = json.loads(raw or b"{}")
                    kind = str(rec.pop("kind", "external"))
                except (ValueError, AttributeError):
                    self._send(400, b'{"error": "bad_json"}')
                    return
                collector.annotate(kind, **{str(k): v
                                            for k, v in rec.items()})
                self._send(200, b'{"ok": true}')
                return
            ok = bad = 0
            # /trace accepts one JSON object per line (NDJSON) — one
            # malformed line counts bad without dropping its batch
            for line in (raw or b"").splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    bad += 1
                    continue
                if collector.on_trace_line(rec):
                    ok += 1
                else:
                    bad += 1
            self._send(200, json.dumps({"ok": ok, "bad": bad}).encode())

        def log_message(self, *args):       # no stderr chatter
            pass

    server = ThreadingHTTPServer(("127.0.0.1",
                                  collector._requested_port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="mxtpu-fleet-collector-http")
    thread.start()
    return server


def render_fleetz_html(view):
    """Dependency-free HTML rendering of :meth:`fleet_view` — one
    section per region, JSON pretty-printed (the statusz style)."""
    import html as _html

    parts = ["<!doctype html><html><head><title>mxtpu /fleetz</title>",
             "<style>body{font-family:monospace;margin:1em}",
             "h2{border-bottom:1px solid #999;margin:1em 0 .2em}",
             "pre{margin:.2em 0 .8em;white-space:pre-wrap}</style>",
             "</head><body><h1>mxtpu /fleetz</h1>"]
    for name in ("totals", "roles", "slo", "replicas", "traces",
                 "annotations"):
        parts.append(f"<h2>{_html.escape(name)}</h2>")
        parts.append("<pre>"
                     + _html.escape(json.dumps(view.get(name), indent=2,
                                               default=str))
                     + "</pre>")
    parts.append("</body></html>")
    return "".join(parts)
