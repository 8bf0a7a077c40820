"""One fleet replica: a stdlib-HTTP serving front over ``serve.Engine``.

The port of ``mxnet_tpu/fleet/replica.py``: the same endpoints, wire
records, lifecycle and chaos hooks, over the port's engine.

  POST /generate       JSON {"prompt": [ids], "max_new_tokens": N,
                       "deadline_s"?, "tenant"?, "request_id"?} ->
                       {"tokens": [...], "rid", "trace_id", "replica"}.
                       503 + {"retriable": true, "error": reason} for
                       back-pressure/draining (retry on a sibling);
                       400 for requests that can never succeed
                       (too long for the model, expired deadline).
                       ``X-MXTPU-Trace-Id`` propagates the router's
                       trace id into the engine's RequestTracer so one
                       request's hops across replicas share a timeline.
  GET  /healthz        cheap liveness/readiness: {"state": "ready" |
                       "draining" | "dead", in_flight, queue_depth}.
  POST /drain          stop admitting, finish in-flight work
                       token-identically, report {"state": "draining"}.
  GET  /statusz.json   the full statusz snapshot plus a "replica"
                       section — the router's load-balancing signal
                       (queue depth + KV occupancy).
  GET  /metrics        the telemetry registry as Prometheus text.
  POST /flight_dump    dump the flight recorder's ring.
  /profilez            answered 501: on-demand profiler windows are
                       ROADMAP §A item 14b-2.

Idempotency: a ``request_id`` names the client request across retries.
A re-send of an id that already completed returns the CACHED response
(no recompute, no duplicate); a re-send while the first attempt is
still in flight attaches to it: at-most-once execution per request id
per replica, exactly one response per id at the client.

Roles (``role=`` / ``MXTPU_FLEET_ROLE``, default ``"both"``):

* ``"both"``    — ``/generate`` runs prefill and decode; ``/handoff``
  ingests work too.
* ``"prefill"`` — ``/generate`` runs admission and prefill only, then
  answers with a ``handoff`` envelope: the prompt's cached KV chain as
  content-keyed records (``BlockManager.export_blocks``, device blocks
  copied to the host).  ``/handoff`` is refused (503 ``wrong_role``).
* ``"decode"``  — ``/generate`` is refused (503 ``wrong_role``);
  ``POST /handoff`` parks a prefill replica's records in the host KV
  tier under their keys (``import_blocks``: the role needs
  ``host_kv_bytes`` > 0), then serves the request: the radix walk hits
  the imported chain, the ``restore`` program puts it back on the
  device, and only the final span recomputes.  ``POST /handoff_probe``
  answers which keys this replica already caches, so a sender skips
  those bytes.

Every record is verified against its payload digest and its chain hash
at import, so a truncated, corrupt or dropped payload degrades to
recompute from the prompt (the body always carries it).

Wire records are the reference's: each array's raw bytes, base64, in
the engine's cache dtype (``host_block_spec`` names it: ``bfloat16``,
``float32`` or ``int8``, with the two float32 scale arrays under int8
K/V), and a sha1 digest of the bytes.  The port reads a ``bfloat16``
payload through an int16 buffer viewed as ``torch.bfloat16``, so equal
K/V give equal bytes and digests in both packages.

Cache-aware routing: ``/healthz`` and the ``/statusz.json`` replica
section carry ``kv_summary`` (``BlockManager.summary()``, a
``RadixSummary`` snapshot).  A ``/generate`` body with a ``kv_pull``
hint makes this replica pull the prompt's chain from the named
sibling's ``POST /chain_export`` into its host tier through the same
verified import path (``MXTPU_ROUTE_PULL_TIMEOUT``); every failure
degrades to recompute.

Catalog: ``model=`` / ``MXTPU_FLEET_MODEL`` and, on an adapters-mode
engine, the registered LoRA adapters ride ``/healthz`` and the replica
section only when set.  ``/generate`` takes ``"model"`` / ``"adapter"``
(malformed or unknown values are clean 400s, all slots pinned a
retriable ``adapter_slots``), and ``/load_adapter``,
``/unload_adapter`` and ``/adapter_export`` manage the
``AdapterStore``.

Device access and CUDA graphs: the engine captures its programs in
``"global"`` capture mode on the step thread (``--warmup none``, or a
bucket warm-up skipped), and a CUDA call from any other thread during a
capture invalidates it.  So every handler path that touches the device
takes ``_step_lock``, which the step thread holds around
``engine.step()``: the handoff and ``/chain_export`` gathers, and a
submit naming an adapter (its first request loads the adapter's device
slot).  ``/healthz`` and ``/statusz.json`` read host state only.

Faults (``faults.FaultInjector``) hook ``/generate`` and ``/handoff``
arrivals: kill, delay, refuse or hang at a deterministic request index.
A kill is a hard death: ``on_kill`` defaults to an in-process crash
(HTTP socket torn down mid-request, engine abandoned without shutdown);
the process front (``python -m mxnet_tpu_torch.fleet.serve_replica``)
passes ``os._exit``.  ``MXTPU_FAULT_HANDOFF_DELAY`` (a slow wire per
handoff arrival) and ``MXTPU_FAULT_HANDOFF_DROP`` (the first N
handoffs' records discarded and recomputed) ride the replica too.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import hashlib
import json
import os
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler

import numpy as np
import torch

from .. import telemetry
from ..base import env_float, env_int
from ..serve.scheduler import FINISHED, QueueFull, REJECTED
from ..telemetry import statusz as statusz_mod
from . import faults as faults_mod

__all__ = ["ReplicaServer", "ROLES", "STARTING", "READY", "DRAINING",
           "DEAD", "RETRIABLE_REASONS", "PERMANENT_REASONS",
           "TRACE_HEADER"]

STARTING = "starting"
READY = "ready"
DRAINING = "draining"
DEAD = "dead"

# fleet roles: "both" interleaves prefill+decode on one engine (the
# inert default), "prefill"/"decode" split them across replicas with
# KV-block handoff over the wire (DistServe-style disaggregation)
ROLES = ("both", "prefill", "decode")

# rejection reasons a sibling replica might still serve (503) vs.
# requests no replica can ever serve (400) — the router's retry
# decision rides this split
RETRIABLE_REASONS = ("queue_full", "tenant_share", "deadline", "draining",
                     "adapter_slots")
PERMANENT_REASONS = ("exceeds_max_len", "exceeds_cache",
                     "deadline_at_submit")

TRACE_HEADER = "X-MXTPU-Trace-Id"

_DONE_CACHE_SIZE = 1024

# the wire's dtype names (``host_block_spec``'s) -> (bytes an element,
# numpy type the bytes are read as, torch dtype of the host copy): a
# bfloat16 payload is read as int16 and viewed as torch.bfloat16
_WIRE_DTYPES = {"bfloat16": (2, np.int16, torch.bfloat16),
                "float16": (2, np.float16, torch.float16),
                "float32": (4, np.float32, torch.float32),
                "int8": (1, np.int8, torch.int8)}

# on-demand profiler windows (POST /profilez and its knobs) are ROADMAP
# §A item 14b-2
_PROFILEZ_ENV = ("MXTPU_PROFILEZ_DIR", "MXTPU_PROFILEZ_MAX_S",
                 "MXTPU_PROFILEZ_INTERVAL_S")
_PROFILEZ_UNPORTED = {
    "error": "not_ported", "retriable": False,
    "detail": "on-demand profiler capture (/profilez) is not ported "
              "yet (ROADMAP §A item 14b-2)"}


def _raw_bytes(a):
    """One host copy's bytes in memory order (a CPU tensor, bfloat16
    included: numpy has no bfloat16)."""
    return a.detach().contiguous().reshape(-1).view(torch.uint8) \
        .numpy().tobytes()


def _errors(site):
    return telemetry.counter("mxtpu_fleet_replica_errors_total",
                             "replica-front internal failures",
                             ("site",)).labels(site=site)


def _handoff_bytes(direction):
    return telemetry.counter(
        "mxtpu_fleet_handoff_bytes_total",
        "KV bytes moved over prefill->decode handoffs",
        ("direction",)).labels(direction=direction)


def _handoff_blocks(result):
    return telemetry.counter(
        "mxtpu_fleet_handoff_blocks_total",
        "handoff record outcomes at the receiving replica",
        ("result",)).labels(result=result)


def _pull_result(outcome):
    return telemetry.counter(
        "mxtpu_fleet_chain_pulls_total",
        "peer-to-peer KV chain pull outcomes at the pulling replica "
        "(ok / false_positive / failed)",
        ("outcome",)).labels(outcome=outcome)


class ReplicaServer:
    """HTTP front + engine step-loop thread for one replica.

    Args:
      engine: a constructed ``serve.Engine`` (this server owns its
        lifecycle from ``start()`` on: ``stop()`` shuts it down).
      host/port: bind address (port 0 = ephemeral; read ``.port``).
      replica_id: name in responses/telemetry (default ``replica-<port>``).
      fault_injector: a ``faults.FaultInjector`` (default: env spec —
        which is empty/no-op unless ``MXTPU_FAULT_SPEC`` is set).
      on_kill: what a *kill* fault does (default: in-process hard stop;
        process replicas pass ``os._exit``).
      poll_s: completion-poll period of waiting request handlers.
      role: ``"both"`` (default) | ``"prefill"`` | ``"decode"`` — the
        disaggregation role (env ``MXTPU_FLEET_ROLE``; see the module
        docstring).  ``"decode"`` requires the engine's host-RAM KV
        tier (``host_kv_bytes`` > 0): handoff records land there.
      handoff_delay_s / handoff_drop: chaos knobs (env
        ``MXTPU_FAULT_HANDOFF_DELAY`` / ``MXTPU_FAULT_HANDOFF_DROP``):
        seconds slept per ``/handoff`` arrival (a simulated slow
        wire), and how many handoffs' KV records to discard before
        import ("arrived truncated" — degrades to recompute).
      version: deploy identity tag (checkpoint digest or a
        ``--version`` string), surfaced on /healthz and
        /statusz.json so mixed fleets mid-rollout stay tellable
        apart; None = untagged.
    """

    def __init__(self, engine, host="127.0.0.1", port=0, replica_id=None,
                 fault_injector=None, on_kill=None, poll_s=0.002,
                 role=None, handoff_delay_s=None, handoff_drop=None,
                 version=None, model=None):
        for var in _PROFILEZ_ENV:
            if os.environ.get(var):
                raise NotImplementedError(
                    f"ReplicaServer: {var} configures on-demand profiler "
                    "capture (/profilez), which is not ported yet "
                    "(ROADMAP §A item 14b-2)")
        self.engine = engine
        self.host = host
        self._requested_port = int(port)
        self.port = None
        self.replica_id = replica_id
        self.faults = (fault_injector if fault_injector is not None
                       else faults_mod.FaultInjector())
        self._on_kill = on_kill if on_kill is not None else self.hard_stop
        self.poll_s = float(poll_s)
        if role is None:
            role = os.environ.get("MXTPU_FLEET_ROLE") or "both"
        if role not in ROLES:
            raise ValueError(
                f"role must be one of {ROLES} (got {role!r})")
        if role == "decode" and engine.blocks.host is None:
            raise ValueError(
                "role='decode' requires the host-RAM KV tier "
                "(Engine(host_kv_bytes=) / MXTPU_SERVE_HOST_KV_BYTES "
                "> 0): handoff records are ingested into it")
        self.role = role
        # deploy identity (checkpoint digest or --version tag): mixed
        # fleets coexist mid-rollout, so every status surface carries
        # it — the collector/deployer tell versions apart by this
        self.version = version
        # catalog identity: the checkpoint this replica carries.  The
        # router filters candidates by it; None = uncataloged (every
        # model-less request matches, model-tagged requests don't)
        if model is None:
            model = os.environ.get("MXTPU_FLEET_MODEL") or None
        self.model = str(model)[:64] if model is not None else None
        self._handoff_delay_s = (
            float(handoff_delay_s) if handoff_delay_s is not None
            else env_float(faults_mod.ENV_HANDOFF_DELAY, 0.0))
        self._lock = threading.RLock()
        # held by the step thread around engine.step() and by every
        # handler path that touches the device (the export gathers, an
        # adapter submit's slot load): a step may capture a CUDA graph
        # in global mode, and a CUDA call from another thread meanwhile
        # invalidates the capture.  Taken before _lock, never inside it
        self._step_lock = threading.Lock()
        self._handoff_drops_left = (
            int(handoff_drop) if handoff_drop is not None
            else env_int(faults_mod.ENV_HANDOFF_DROP, 0))  # guarded-by: _lock
        self._state = STARTING       # guarded-by: _lock
        self._served = 0             # guarded-by: _lock
        self._inflight = {}          # guarded-by: _lock
        self._done_cache = collections.OrderedDict()  # guarded-by: _lock
        # prefill→decode handoff accounting (the replica statusz
        # "handoff" section and the /healthz load signal)
        self._handoff_ingesting = 0      # guarded-by: _lock
        self._handoffs_received = 0      # guarded-by: _lock
        self._handoffs_exported = 0      # guarded-by: _lock
        self._handoff_imported = 0       # guarded-by: _lock
        self._handoff_deduped = 0        # guarded-by: _lock
        self._handoff_rejected = 0       # guarded-by: _lock
        self._handoff_drops = 0          # guarded-by: _lock
        self._handoff_bytes_received = 0  # guarded-by: _lock
        self._handoff_bytes_exported = 0  # guarded-by: _lock
        # fleet KV fabric: peer-to-peer chain pull accounting (the
        # statusz "pull" section CACHE_ROUTE_BENCH.json reads).  A
        # pull is the router-hinted fetch of a sibling's cached chain
        # into THIS replica's host tier; chain_export_* counts the
        # serving side of someone else's pull
        self._pull_timeout_s = env_float("MXTPU_ROUTE_PULL_TIMEOUT", 5.0)
        self._pull_attempts = 0           # guarded-by: _lock
        self._pull_imported = 0           # guarded-by: _lock
        self._pull_deduped = 0            # guarded-by: _lock
        self._pull_rejected = 0           # guarded-by: _lock
        self._pull_false_positives = 0    # guarded-by: _lock
        self._pull_failures = 0           # guarded-by: _lock
        self._pull_bytes_received = 0     # guarded-by: _lock
        self._chain_exports = 0           # guarded-by: _lock
        self._chain_export_blocks = 0     # guarded-by: _lock
        self._chain_export_bytes = 0      # guarded-by: _lock
        self._server = None
        self._http_thread = None
        self._step_thread = None
        self._stop_evt = threading.Event()
        self._work_evt = threading.Event()
        self._health_name = None
        self._statusz_name = None

    # -- lifecycle -----------------------------------------------------------
    @property
    def state(self):
        with self._lock:
            return self._state

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    def start(self):
        """Bind, spin up the HTTP and step threads, go READY."""
        from http.server import ThreadingHTTPServer

        replica = self

        class _Server(ThreadingHTTPServer):
            daemon_threads = True

            def handle_error(self, request, client_address):
                # torn connections are EXPECTED here (aborted handlers
                # during a kill fault, clients timing out) — count
                # instead of stack-tracing to stderr per event
                _errors("http").inc()

        self._server = _Server((self.host, self._requested_port),
                               _Handler)
        self._server.replica = self
        self.port = self._server.server_address[1]
        if self.replica_id is None:
            self.replica_id = f"replica-{self.port}"
        # stamp this replica's identity onto the engine's request
        # tracer: every trace line it writes/ships (MXTPU_TRACE_PUSH_URL
        # -> the fleet collector) names the replica that served it, so
        # the collector can attribute SLO-offending requests
        self.engine._rtrace.identity = self.replica_id
        self.engine._rtrace.model = self.model
        self._http_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"mxtpu-replica-http-{self.port}")
        self._http_thread.start()
        self._step_thread = threading.Thread(
            target=self._step_loop, daemon=True,
            name=f"mxtpu-replica-step-{self.port}")
        self._step_thread.start()
        self._health_name = statusz_mod.register_health(
            f"fleet.{self.replica_id}", self._health)
        self._statusz_name = statusz_mod.register(
            f"fleet.{self.replica_id}", self._replica_state)
        with self._lock:
            self._state = READY
        return self

    def drain(self):
        """Stop admitting new requests; in-flight work keeps stepping
        to completion (token-identically — the schedule is untouched,
        only admission closes)."""
        with self._lock:
            if self._state == READY:
                self._state = DRAINING
        telemetry.counter("mxtpu_fleet_replica_drains_total",
                          "drain requests accepted").inc()
        return self.state

    def drained(self):
        """True once draining AND no queued or in-flight work remains
        (the supervisor's terminate-safe signal).  ``engine.has_work``
        covers the scheduler AND n>1 fanout siblings still awaiting
        release — a drain must not terminate a replica whose sample
        group hasn't fully entered the scheduler yet."""
        return (self.state == DRAINING
                and not self.engine.has_work()
                and not self._inflight)

    def stop(self):
        """Clean shutdown: step thread stops, engine releases its
        device buffers, HTTP socket closes."""
        with self._lock:
            if self._state == DEAD:
                return
            self._state = DEAD
        self._teardown_http()
        self._stop_evt.set()
        self._work_evt.set()
        if self._step_thread is not None:
            self._step_thread.join(timeout=10)
        try:
            self.engine.shutdown()
        except Exception:
            _errors("shutdown").inc()

    def hard_stop(self):
        """Simulate a crash (the in-process analog of ``os._exit``):
        the HTTP socket dies mid-request, waiting handlers abort their
        connections, the engine is abandoned WITHOUT shutdown — exactly
        what a killed process leaves behind."""
        with self._lock:
            self._state = DEAD
        self._stop_evt.set()
        self._work_evt.set()
        self._teardown_http()
        # the abandoned engine must still leave the process-global
        # /statusz page NOW (a real crash takes the whole registry with
        # it; the in-process simulation has to evict explicitly rather
        # than wait for cyclic GC to collect the engine's weakref)
        statusz_mod.unregister(getattr(self.engine, "_statusz_name", ""))

    def _teardown_http(self):
        statusz_mod.unregister_health(self._health_name)
        statusz_mod.unregister(self._statusz_name)
        server, self._server = self._server, None
        if server is not None:
            # shutdown() stops serve_forever; server_close() frees the
            # port and snaps open keep-alive connections
            threading.Thread(target=server.shutdown, daemon=True).start()
            try:
                server.server_close()
            except OSError:
                _errors("server_close").inc()

    # -- engine pump ---------------------------------------------------------
    def _step_loop(self):
        # engine.has_work (not scheduler.has_work): n>1 siblings wait
        # ENGINE-side until their primary's prefill publishes the
        # prompt's blocks — a primary that finishes in its very first
        # step (max_new=1) would otherwise leave the scheduler empty,
        # park this loop, and hang the waiting /generate handler with
        # its siblings never released
        while not self._stop_evt.is_set():
            if self.engine.has_work():
                try:
                    with self._step_lock:
                        self.engine.step()
                except Exception:
                    # an engine that cannot step is a dead replica: fail
                    # fast so the router's probes see it gone (the
                    # engine already force-dumped the flight ring)
                    _errors("step").inc()
                    self.hard_stop()
                    return
            else:
                self._work_evt.wait(0.05)
                self._work_evt.clear()

    # -- request handling (called from HTTP handler threads) -----------------
    def handle_generate(self, body, trace_id=None):
        """Returns ``(http_status, payload_dict)`` or ``None`` meaning
        "abort the connection without a response" (replica died)."""
        return self._with_faults(self._serve_generate, body, trace_id)

    def handle_handoff(self, body, trace_id=None):
        """``POST /handoff``: ingest a prefill replica's exported KV
        chain, then serve the request's decode.  Same return contract
        as :meth:`handle_generate`; the fault injector counts handoff
        arrivals through the same hook, so ``kill@k`` on a decode
        replica fires mid-stream while serving its k-th handoff."""
        return self._with_faults(self._serve_handoff, body, trace_id)

    def _with_faults(self, fn, body, trace_id):
        """Apply this arrival's chaos verdict around ``fn``."""
        fault = self.faults.on_request()
        if fault is not None and fault.action == "refuse":
            return 503, {"error": "fault_refuse", "retriable": True}
        if fault is not None and fault.action == "delay":
            time.sleep(fault.arg)
        if fault is not None and fault.action == "hang":
            # hold the connection unanswered until the client gives up,
            # for at most arg seconds; stopping the replica releases it
            self._stop_evt.wait(fault.arg)
            return None
        kill = fault is not None and fault.action == "kill"
        result = fn(body, trace_id, kill)
        if kill and result is not None:
            # the arrival the fault spec kills must never be answered —
            # whatever its answer would have been (a dedup-cache hit, a
            # rejection, or a generation that finished before the
            # mid-stream threshold); deterministic chaos means the
            # replica IS dead after request k, full stop
            self._on_kill()
            return None
        return result

    def _serve_generate(self, body, trace_id, kill, handoff=False):
        if self.state != READY:
            return 503, {"error": "draining", "retriable": True,
                         "state": self.state}
        if self.role == "decode" and not handoff:
            # a decode-role replica only ingests /handoff work; a
            # misrouted prompt (stale scrape) retries on a sibling
            return 503, {"error": "wrong_role", "retriable": True,
                         "role": self.role}
        prefill_only = self.role == "prefill" and not handoff
        request_id = body.get("request_id")
        try:
            prompt = [int(t) for t in body["prompt"]]
            max_new = int(body.get("max_new_tokens", 64))
        except (KeyError, TypeError, ValueError):
            return 400, {"error": "bad_request", "retriable": False}
        deadline_s = body.get("deadline_s")
        if deadline_s is not None:
            try:
                deadline_s = float(deadline_s)
            except (TypeError, ValueError):
                return 400, {"error": "bad_request", "retriable": False}
        # per-request sampling params: malformed values are clean 400s
        # on EVERY replica — never 500s the router would count as
        # transport failures and open breakers fleet-wide
        try:
            temperature = body.get("temperature")
            temperature = (None if temperature is None
                           else float(temperature))
            top_p = body.get("top_p")
            top_p = None if top_p is None else float(top_p)
            top_k = body.get("top_k")
            top_k = None if top_k is None else int(top_k)
            n = int(body.get("n", 1))
            logprobs = int(body.get("logprobs", 0))
        except (TypeError, ValueError):
            return 400, {"error": "bad_request", "retriable": False}
        if ((temperature is not None
             and not (np.isfinite(temperature) and temperature >= 0))
                or (top_p is not None
                    and not (np.isfinite(top_p) and 0 < top_p <= 1))
                or (top_k is not None and top_k < 0)
                or not 1 <= n <= 64 or not 0 <= logprobs <= 5):
            return 400, {"error": "bad_request", "retriable": False}
        if not prompt or max_new < 1:
            # invalid on EVERY replica: a clean 400, never a 500 the
            # router would count as a transport failure and retry
            # fleet-wide (three such requests would otherwise open
            # every breaker)
            return 400, {"error": "bad_request", "retriable": False}
        if prefill_only \
                and len(prompt) + max_new > self.engine.max_model_len:
            # a prefill replica only submits prompt+1 (it never
            # decodes), so the engine's own exceeds_max_len guard
            # would miss the FULL request length — check it here, or
            # the fleet would pay a whole prefill + handoff before the
            # decode replica's admission rejects it
            return 400, {"error": "exceeds_max_len", "retriable": False}
        tenant = body.get("tenant")
        if tenant is not None:
            # bound client-supplied tenant labels: they key per-tenant
            # scheduler/telemetry state, which must not grow with
            # arbitrary client strings
            tenant = str(tenant)[:64]
        # catalog params, same discipline as the sampling params above:
        # unknown/malformed values are clean 400s on every replica —
        # the router filters by model BEFORE forwarding, so a mismatch
        # here means a stale scrape or a direct client; either way no
        # retry on this replica can succeed
        model = body.get("model")
        if model is not None:
            if not isinstance(model, str) or not model:
                return 400, {"error": "bad_request", "retriable": False}
            if model[:64] != self.model:
                return 400, {"error": "wrong_model", "retriable": False,
                             "model": self.model}
        adapter = body.get("adapter")
        if adapter is not None:
            if not isinstance(adapter, str) or not adapter:
                return 400, {"error": "bad_request", "retriable": False}
            adapter = adapter[:64]
            store = getattr(self.engine, "adapter_store", None)
            if store is None or not store.known(adapter):
                return 400, {"error": "unknown_adapter",
                             "retriable": False, "adapter": adapter}
        pull = body.get("kv_pull")
        if pull is not None:
            # router hint: a sibling advertises more of this prompt's
            # chain than we hold — pull it into the host tier before
            # admission so the radix walk hits it.  Strictly
            # best-effort: every failure arm degrades to recompute
            self._maybe_pull_chain(pull, prompt, salt=adapter)
        # a prefill-role replica runs admission + (chunked) prefill
        # only: max_new_tokens=1 makes the prefill pass's own sampled
        # token the request's last — it FINISHES at prefill end, its
        # blocks park published with K/V intact, and export_blocks
        # re-walks them by content.  The one emitted token is
        # discarded; the decode replica regenerates it when it
        # recomputes the final span (greedy — byte-identical)
        serve_new = 1 if prefill_only else max_new
        # a prefill replica never fans out: the decode replica serves
        # the n>1 group itself after the handoff (the shared prefix
        # travels once either way)
        serve_n = 1 if prefill_only else n

        def submit():
            return self.engine.submit(prompt, max_new_tokens=serve_new,
                                      deadline_s=deadline_s,
                                      tenant=tenant, trace_id=trace_id,
                                      handoff=handoff,
                                      temperature=temperature,
                                      top_p=top_p, top_k=top_k,
                                      n=serve_n, logprobs=logprobs,
                                      adapter_id=adapter)

        # an adapter's first request loads its device slot inside submit
        device = (self._step_lock if adapter is not None
                  else contextlib.nullcontext())
        try:
            if request_id is not None:
                # reserve-or-attach is ONE atomic step: cache lookup,
                # in-flight lookup and engine submit all under _lock,
                # so two concurrent retries of the same id can never
                # both execute (engine.submit only takes the scheduler
                # lock — no inverse ordering exists)
                with device, self._lock:
                    cached = self._done_cache.get(request_id)
                    if cached is not None:
                        # retry of a completed id: same answer, no
                        # recompute
                        return 200, dict(cached, deduped=True)
                    req = self._inflight.get(request_id)
                    if req is None:
                        req = submit()
                        if req.status != REJECTED:
                            self._inflight[request_id] = req
            else:
                with device:
                    req = submit()
        except QueueFull:
            return 503, {"error": "queue_full", "retriable": True}
        except ValueError:
            # anything Request/engine validation still rejects is a
            # client error, not a replica failure
            return 400, {"error": "bad_request", "retriable": False}
        if req.status == REJECTED:
            return self._reject_response(req)
        self._work_evt.set()

        # a kill fault dies MID-STREAM: once the request has produced
        # about half its tokens — the worst moment (on a prefill-role
        # replica that is the moment prefill completes)
        kill_after = max(1, serve_new // 2) if kill else None
        while (not req.done
               or (req.samples
                   and any(not s.done for s in req.samples))):
            if kill_after is not None and len(req.tokens) >= kill_after:
                self._on_kill()
                return None
            if self._stop_evt.is_set():
                return None              # replica died under us: abort
            time.sleep(self.poll_s)
        if req.status != FINISHED:
            if request_id is not None:
                with self._lock:
                    self._inflight.pop(request_id, None)
            if req.status == REJECTED:
                return self._reject_response(req)
            return 503, {"error": req.status, "retriable": True}
        if prefill_only:
            # the prefill answer is a HANDOFF ENVELOPE, not tokens:
            # the prompt's cached chain as content-keyed wire records
            # (the router moves it to a decode replica).  Exported
            # under the step lock: the device-to-host gather must not
            # run while the step thread captures a graph
            with self._step_lock:
                records, nbytes = self._encode_records(
                    self.engine.blocks.export_blocks(req.rid, prompt,
                                                     salt=adapter))
            payload = {"handoff": {"records": records,
                                   "prefill_replica": self.replica_id,
                                   "cached_tokens": req.cached_prefix_len,
                                   "prefilled": int(req.cache_len)},
                       "rid": req.rid, "trace_id": req.trace_id,
                       "tenant": req.tenant,
                       "replica": self.replica_id}
        else:
            nbytes = 0
            payload = {"tokens": list(req.tokens), "rid": req.rid,
                       "trace_id": req.trace_id, "tenant": req.tenant,
                       "replica": self.replica_id,
                       "n_preemptions": req.n_preemptions}
            # sampling extras ride only-when-asked, so plain requests'
            # response payloads stay byte-identical
            if logprobs:
                payload["token_logprobs"] = list(req.token_logprobs)
                payload["top_logprobs"] = list(req.top_logprobs)
            if req.samples:
                payload["samples"] = [
                    dict({"tokens": list(s.tokens), "rid": s.rid},
                         **({"status": s.status}
                            if s.status != FINISHED else {}),
                         **({"token_logprobs": list(s.token_logprobs),
                             "top_logprobs": list(s.top_logprobs)}
                            if logprobs else {}))
                    for s in req.samples]
        with self._lock:
            # cache-write and in-flight pop are ONE locked step: a
            # retry arriving between them would miss both lookups and
            # re-execute.  When several handlers attached to one
            # in-flight request, only the first to land here counts it
            # served and writes the cache; the rest return the same
            # payload without double-counting.
            first = request_id is None or request_id not in self._done_cache
            if request_id is None:
                self._served += 1
            elif first:
                self._served += 1
                self._done_cache[request_id] = payload
                while len(self._done_cache) > _DONE_CACHE_SIZE:
                    self._done_cache.popitem(last=False)
            if request_id is not None:
                self._inflight.pop(request_id, None)
            if first and prefill_only:
                self._handoffs_exported += 1
                self._handoff_bytes_exported += nbytes
        if first and prefill_only:
            _handoff_bytes("exported").inc(nbytes)
        return 200, payload

    def _serve_handoff(self, body, trace_id, kill):
        """Ingest one prefill→decode handoff, then serve its decode.

        The KV records import into the host tier under their content
        keys; the request then runs like a plain prompt — the radix
        walk hits the imported chain, so only the final span (and
        whatever a failed/dropped/truncated import left uncovered)
        recomputes.  Degradation is always recompute-from-prompt,
        never an error: the body carries the prompt."""
        if self.state != READY:
            return 503, {"error": "draining", "retriable": True,
                         "state": self.state}
        if self.role == "prefill":
            return 503, {"error": "wrong_role", "retriable": True,
                         "role": self.role}
        if self._handoff_delay_s > 0:
            # chaos: simulated slow wire (pushed past the router's
            # per-hop timeout it exercises re-handoff on a sibling);
            # stopping the replica ends it
            if self._stop_evt.wait(self._handoff_delay_s):
                return None
        request_id = body.get("request_id")
        if request_id is not None:
            with self._lock:
                done = request_id in self._done_cache
            if done:
                # a re-handoff of an id this replica already completed
                # (first delivery's response was lost): skip the whole
                # base64 decode + import — _serve_generate answers
                # from the done-cache either way
                return self._serve_generate(body, trace_id, kill,
                                            handoff=True)
        records = body.get("records") or []
        with self._lock:
            dropped = self._handoff_drops_left > 0 and bool(records)
            if dropped:
                self._handoff_drops_left -= 1
                self._handoff_drops += 1
        if dropped:
            records = []    # "arrived truncated": recompute from prompt
        imported = deduped = rejected = 0
        nbytes = 0
        with self._lock:
            self._handoff_ingesting += 1
        try:
            try:
                parsed, nbytes = self._decode_records(records)
                # the sender salted the chain with the request's
                # adapter id; verification needs the same root
                adp = body.get("adapter")
                adp = (adp[:64] if isinstance(adp, str) and adp
                       else None)
                imported, deduped, rejected = \
                    self.engine.blocks.import_blocks(parsed, salt=adp)
            except (KeyError, TypeError, ValueError):
                # malformed payload: the prompt is still fully
                # servable here — degrade to recompute, never a 400
                # (which the router would treat as permanent)
                rejected = len(records)
        finally:
            with self._lock:
                self._handoff_ingesting -= 1
                self._handoffs_received += 1
                self._handoff_imported += imported
                self._handoff_deduped += deduped
                self._handoff_rejected += rejected
                self._handoff_bytes_received += nbytes
        _handoff_bytes("received").inc(nbytes)
        if imported:
            _handoff_blocks("imported").inc(imported)
        if deduped:
            _handoff_blocks("deduped").inc(deduped)
        if rejected:
            _handoff_blocks("rejected").inc(rejected)
        return self._serve_generate(body, trace_id, kill, handoff=True)

    def _maybe_pull_chain(self, spec, prompt, salt=None):
        """Pull a sibling's cached KV chain for ``prompt`` into the
        local host tier — the peer-to-peer leg of the fleet KV fabric.

        ``spec`` is the router's ``kv_pull`` hint: ``{"peer": url,
        "tokens": advertised_prefix_tokens}``.  The pull POSTs the
        peer's ``/chain_export`` and lands the records through the
        SAME verified import path as a prefill→decode handoff
        (payload sha1 in ``_decode_records``, chain hash in
        ``import_blocks``) — so a shared prefix is prefilled once per
        fleet and shipped once per host.  Best-effort by contract:
        a malformed hint, an unreachable/slow peer
        (``MXTPU_ROUTE_PULL_TIMEOUT``), a corrupted payload, or a
        bloom false positive (the peer exports nothing) all degrade
        to recompute-from-prompt — never an error, never a wrong
        token.  Skipped outright when the local cache already covers
        at least the advertised span, or without a host tier to land
        the records in."""
        eng = self.engine
        if eng.blocks.host is None or not eng.blocks.prefix_cache:
            return
        try:
            peer = str(spec.get("peer") or "")
            tokens = int(spec.get("tokens") or 0)
        except (AttributeError, TypeError, ValueError):
            return
        if not peer.startswith("http") \
                or tokens < eng.blocks.block_size:
            return
        _, local = eng.blocks.prefix_probe(prompt, salt=salt)
        if local >= tokens:
            return            # already as warm as the peer advertises
        with self._lock:
            self._pull_attempts += 1
        try:
            pull_body = {"prompt": prompt}
            if salt is not None:
                # adapter-salted chains live in a disjoint key space;
                # the peer must export with the same salt
                pull_body["adapter"] = salt
            req = urllib.request.Request(
                f"{peer.rstrip('/')}/chain_export",
                data=json.dumps(pull_body).encode(),
                method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(
                    req, timeout=self._pull_timeout_s) as resp:
                out = json.loads(resp.read())
            records = out.get("records") or []
            parsed, nbytes = self._decode_records(records)
            imported, deduped, rejected = \
                eng.ingest_pulled_blocks(parsed, salt=salt)
        except (OSError, KeyError, TypeError, ValueError):
            # transport failure, truncation, or digest mismatch: the
            # prompt is still fully servable here — recompute
            with self._lock:
                self._pull_failures += 1
            _pull_result("failed").inc()
            return
        # an empty export despite the advertisement is the bloom
        # false-positive arm (or the chain was evicted since the
        # scrape) — count it so the advertised FP bound is observable
        false_positive = not records
        with self._lock:
            self._pull_imported += imported
            self._pull_deduped += deduped
            self._pull_rejected += rejected
            self._pull_bytes_received += nbytes
            if false_positive:
                self._pull_false_positives += 1
        _handoff_bytes("pulled").inc(nbytes)
        _pull_result("false_positive" if false_positive else "ok").inc()

    def handle_chain_export(self, body):
        """``POST /chain_export``: serialize this replica's cached
        chain for a peer's prompt — the serving half of a peer-to-peer
        pull.  Read-only against the cache (D2H gather + host-pool
        peek, never a claim, never an index mutation) and never
        fault-injected: a pull is a bytes optimization, and chaos must
        exercise the PULLER's degrade path, not synthesize fake
        request arrivals here.  Exported under the step lock exactly
        like a prefill handoff: the gather must not run while the
        step thread captures a graph."""
        try:
            prompt = [int(t) for t in body["prompt"]]
        except (KeyError, TypeError, ValueError):
            return 400, {"error": "bad_request", "retriable": False}
        if not prompt:
            return 400, {"error": "bad_request", "retriable": False}
        adp = body.get("adapter")
        adp = adp[:64] if isinstance(adp, str) and adp else None
        with self._step_lock:
            records, nbytes = self._encode_records(
                self.engine.blocks.export_blocks(None, prompt,
                                                 salt=adp))
        with self._lock:
            self._chain_exports += 1
            self._chain_export_blocks += len(records)
            self._chain_export_bytes += nbytes
        _handoff_bytes("chain_exported").inc(nbytes)
        return 200, {"replica": self.replica_id, "records": records}

    def _encode_records(self, recs):
        """``export_blocks`` output -> JSON-ready wire records (raw
        K/V bytes base64'd, plus a payload digest — the chain hash
        covers keys/tokens only, so corruption of the K/V bytes
        themselves needs its own check).  Returns ``(records,
        payload_bytes)``."""
        records, nbytes = [], 0
        for key, parent, tokens, arrays in recs:
            rec = {"key": key.hex(),
                   "parent": parent.hex() if parent is not None else None,
                   "tokens": tokens}
            digest = hashlib.sha1()
            for name, a in zip(("k", "v", "ksc", "vsc"), arrays):
                raw = _raw_bytes(a)
                digest.update(raw)
                rec[name] = base64.b64encode(raw).decode("ascii")
                nbytes += len(raw)
            rec["digest"] = digest.hexdigest()[:16]
            records.append(rec)
        return records, nbytes

    def _decode_records(self, records):
        """Wire records -> ``import_blocks`` input, every payload
        validated against the engine's host-block spec (shape x dtype
        bytes) AND its payload digest — the chain hash
        ``import_blocks`` re-verifies covers only keys/tokens, so
        same-length byte corruption needs the digest to be caught
        before wrong K/V can park under a valid content key.  A
        record without payload fields is a dedup-probe skip (the
        sender knows this replica already hosts the block).  Each
        payload becomes a CPU tensor of the spec's dtype (a copy: the
        host tier keeps it)."""
        specs = [(shape, _WIRE_DTYPES[str(name)])
                 for shape, name in self.engine.host_block_spec()]
        names = ("k", "v", "ksc", "vsc")[:len(specs)]
        parsed, nbytes = [], 0
        for rec in records:
            key = bytes.fromhex(rec["key"])
            parent = (bytes.fromhex(rec["parent"])
                      if rec.get("parent") else None)
            tokens = [int(t) for t in rec["tokens"]]
            arrays = None
            if all(n in rec for n in names):
                arrays = []
                digest = hashlib.sha1()
                for n, (shape, (size, npdt, tdt)) in zip(names, specs):
                    raw = base64.b64decode(rec[n])
                    want = int(np.prod(shape)) * size
                    if len(raw) != want:
                        raise ValueError(
                            f"handoff record {n} holds {len(raw)} "
                            f"bytes, expected {want}")
                    digest.update(raw)
                    arrays.append(torch.from_numpy(
                        np.frombuffer(raw, npdt).reshape(shape).copy())
                        .view(tdt))
                    nbytes += len(raw)
                if rec.get("digest") is not None \
                        and digest.hexdigest()[:16] != rec["digest"]:
                    raise ValueError("handoff record payload digest "
                                     "mismatch (corrupted in transit)")
                arrays = tuple(arrays)
            parsed.append((key, parent, tokens, arrays))
        return parsed, nbytes

    # -- catalog management (supervisor rebalance surface) -------------------
    def _adapter_store_or_400(self, body):
        store = getattr(self.engine, "adapter_store", None)
        if store is None:
            return None, None, (400, {"error": "adapters_off",
                                      "retriable": False})
        adapter = body.get("adapter")
        if not isinstance(adapter, str) or not adapter:
            return None, None, (400, {"error": "bad_request",
                                      "retriable": False})
        return store, adapter[:64], None

    def handle_load_adapter(self, body):
        """Register an adapter at runtime: either an ``export_records``
        wire payload (sha1-verified per array) or a ``save_file`` host
        path.  Idempotent — re-loading registered content dedups by
        digest."""
        store, adapter, err = self._adapter_store_or_400(body)
        if err is not None:
            return err
        try:
            if body.get("records") is not None:
                store.import_records(adapter, body)
            elif body.get("path") is not None:
                store.load_file(adapter, str(body["path"]))
            else:
                return 400, {"error": "bad_request", "retriable": False}
        except (KeyError, OSError, TypeError, ValueError) as e:
            # a corrupt/oversized/malformed payload is the CALLER's
            # problem — never a 500 that opens breakers
            return 400, {"error": "bad_adapter", "retriable": False,
                         "detail": str(e)[:200]}
        return 200, {"adapter": adapter, "adapters": store.ids(),
                     "replica": self.replica_id}

    def handle_unload_adapter(self, body):
        """De-catalog an adapter (rebalance move-away).  An adapter
        pinned by running requests refuses retriable — the caller
        drains and retries."""
        store, adapter, err = self._adapter_store_or_400(body)
        if err is not None:
            return err
        try:
            removed = store.forget(adapter)
        except RuntimeError:
            return 503, {"error": "adapter_pinned", "retriable": True}
        if not removed:
            return 400, {"error": "unknown_adapter", "retriable": False,
                         "adapter": adapter}
        return 200, {"adapter": adapter, "adapters": store.ids(),
                     "replica": self.replica_id}

    def handle_adapter_export(self, body):
        """Serialize a registered adapter for a peer's /load_adapter
        (the rebalancer's copy half — adapters move replica-to-replica
        without a shared filesystem)."""
        store, adapter, err = self._adapter_store_or_400(body)
        if err is not None:
            return err
        if not store.known(adapter):
            return 400, {"error": "unknown_adapter", "retriable": False,
                         "adapter": adapter}
        payload = store.export_records(adapter)
        payload["replica"] = self.replica_id
        return 200, payload

    @property
    def waiting_handoffs(self):
        """Handoff ingests this replica has accepted but not yet
        admitted to prefill/decode (mid-import, or queued awaiting
        restore) — the /healthz load-signal component that stops the
        router's least-loaded pick from dog-piling a replica whose
        in-flight ingests haven't reached the running set yet."""
        with self._lock:
            ingesting = self._handoff_ingesting
        return ingesting + self.engine.scheduler.waiting_handoffs()

    def _reject_response(self, req):
        reason = req.reject_reason or "rejected"
        retriable = reason in RETRIABLE_REASONS
        return ((503 if retriable else 400),
                {"error": reason, "retriable": retriable,
                 "rid": req.rid, "trace_id": req.trace_id})

    # -- introspection -------------------------------------------------------
    def _health(self):
        state = self.state
        hk = self.engine.host_kv_stats()
        payload = {"status": "ok" if state == READY else state,
                "state": state,
                # the disaggregation role: the router routes prompts
                # to prefill-capable replicas and handoffs to
                # decode-capable ones
                "role": self.role,
                "in_flight": len(self._inflight),
                "queue_depth": self.engine.scheduler.queue_depth,
                # mid-chunked-prefill requests hold a batch slot too —
                # a replica grinding a long prefill must report the load
                "running": (len(self.engine.scheduler.running)
                            + len(self.engine.scheduler.prefilling)),
                # accepted handoff ingests not yet running: without
                # this a decode replica mid-ingest under-reports load
                # and attracts every next handoff
                "waiting_handoffs": self.waiting_handoffs,
                # host-DRAM KV tier occupancy (None with the tier off):
                # a saturated pool means further evictions re-pay
                # recompute, so the tier's headroom IS a load signal
                "host_kv_utilization": (hk["utilization"]
                                        if hk is not None else None),
                # the routable-cache advertisement (RadixSummary
                # snapshot; None with the prefix cache off).  Size-
                # bounded by construction: bloom_bits/8 bytes of
                # bitmap + top_k truncated-hex keys, ~1.2 KB at the
                # defaults, independent of cache size
                "kv_summary": self.engine.kv_summary()}
        # deploy identity is optional: untagged replicas keep the
        # pre-control-plane /healthz schema byte-for-byte
        if self.version is not None:
            payload["version"] = self.version
        # catalog advertisement, only-when-set for the same reason:
        # the carried checkpoint and the registered (routable) adapters
        if self.model is not None:
            payload["model"] = self.model
        store = getattr(self.engine, "adapter_store", None)
        if store is not None:
            payload["adapters"] = store.ids()
        return payload

    def _replica_state(self):
        """The router's balancing signal: readiness plus live load
        (queue depth, decode batch occupancy, KV occupancy)."""
        eng = self.engine
        with self._lock:
            state, served = self._state, self._served
            inflight = len(self._inflight)
        hk = eng.host_kv_stats()
        with self._lock:
            handoff = {"received": self._handoffs_received,
                       "exported": self._handoffs_exported,
                       "blocks_imported": self._handoff_imported,
                       "blocks_deduped": self._handoff_deduped,
                       "blocks_rejected": self._handoff_rejected,
                       "drops": self._handoff_drops,
                       "bytes_received": self._handoff_bytes_received,
                       "bytes_exported": self._handoff_bytes_exported}
            pull = {"attempts": self._pull_attempts,
                    "blocks_imported": self._pull_imported,
                    "blocks_deduped": self._pull_deduped,
                    "blocks_rejected": self._pull_rejected,
                    "false_positives": self._pull_false_positives,
                    "failures": self._pull_failures,
                    "bytes_received": self._pull_bytes_received,
                    "chain_exports": self._chain_exports,
                    "chain_export_blocks": self._chain_export_blocks,
                    "chain_export_bytes": self._chain_export_bytes}
        s = eng.stats()
        return {"replica": self.replica_id, "state": state,
                "role": self.role,
                "version": self.version,
                # catalog identity + adapter-store occupancy (None on
                # an uncataloged / adapters-off replica)
                "model": self.model,
                "adapters": (eng.adapter_info()
                             if hasattr(eng, "adapter_info") else None),
                "served": served, "in_flight": inflight,
                # the serving ground truth the fleet collector
                # aggregates (three-view agreement: fleet /fleetz ==
                # sum of these == the collector's registry series):
                # monotonic totals plus the local tail-latency SLO
                # inputs and per-tenant goodput counts
                "stats": {
                    "tokens_generated": s.tokens_generated,
                    "prompt_tokens": s.prompt_tokens,
                    "completed": s.completed,
                    "rejected": s.rejected,
                    "reject_reasons": dict(s.reject_reasons),
                    "preemptions": s.preemptions,
                    "decode_tok_per_sec": s.decode_tok_per_sec,
                    "total_tok_per_sec": s.total_tok_per_sec,
                    "ttft_ms_p50": s.ttft_ms_p50,
                    "ttft_ms_p99": s.ttft_ms_p99,
                    "tpot_ms_p50": s.tpot_ms_p50,
                    "tpot_ms_p99": s.tpot_ms_p99,
                    "decode_occupancy": s.decode_occupancy,
                    # prefix-cache goodput (the cache-aware router's
                    # A/B ground truth: hits split from LRU
                    # resurrections, plus the prefill compute the
                    # cache actually avoided)
                    "prefix_hits": s.prefix_hits,
                    "prefix_misses": s.prefix_misses,
                    "prefix_resurrections": s.prefix_resurrections,
                    "prefix_tokens_saved": s.prefix_tokens_saved,
                    "prefill_tokens_computed":
                        s.prefill_tokens_computed,
                    "tenants": {t: row.get("completed", 0)
                                for t, row in s.tenants.items()},
                    # per-adapter goodput (empty without adapter
                    # traffic — the collector's per-model/adapter
                    # /fleetz aggregation input)
                    "adapter_completed": {
                        a: row.get("completed", 0)
                        for a, row in s.adapters.items()},
                    "adapter_tokens": {
                        a: row.get("tokens", 0)
                        for a, row in s.adapters.items()},
                },
                "queue_depth": eng.scheduler.queue_depth,
                # running includes the chunked-prefill lane: those
                # requests occupy batch slots and the prefill budget,
                # so the router's load score must see them
                "running": (len(eng.scheduler.running)
                            + len(eng.scheduler.prefilling)),
                # in-flight handoff ingests count toward load too —
                # the router's least-loaded decode pick reads this
                "waiting_handoffs": self.waiting_handoffs,
                # prefill→decode handoff traffic (the disaggregation
                # observability: wire bytes, dedup hits, drop arms)
                "handoff": handoff,
                # peer-to-peer chain pull traffic (the fleet KV
                # fabric observability: hit/false-positive/failure
                # arms, wire bytes both directions)
                "pull": pull,
                # the routable-cache advertisement the affinity
                # router probes (None with the prefix cache off)
                "kv_summary": eng.kv_summary(),
                "max_batch": eng.max_batch,
                "kv_utilization": round(eng.blocks.utilization(), 4),
                # host-DRAM KV tier occupancy (None with the tier off)
                "host_kv_utilization": (hk["utilization"]
                                        if hk is not None else None),
                # per-program performance attribution (None with
                # MXTPU_PERF_ATTRIB=0, or on engines predating it):
                # the collector flattens this into role-keyed
                # MFU/goodput aggregates on /fleetz
                "perf": (eng.perf_summary()
                         if hasattr(eng, "perf_summary") else None),
                # per-step host-overhead fractions (None on engines
                # predating the step profiler, or a NOOP summary with
                # MXTPU_STEP_PROFILE=0)
                "step_profile": (eng._sprof.summary()
                                 if hasattr(eng, "_sprof") else None),
                "faults_fired": len(self.faults.fired)}

    def statusz_snapshot(self):
        """Global statusz plus THIS server's "replica" section (several
        in-process replicas share one global provider registry; the
        scraping router needs to know which one answered)."""
        snap = statusz_mod.snapshot()
        snap["replica"] = self._replica_state()
        return snap


# BaseHTTPRequestHandler at module scope (not a per-start() closure) so
# a process serving many replicas shares one handler class; per-replica
# state rides the server object (``self.server.replica``).
class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def replica(self):
        return self.server.replica

    def _send_json(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _abort(self):
        """Close the connection without any response (the client sees
        a mid-request disconnect and treats it as retriable)."""
        try:
            self.close_connection = True
            self.connection.close()
        except OSError:
            _errors("abort").inc()

    def do_GET(self):
        if self.path == "/healthz":
            self._send_json(200, self.replica._health())
        elif self.path in ("/statusz.json", "/statusz"):
            self._send_json(200, self.replica.statusz_snapshot())
        elif self.path == "/metrics":
            # Prometheus text exposition of the process registry — the
            # fleet collector's second scrape target (empty until
            # MXTPU_TELEMETRY enables recording; the endpoint itself
            # costs nothing when the registry is empty)
            body = telemetry.to_prometheus_text(
                telemetry.registry()).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.startswith("/profilez/"):
            self._send_json(501, _PROFILEZ_UNPORTED)
        else:
            self.send_error(404)

    def do_POST(self):
        if self.path == "/drain":
            try:                 # consume any body (keep-alive hygiene)
                self.rfile.read(int(self.headers.get("Content-Length",
                                                     0) or 0))
            except (ValueError, OSError):
                _errors("drain_body").inc()
            state = self.replica.drain()
            self._send_json(200, {"state": state,
                                  "queue_depth":
                                      self.replica.engine.scheduler
                                      .queue_depth})
            return
        if self.path == "/flight_dump":
            # fleet-triggered post-mortem: the collector's SLO layer
            # asks the OFFENDING replica to dump its flight-recorder
            # ring when a burn-rate alert fires.  Rides the recorder's
            # own per-reason rate limit (never force), so an alert
            # storm cannot fill this replica's disk; never
            # fault-injected (a post-mortem request is not traffic)
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, OSError):
                body = {}
            from ..telemetry import flight as flight_mod

            reason = str(body.get("reason") or "fleet_request")[:64]
            extra = {"requested_by": "fleet",
                     "replica": self.replica.replica_id}
            if body.get("capture_id"):
                # a burn-triggered dump names the profiler capture
                # fired alongside it, so the post-mortem artifact
                # links straight to its device trace
                extra["capture_id"] = str(body["capture_id"])[:128]
            path = flight_mod.recorder().dump(reason, extra=extra)
            telemetry.counter(
                "mxtpu_fleet_flight_dump_requests_total",
                "fleet-triggered flight-dump requests",
                ("outcome",)).labels(
                    outcome="written" if path else "suppressed").inc()
            self._send_json(200, {"path": path,
                                  "replica": self.replica.replica_id})
            return
        if self.path == "/profilez":
            try:                 # consume any body (keep-alive hygiene)
                self.rfile.read(int(self.headers.get("Content-Length",
                                                     0) or 0))
            except (ValueError, OSError):
                _errors("profilez_body").inc()
            self._send_json(501, _PROFILEZ_UNPORTED)
            return
        if self.path not in ("/generate", "/handoff", "/handoff_probe",
                             "/chain_export", "/load_adapter",
                             "/unload_adapter", "/adapter_export"):
            self.send_error(404)
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, OSError):
            self._send_json(400, {"error": "bad_json",
                                  "retriable": False})
            return
        if self.path == "/handoff_probe":
            # dedup probe: which of these content keys does this
            # replica already cache (either tier)?  The sender skips
            # those blocks' bytes on the wire.  Never fault-injected —
            # a probe is an optimization, not a request arrival
            try:
                keys = [bytes.fromhex(k) for k in body.get("keys") or []]
            except (TypeError, ValueError):
                self._send_json(400, {"error": "bad_request",
                                      "retriable": False})
                return
            have = set(self.replica.engine.blocks.has_blocks(keys))
            self._send_json(200, {"missing": [k.hex() for k in keys
                                              if k not in have]})
            return
        if self.path == "/chain_export":
            # peer-to-peer pull: serialize our cached chain for the
            # peer's prompt.  Never fault-injected (see
            # handle_chain_export)
            try:
                result = self.replica.handle_chain_export(body)
            except Exception:
                _errors("chain_export").inc()
                result = 500, {"error": "internal", "retriable": True}
            try:
                self._send_json(*result)
            except OSError:
                _errors("respond").inc()
            return
        if self.path in ("/load_adapter", "/unload_adapter",
                         "/adapter_export"):
            # catalog management: never fault-injected (a rebalance
            # move is control-plane, not traffic)
            fn = {"/load_adapter": self.replica.handle_load_adapter,
                  "/unload_adapter": self.replica.handle_unload_adapter,
                  "/adapter_export": self.replica.handle_adapter_export}[
                      self.path]
            try:
                result = fn(body)
            except Exception:
                _errors(self.path.lstrip("/")).inc()
                result = 500, {"error": "internal", "retriable": True}
            try:
                self._send_json(*result)
            except OSError:
                _errors("respond").inc()
            return
        trace_id = self.headers.get(TRACE_HEADER) or body.get("trace_id")
        handler = (self.replica.handle_handoff
                   if self.path == "/handoff"
                   else self.replica.handle_generate)
        try:
            result = handler(body, trace_id=trace_id)
        except Exception:
            # label by endpoint: a throwing handoff ingest path must
            # not send the operator to debug /generate
            _errors(self.path.lstrip("/")).inc()
            result = 500, {"error": "internal", "retriable": True}
        if result is None:
            self._abort()
            return
        code, payload = result
        try:
            self._send_json(code, payload)
        except OSError:
            _errors("respond").inc()  # client went away mid-response

    def log_message(self, *args):      # no stderr chatter per request
        pass
