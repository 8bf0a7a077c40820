"""Request-scoped tracing for the serving engine.

A copy of ``mxnet_tpu/telemetry/request_trace.py``: the same events,
JSONL lines, sampling, push URL and ``on_terminal`` hook, over the
port's flight recorder, registry and tracer.

Aggregate counters (metrics.py) answer "how fast is the system";
this module answers "what happened to THIS request" (Dapper-style
causality).  Every ``serve.Request`` gets a trace id and an event
timeline —

  submitted → admitted/resumed → prefill_start/prefill_end →
  decode (one per iteration: batch id, batch size, tokens so far,
  tokens emitted this iteration — up to k+1 under speculative
  decoding, where the event also carries the accepted draft count) →
  preempted (reason) → … → finished | rejected (reason) | cancelled

— recorded by the scheduler and the engine through the hooks below.
Three consumers, by cost:

* **flight ring** (always on): every event also lands in the flight
  recorder's bounded ring, so post-mortems see recent request history
  even with tracing off.
* **JSONL export** (``MXTPU_REQUEST_TRACE=1`` or ``=<path>``): one line
  per request, written atomically-appended when the request reaches a
  terminal state — a line is a COMPLETE timeline by construction (no
  orphan events).  ``MXTPU_REQUEST_TRACE_SAMPLE`` (0..1, default 1.0)
  samples per request (deterministic hash of the rid) so production can
  keep the knob on cheaply; ``tools/trace_report.py`` reconstructs
  per-phase latency percentiles from the file.
* **Chrome-trace request tracks** (when telemetry is enabled): each
  traced request's phases (queued / prefill / decode / preempted) are
  emitted as complete events on a virtual track — one ``tid`` per
  in-flight request, reused after completion — so Perfetto shows
  request lifetimes side by side with the host spans.

Counters fed here (re-fetched per call, so enable() ordering never
matters): ``mxtpu_serve_rejections_total{reason}`` and
``mxtpu_serve_preemptions_total{reason}`` — the same reason codes the
``ServeStats.reject_reasons`` snapshot and the timeline carry, so all
three views agree by construction (pinned by
tests/test_observability.py).
"""

from __future__ import annotations

import json
import os
import threading
import time

from . import flight

__all__ = ["RequestTracer", "NOOP_TRACER", "ENV_ENABLE", "ENV_FILE",
           "ENV_SAMPLE", "ENV_PUSH", "TERMINAL_EVENTS"]

ENV_ENABLE = "MXTPU_REQUEST_TRACE"
ENV_FILE = "MXTPU_REQUEST_TRACE_FILE"
ENV_SAMPLE = "MXTPU_REQUEST_TRACE_SAMPLE"
# live trace shipping: terminal request-trace lines are ALSO POSTed to
# this URL (the fleet collector's /trace endpoint), so cross-replica
# stitched timelines exist while the fleet runs instead of only after
# collecting every replica's JSONL file
ENV_PUSH = "MXTPU_TRACE_PUSH_URL"

TERMINAL_EVENTS = ("finished", "rejected", "cancelled")

# virtual Chrome-trace tids for request tracks start here — far above
# plausible small ints, far below real pthread idents, and stable so
# repeated runs diff cleanly.  The pool is PROCESS-global (all tracers
# emit into the one process-wide SpanTracer): two engines in one
# process must never hand out the same tid to concurrent requests
_TRACK_BASE = 10_000
_track_lock = threading.Lock()
_free_tracks = []
_next_track = [_TRACK_BASE]


def _acquire_track():
    global _free_tracks
    with _track_lock:
        if _free_tracks:
            return _free_tracks.pop()
        tid = _next_track[0]
        _next_track[0] += 1
        return tid


def _release_track(tid):
    with _track_lock:
        _free_tracks.append(tid)


class _NoopTracer:
    """Do-nothing stand-in (scheduler default, so a bare Scheduler in a
    test needs no wiring)."""

    __slots__ = ()
    enabled = False

    def submitted(self, req):
        pass

    def event(self, req, name, **args):
        pass

    def terminal(self, req, name, **args):
        pass

    def close(self):
        pass


NOOP_TRACER = _NoopTracer()


class _TracePusher:
    """Background shipper of terminal trace lines to one URL.

    One daemon worker per distinct URL (shared across tracers via
    :func:`_pusher_for`), fed through a bounded queue — serving threads
    only ever enqueue; a slow or dead collector costs a queue slot and
    a dropped-line count, never a stalled request handler."""

    def __init__(self, url, maxsize=256, timeout_s=2.0):
        import queue

        self.url = url
        self.timeout_s = float(timeout_s)
        self._q = queue.Queue(maxsize=int(maxsize))
        self.pushed = 0            # guarded-by: _lock
        self.dropped = 0           # guarded-by: _lock
        self.errors = 0            # guarded-by: _lock
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="mxtpu-trace-push")
        self._thread.start()

    def push(self, record):
        try:
            self._q.put_nowait(record)
        except Exception:
            # full queue: drop — shipping is best-effort by design, the
            # local JSONL file (when configured) still has the line
            with self._lock:
                self.dropped += 1
            self._count("dropped")

    @staticmethod
    def _count(outcome):
        from mxnet_tpu_torch import telemetry

        telemetry.counter("mxtpu_trace_push_total",
                          "terminal trace lines shipped to "
                          "MXTPU_TRACE_PUSH_URL", ("outcome",)
                          ).labels(outcome=outcome).inc()

    def _run(self):
        import urllib.request

        while True:
            record = self._q.get()
            try:
                req = urllib.request.Request(
                    self.url, data=json.dumps(record).encode(),
                    method="POST",
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=self.timeout_s):
                    pass
                with self._lock:
                    self.pushed += 1
                self._count("ok")
            except Exception:
                # collector down/unreachable: count and move on — the
                # pusher must survive the collector's whole lifecycle
                with self._lock:
                    self.errors += 1
                self._count("error")


_pushers = {}                      # guarded-by: _pushers_lock
_pushers_lock = threading.Lock()


def _pusher_for(url):
    """One shared pusher (thread + queue) per distinct URL — many
    engines in one process must not each grow a shipping thread."""
    with _pushers_lock:
        p = _pushers.get(url)
        if p is None:
            p = _pushers[url] = _TracePusher(url)
        return p


def _sampled(rid, rate):
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    # deterministic per-rid hash (Knuth multiplicative) — reproducible
    # across runs, no RNG state on the hot path
    return ((rid * 2654435761) & 0xFFFFFFFF) / 2 ** 32 < rate


class RequestTracer:
    """Per-request event timelines; see module docstring.

    Constructed per engine (`serve.Engine` wires itself and its
    scheduler to one).  ``path``/``sample`` override the env knobs.
    """

    def __init__(self, path=None, sample=None, source="serve",
                 push_url=None):
        env = os.environ.get(ENV_ENABLE, "")
        if path is None and env and env not in ("0", "false", "False",
                                                "off", "no"):
            # MXTPU_REQUEST_TRACE=<path> names the file directly;
            # any other truthy value enables with the default path
            if os.sep in env or env.endswith(".jsonl"):
                path = env
            else:
                path = os.environ.get(ENV_FILE) or self._default_path()
        self.path = path
        # live shipping (MXTPU_TRACE_PUSH_URL -> the fleet collector's
        # /trace endpoint): enables timeline collection even without a
        # local JSONL file; the shared per-URL pusher thread only
        # exists once a URL is configured (inert otherwise)
        if push_url is None:
            push_url = os.environ.get(ENV_PUSH) or None
        self._pusher = _pusher_for(push_url) if push_url else None
        # replica identity stamped onto shipped/written lines (the
        # fleet front sets it so the collector can attribute a line —
        # e.g. an SLO-offending request — to the replica that served
        # it); None keeps the line schema byte-identical to older runs
        self.identity = None
        # catalog model id stamped like identity (the fleet front sets
        # it): lets ``trace_report --stitch`` show which checkpoint
        # served each hop.  None keeps the historical schema
        self.model = None
        self.enabled = path is not None or self._pusher is not None
        if sample is None:
            try:
                sample = float(os.environ.get(ENV_SAMPLE, "") or 1.0)
            except ValueError:
                sample = 1.0
        self.sample = min(1.0, max(0.0, float(sample)))
        self.source = source
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._file = None
        self._flight = flight.recorder()
        self.traced = 0                # requests whose timeline was kept
        self.written = 0               # JSONL lines written
        # optional hook fired on EVERY terminal event (sampled or not)
        # — the engine hangs its SLO-breach detection here
        self.on_terminal = None

    @staticmethod
    def _default_path():
        from mxnet_tpu_torch import telemetry

        return os.path.join(telemetry.out_dir(), "request_trace.jsonl")

    # -- counters (re-fetched per call; no-ops unless MXTPU_TELEMETRY) ----
    @staticmethod
    def _count_rejection(reason):
        from mxnet_tpu_torch import telemetry

        telemetry.counter("mxtpu_serve_rejections_total",
                          "rejected requests by reason",
                          ("reason",)).labels(reason=reason).inc()

    @staticmethod
    def _count_preemption(reason):
        from mxnet_tpu_torch import telemetry

        telemetry.counter("mxtpu_serve_preemptions_total",
                          "scheduler preemptions by reason",
                          ("reason",)).labels(reason=reason).inc()

    # -- recording hooks (scheduler + engine call these) -------------------
    def submitted(self, req):
        """First event of a request's life; stamps trace identity on
        the Request — unless the caller pre-stamped one (a fleet
        router propagates its trace id across replica hops, so every
        hop's JSONL line shares the id and ``tools/trace_report.py``
        can stitch the request back together)."""
        if req.trace_id is None:
            req.trace_id = f"{self._pid:x}-{req.rid}"
        req._trace_sampled = self.enabled and _sampled(req.rid, self.sample)
        req._trace_events = [] if req._trace_sampled else None
        if req._trace_sampled:
            self.traced += 1
            # hold a virtual Chrome track for the request's whole life:
            # concurrent in-flight requests (across ALL engines in the
            # process) land on distinct tids
            req._trace_tid = _acquire_track()
        self._record(req, "submitted", {"prompt_tokens": int(req.prompt.size),
                                        "max_new_tokens": req.max_new_tokens})

    def event(self, req, name, **args):
        if name == "preempted":
            self._count_preemption(args.get("reason", "unknown"))
        self._record(req, name, args)

    def terminal(self, req, name, **args):
        """Final event (finished/rejected/cancelled): records, counts,
        and — for sampled requests — writes the JSONL line and the
        Chrome-trace request track."""
        if name == "rejected":
            self._count_rejection(args.get("reason", "unknown"))
        self._record(req, name, args)
        if self.on_terminal is not None:
            try:
                self.on_terminal(req, name, args)
            except Exception:
                # observability never kills serving — but a broken SLO
                # hook is a real bug and must move a counter
                from mxnet_tpu_torch import telemetry

                telemetry._note_internal_error("on_terminal_hook")
        events = getattr(req, "_trace_events", None)
        if events is None:
            return
        req._trace_events = None       # finalize exactly once
        self._write_line(req, name, events)
        self._emit_track(req, events)

    def _record(self, req, name, args):
        t = time.perf_counter()
        self._flight.record("request", rid=req.rid, ev=name, **args)
        events = getattr(req, "_trace_events", None)
        if events is not None:
            ev = {"ev": name, "t": t}
            if args:
                ev.update(args)
            events.append(ev)

    # -- JSONL export ------------------------------------------------------
    def _write_line(self, req, status, events):
        record = {"trace_id": req.trace_id, "rid": req.rid,
                  "tenant": getattr(req, "tenant", None),
                  "status": status,
                  "prompt_tokens": int(req.prompt.size),
                  "max_new_tokens": req.max_new_tokens,
                  "generated": len(req.tokens),
                  "n_preemptions": req.n_preemptions,
                  "events": events}
        if self.identity is not None:      # only-when-set: schema pin
            record["replica"] = self.identity
            # perf_counter↔epoch anchor: event "t" fields are
            # perf-domain and processes don't share a perf epoch, so
            # fleet lines (identity set ⇒ multi-process timeline
            # exists) carry the pair timeline_report solves for the
            # offset with.  Bare-engine lines keep the historic schema
            epoch = time.time()  # mxtpu-lint: disable=wall-clock (cross-process trace-stitch anchor)
            record["clock"] = {"perf": time.perf_counter(),
                               "epoch": epoch}
        if self.model is not None:         # only-when-set: schema pin
            record["model"] = self.model
        adapter = getattr(req, "adapter_id", None)
        if adapter is not None:            # only-when-set: schema pin
            record["adapter"] = adapter
        if self.source != "serve":
            # mark non-engine lines (the router's) so the collector's
            # SLO layer can tell client-truth lines from replica-local
            # ones; engine lines keep their historical schema
            record["source"] = self.source
        if self._pusher is not None:
            self._pusher.push(record)
        if self.path is None:
            return
        line = json.dumps(record)
        try:
            with self._lock:
                if self._file is None:
                    d = os.path.dirname(self.path)
                    if d:
                        os.makedirs(d, exist_ok=True)
                    self._file = open(self.path, "a")
                self._file.write(line + "\n")
                self._file.flush()     # a crash loses no finished request
            self.written += 1
        except OSError:
            pass                       # tracing must never kill serving

    def close(self):
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    # -- Chrome-trace request tracks ---------------------------------------
    def _emit_track(self, req, events):
        tid = getattr(req, "_trace_tid", None)
        if tid is None:
            return
        req._trace_tid = None
        try:
            from mxnet_tpu_torch import telemetry

            if telemetry.enabled():
                tracer = telemetry.tracer()
                tracer.set_track_name(
                    tid, f"serve-req-slot-{tid - _TRACK_BASE}")
                base = {"rid": req.rid, "trace_id": req.trace_id}
                for name, start, end, extra in _phases(events):
                    tracer.add_complete(name, start, end,
                                        args=dict(base, **extra), tid=tid,
                                        cat="request")
        finally:
            _release_track(tid)


def _phases(events):
    """Reduce an event timeline to (phase, start_t, end_t, args)
    intervals: queued / prefill / decode / preempted.

    ``tools/trace_report.py`` applies the SAME boundary rules in its
    own stdlib-only ``phase_breakdown`` (it must run without importing
    this package); tests/test_observability.py pins the two
    implementations to agree on a shared timeline — change the
    attribution here and there together."""
    if not events:
        return []
    out = []
    end_t = events[-1]["t"]
    # boundary state machine over the ordered timeline
    mark_t = events[0]["t"]            # start of the open interval
    state = "queued"
    for ev in events:
        name, t = ev["ev"], ev["t"]
        if name == "prefill_start":
            out.append((state, mark_t, t, {}))
            state, mark_t = "prefill", t
        elif name == "prefill_end":
            out.append((state, mark_t, t,
                        {"resume": bool(ev.get("resume"))}))
            state, mark_t = "decode", t
        elif name == "preempted":
            out.append((state, mark_t, t, {}))
            state, mark_t = "preempted", t
        elif name in TERMINAL_EVENTS:
            extra = {"status": name}
            if "reason" in ev:
                extra["reason"] = ev["reason"]
            out.append((state, mark_t, t, extra))
            state, mark_t = None, t
    if state is not None and end_t > mark_t:   # no terminal event seen
        out.append((state, mark_t, end_t, {"status": "open"}))
    return [(n, s, e, a) for n, s, e, a in out if e >= s]
