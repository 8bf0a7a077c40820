"""Host-side span tracer emitting Chrome-trace-format JSON.

The port of ``mxnet_tpu/telemetry/tracing.py``.  ``profiler.py``
captures what the *device* does (``torch.profiler`` traces with the
card's kernels); this tracer captures what the *host* does around it —
dispatch, warm-up and capture, optimizer update, serve step — as
complete ("ph": "X") events that Perfetto / chrome://tracing load
directly.  Open the host trace next to the device trace and the host
phases line up against device time.

While a ``torch.profiler`` capture is active (``profiler.start()``),
every span also enters a ``torch.profiler.record_function`` of its
name, so the same host phases appear *inside* the device trace too;
with no capture running a span enters nothing (one flag read), where
the reference enters a ``jax.profiler.TraceAnnotation`` always.

Events are buffered in a bounded in-memory RING (``max_events``): on
overflow the OLDEST event is evicted and counted in ``dropped``, so a
long-running serve always keeps the most recent tail — exactly the
window a post-mortem needs (dropping the newest would discard the
moments before the failure).  The buffer is written by
:meth:`SpanTracer.write` or the telemetry atexit dump.

Besides the implicit per-OS-thread tracks, callers may emit events on
*virtual* tracks (explicit ``tid`` + :meth:`SpanTracer.set_track_name`)
— the request tracer renders one track per in-flight serve request this
way, next to the host-thread spans.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time

__all__ = ["SpanTracer", "NOOP_SPAN"]


class _NoopSpan:
    """Reentrant do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


def _profiler_active():
    """Whether a torch profiler capture is recording (torch is loaded
    by then: only ``torch.profiler`` starts one)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return bool(torch._C._autograd._profiler_enabled())
    except Exception:
        return False


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "_ann")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._ann = None

    def __enter__(self):
        if _profiler_active():
            try:
                import torch

                self._ann = torch.profiler.record_function(self.name)
                self._ann.__enter__()
            except Exception:
                self._ann = None
                self._tracer.ann_errors += 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self._ann is not None:
            try:
                self._ann.__exit__(*exc)
            except Exception:
                # the host span must still land; the failure is
                # visible as a counter on the tracer (ann_errors)
                self._tracer.ann_errors += 1
        self._tracer.add_complete(self.name, self._t0, end, self.args)
        return False


class SpanTracer:
    def __init__(self, max_events=200_000):
        self.max_events = int(max_events)
        self.dropped = 0
        # record_function enter/exit failures (counted, never raised —
        # spans still record host-side)
        self.ann_errors = 0
        self._events = collections.deque()
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._track_names = {}         # explicit tid -> display name
        # perf_counter epoch all span timestamps are relative to
        self._t0 = time.perf_counter()

    def span(self, name, **args):
        """Context manager recording one complete event around a block."""
        return _Span(self, name, args)

    def _push(self, ev):
        # ring semantics: evict the OLDEST event on overflow so the
        # buffer always holds the newest tail; evictions count in
        # ``dropped``
        with self._lock:
            while len(self._events) >= self.max_events:
                self._events.popleft()
                self.dropped += 1
            self._events.append(ev)

    def add_complete(self, name, start, end, args=None, tid=None,
                     cat="host"):
        ev = {"name": name, "ph": "X", "cat": cat,
              "pid": self._pid,
              "tid": threading.get_ident() if tid is None else int(tid),
              "ts": (start - self._t0) * 1e6,
              "dur": max(0.0, (end - start) * 1e6)}
        if args:
            ev["args"] = dict(args)
        self._push(ev)

    def instant(self, name, _tid=None, **args):
        """Zero-duration marker ("ph": "i")."""
        ev = {"name": name, "ph": "i", "s": "t", "cat": "host",
              "pid": self._pid,
              "tid": threading.get_ident() if _tid is None else int(_tid),
              "ts": (time.perf_counter() - self._t0) * 1e6}
        if args:
            ev["args"] = dict(args)
        self._push(ev)

    def now(self):
        """Current timestamp on this tracer's clock (perf_counter —
        pass to :meth:`add_complete` start/end)."""
        return time.perf_counter()

    def set_track_name(self, tid, name):
        """Name a virtual track (explicit-tid events, e.g. one per
        in-flight serve request)."""
        with self._lock:
            self._track_names[int(tid)] = str(name)

    def trace_events(self):
        """Buffered events plus the process/thread metadata records
        Perfetto uses for track names."""
        with self._lock:
            events = list(self._events)
            track_names = dict(self._track_names)
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "args": {"name": "mxtpu host"}}]
        for tid in sorted({e["tid"] for e in events}):
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": self._pid, "tid": tid,
                         "args": {"name": track_names.get(
                             tid, f"host-thread-{tid}")}})
        return meta + events

    def write(self, path):
        """Write the Chrome-trace JSON object form (Perfetto /
        chrome://tracing / ``profiler.summarize``-style consumers)."""
        # event "ts" fields are relative to self._t0 (a perf_counter
        # stamp with no cross-process meaning); the anchor maps ts=0
        # to the wall clock so tools/timeline_report.py can align this
        # file with other replicas' traces and device captures
        # mxtpu-lint: disable=wall-clock (cross-process trace-stitch anchor)
        t0_epoch = time.time() - (time.perf_counter() - self._t0)
        payload = {"traceEvents": self.trace_events(),
                   "displayTimeUnit": "ms",
                   "otherData": {"producer": "mxnet_tpu_torch.telemetry",
                                 "dropped_events": self.dropped,
                                 "t0_epoch": t0_epoch}}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path

    def clear(self):
        with self._lock:
            self._events = collections.deque()
            self._track_names = {}
            self.dropped = 0
