"""Unified telemetry: one process-wide metrics registry + host span
tracer feeding shared exporters (Prometheus text / HTTP, JSONL, Chrome
trace).

The port of ``mxnet_tpu/telemetry``: the same switches, defaults,
metric families, artifacts and endpoints, over the port's own copies of
the reference's modules.  ``jaxmon`` becomes ``cudamon`` (kernel builds
and CUDA-graph captures), a span annotates an active ``torch.profiler``
capture, and ``perf_attrib`` times sampled program calls with CUDA
events.

Everything is **off by default** and env-gated:

  MXTPU_TELEMETRY=1            enable (or call ``telemetry.enable()``)
  MXTPU_TELEMETRY_DIR          artifact dir for the atexit dump
                               (default ./mxtpu_telemetry)
  MXTPU_TELEMETRY_HTTP_PORT    also serve live /metrics + /statusz
                               endpoints

Request-scoped observability rides the same package (each with its own
opt-in; docs/how_to/observability.md):

  MXTPU_REQUEST_TRACE[=path]   per-request serve timelines, JSONL
                               (request_trace.py; sample-rate knob
                               MXTPU_REQUEST_TRACE_SAMPLE)
  MXTPU_FLIGHT_DIR             flight-recorder auto-dump directory
                               (flight.py; the in-memory ring is
                               always on)
  MXTPU_NUMERIC_WATCH=1        NaN/Inf watchdog on serve logits

Disabled, every accessor returns a shared no-op object — instrumented
hot paths (serve.Engine, ShardedTrainer) pay one attribute call per
event and allocate nothing.  Enabled, a run leaves ``metrics.prom``
(Prometheus text exposition), ``metrics.jsonl`` (appended snapshot log)
and ``host_trace.json`` (Chrome trace, opens in Perfetto next to
profiler.py's device traces) under the telemetry dir;
``tools/metrics_report.py`` renders any of them as a table.

Typical use:

    from mxnet_tpu_torch import telemetry
    telemetry.enable()                       # or MXTPU_TELEMETRY=1
    reqs = telemetry.counter("myapp_requests_total", "requests served")
    reqs.inc()
    with telemetry.span("load_shard", shard=3):
        ...
    telemetry.dump()                         # write the artifact set
"""

from __future__ import annotations

import atexit
import functools
import os

from . import (cudamon, exporters, flight, metrics, profiling,
               request_trace, statusz, timeseries, tracing)
from .exporters import (append_jsonl, serve_http, to_prometheus_text,
                        write_prometheus)
from .flight import FlightRecorder
from .metrics import DEFAULT_BUCKETS, NOOP, Registry
from .request_trace import RequestTracer
from .tracing import NOOP_SPAN, SpanTracer

__all__ = ["enabled", "enable", "disable", "reset", "counter", "gauge",
           "histogram", "span", "traced", "registry", "tracer",
           "snapshot", "dump", "out_dir", "NOOP", "NOOP_SPAN",
           "DEFAULT_BUCKETS", "to_prometheus_text", "write_prometheus",
           "append_jsonl", "serve_http", "Registry", "SpanTracer",
           "flight", "statusz", "profiling", "request_trace",
           "timeseries", "cudamon", "FlightRecorder", "RequestTracer"]

_enabled = False
_registry = Registry()
_tracer = SpanTracer()
_out_dir = None
_http_server = None
_atexit_registered = False


def enabled():
    """Whether telemetry is recording in this process."""
    return _enabled


def registry():
    """The process-wide Registry (real object even when disabled —
    instrumented sites just never reach it then)."""
    return _registry


def tracer():
    return _tracer


def out_dir():
    """The artifact directory dump() writes into."""
    return _out_dir or os.environ.get("MXTPU_TELEMETRY_DIR") \
        or "mxtpu_telemetry"


def enable(dir=None, http_port=None, atexit_dump=False):
    """Turn recording on (idempotent).  ``dir`` overrides the artifact
    directory; ``http_port`` starts a live /metrics endpoint;
    ``atexit_dump`` registers the end-of-process artifact write (the
    env-var path sets it — programmatic callers dump() explicitly)."""
    global _enabled, _out_dir, _http_server, _atexit_registered
    _enabled = True
    if dir is not None:
        _out_dir = dir
    cudamon.install(_registry, enabled)
    if http_port is not None and _http_server is None:
        try:
            _http_server = serve_http(_registry, int(http_port))
        except OSError as e:
            # e.g. two workers inheriting one MXTPU_TELEMETRY_HTTP_PORT:
            # losing the endpoint must not turn `import mxnet_tpu` into
            # a crash — telemetry degrades, the program runs
            import warnings

            warnings.warn(f"telemetry: /metrics endpoint on port "
                          f"{http_port} unavailable ({e}); metrics are "
                          "still collected and dumped to files",
                          stacklevel=2)
    if atexit_dump and not _atexit_registered:
        _atexit_registered = True
        atexit.register(_atexit_dump)
    return _registry


def disable():
    """Stop recording spans and CUDA events.  Already-collected data is
    kept (dump() still works).  NOTE the handle-caching asymmetry:
    sites that re-fetch handles per call (the request tracer's
    counters) go back to the no-op objects, but objects built while
    enabled (serve.Engine, StatsRecorder, ShardedTrainer) cached real
    metric
    handles at construction and keep recording into the registry —
    symmetrically, objects built while DISABLED cached the no-ops and
    stay silent after a later enable().  Construct instrumented
    objects after enable(), and treat disable() as "stop new spans",
    not a per-site mute."""
    global _enabled
    _enabled = False


def reset():
    """Drop all collected metrics and spans (tests)."""
    _registry.clear()
    _tracer.clear()


# -- accessors: real objects when enabled, shared no-ops when not --------
def counter(name, help="", label_names=()):
    if not _enabled:
        return NOOP
    return _registry.counter(name, help, label_names)


def gauge(name, help="", label_names=()):
    if not _enabled:
        return NOOP
    return _registry.gauge(name, help, label_names)


def histogram(name, help="", label_names=(), buckets=DEFAULT_BUCKETS):
    if not _enabled:
        return NOOP
    return _registry.histogram(name, help, label_names, buckets)


def span(name, **args):
    """Context manager recording one host span (Chrome-trace X event;
    also annotates an active torch.profiler capture)."""
    if not _enabled:
        return NOOP_SPAN
    return _tracer.span(name, **args)


def traced(name=None):
    """Decorator form of :func:`span` (enablement checked per call, so
    decorating at import time is safe)."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _enabled:
                return fn(*args, **kwargs)
            with _tracer.span(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def snapshot():
    """JSON-serializable snapshot for bench records and dashboards:
    ``{"enabled": bool, "metrics": {...}}``."""
    return {"enabled": _enabled, "metrics": _registry.snapshot()}


def dump(dir=None):
    """Write the artifact set; returns {kind: path}.

    metrics.prom       Prometheus text exposition (overwritten)
    metrics.jsonl      appended timestamped snapshot line
    host_trace.json    Chrome-trace JSON of the host spans
    """
    d = dir or out_dir()
    os.makedirs(d, exist_ok=True)
    return {
        "prometheus": write_prometheus(
            _registry, os.path.join(d, "metrics.prom")),
        "jsonl": append_jsonl(_registry, os.path.join(d, "metrics.jsonl")),
        "trace": _tracer.write(os.path.join(d, "host_trace.json")),
    }


def _note_internal_error(site):
    """Count a telemetry-internal failure on
    ``mxtpu_telemetry_errors_total{site}`` — observability failures
    must at least move a counter (mxtpu-lint swallowed-exception),
    even though they may never raise into the caller."""
    try:
        _registry.counter("mxtpu_telemetry_errors_total",
                          "telemetry-internal failures",
                          ("site",)).labels(site=site).inc()
    # mxtpu-lint: disable=swallowed-exception (last-resort guard: the
    # error accountant itself must never raise into serving code)
    except Exception:
        pass


def _atexit_dump():
    try:
        dump()
    except Exception:
        # never let telemetry turn a clean exit into a traceback — but
        # leave a trace for anyone still scraping /metrics at teardown
        _note_internal_error("atexit_dump")


# one parser for every MXTPU_* boolean knob (base.env_flag), so the
# accepted spellings can't fork between telemetry and the rest of the
# stack (mxtpu-lint env-discipline)
from ..base import env_flag  # noqa: E402

if env_flag("MXTPU_TELEMETRY", False):
    _port = os.environ.get("MXTPU_TELEMETRY_HTTP_PORT")
    enable(dir=os.environ.get("MXTPU_TELEMETRY_DIR"),
           http_port=int(_port) if _port else None,
           atexit_dump=True)
