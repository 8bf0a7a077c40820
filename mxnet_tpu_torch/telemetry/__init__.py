"""Telemetry, reduced to the disabled path the serving slice calls.

The reference's telemetry (``mxnet_tpu/telemetry``) is off by default:
every accessor then returns a shared no-op object, and that is all the
port's host modules need so far.  ``counter``/``gauge``/``histogram``
return :data:`NOOP` and ``span`` returns :data:`NOOP_SPAN`, so the
instrumented call sites read exactly like the reference's.  The full
registry, exporters and tracers are a later port.

:func:`dump` stands in for the reference's flight-recorder dump
(``telemetry/flight.py``, ROADMAP §A item 14): it keeps the reason and
its fields in a bounded in-memory ring, rate-limited per reason as the
reference's dumps are, where :func:`dumps` reads them.
"""

from __future__ import annotations

import collections
import threading
import time

from . import request_trace, timeseries

__all__ = ["enabled", "counter", "gauge", "histogram", "span", "dump",
           "dumps", "NOOP", "NOOP_SPAN", "request_trace", "timeseries"]

# the reference recorder's per-reason floor between two dumps
MIN_DUMP_INTERVAL_S = 30.0
_DUMPS = collections.deque(maxlen=64)     # guarded-by: _DUMP_LOCK
_LAST_DUMP = {}                           # guarded-by: _DUMP_LOCK
_DUMP_LOCK = threading.Lock()


class _NoopMetric:
    """Shared do-nothing metric: every update and ``labels`` child is
    itself."""

    __slots__ = ()

    def inc(self, amount=1.0):
        pass

    def dec(self, amount=1.0):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass

    def labels(self, **labels):
        return self


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoopMetric()
NOOP_SPAN = _NoopSpan()


def enabled():
    """Whether telemetry is recording (never, in the port so far)."""
    return False


def counter(name, help="", label_names=()):
    return NOOP


def gauge(name, help="", label_names=()):
    return NOOP


def histogram(name, help="", label_names=(), buckets=None):
    return NOOP


def span(name, **args):
    return NOOP_SPAN


def dump(reason, extra=None):
    """Record an anomaly ``reason`` with its ``extra`` fields; returns
    the record, or None when the per-reason rate limit suppressed it."""
    mono = time.monotonic()
    with _DUMP_LOCK:
        last = _LAST_DUMP.get(reason)
        if last is not None and mono - last < MIN_DUMP_INTERVAL_S:
            return None
        _LAST_DUMP[reason] = mono
        rec = {"reason": str(reason), "extra": dict(extra or {})}
        _DUMPS.append(rec)
    return rec


def dumps(clear=False):
    """The recorded anomalies, oldest first (``clear`` empties the ring
    and the rate limits)."""
    with _DUMP_LOCK:
        out = list(_DUMPS)
        if clear:
            _DUMPS.clear()
            _LAST_DUMP.clear()
    return out
