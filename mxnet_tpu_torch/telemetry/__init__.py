"""Telemetry, reduced to the disabled path the serving slice calls.

The reference's telemetry (``mxnet_tpu/telemetry``) is off by default:
every accessor then returns a shared no-op object, and that is all the
port's host modules need so far.  ``counter``/``gauge``/``histogram``
return :data:`NOOP` and ``span`` returns :data:`NOOP_SPAN`, so the
instrumented call sites read exactly like the reference's.  The full
registry, exporters and tracers are a later port.
"""

from __future__ import annotations

from . import request_trace, timeseries

__all__ = ["enabled", "counter", "gauge", "histogram", "span", "NOOP",
           "NOOP_SPAN", "request_trace", "timeseries"]


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
