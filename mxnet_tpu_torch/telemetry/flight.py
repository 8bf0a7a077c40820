"""Flight recorder: an always-on bounded ring of recent events, dumped
atomically to disk when something goes wrong.

A copy of ``mxnet_tpu/telemetry/flight.py`` over the port's registry
and ``/statusz`` providers.

Request tracing answers "what happened to this request" — but only if
it was enabled and sampled.  The flight recorder answers "what was the
engine doing in the 30 seconds before it fell over" WITHOUT requiring
any foresight: recording is always on (a bounded ``deque`` append per
event — request lifecycle events, scheduler decisions, per-step
summaries, error/anomaly markers), and the ring is written out as one
atomic JSON file when

  * an engine ``step()`` raises an unhandled exception,
  * an SLO breach fires (a deadline-miss rejection, or the rejection
    rate over the recent-submit window crossing
    ``MXTPU_FLIGHT_REJECT_RATE``),
  * a numeric anomaly trips the watchdog (``MXTPU_NUMERIC_WATCH``), or
  * a caller asks (:func:`dump_now`, the post-mortem "give me
    everything right now" hook).

Automatic dumps are opt-in via ``MXTPU_FLIGHT_DIR`` (no directory, no
files — the ring still records so an explicit ``dump_now(dir=...)``
works).  ``MXTPU_FLIGHT_EVENTS`` sizes the ring (default 4096).  Dumps
are rate-limited per reason (:attr:`FlightRecorder.min_dump_interval_s`)
so a storm of identical breaches cannot fill the disk; engine-exception
dumps bypass the limit (``force=True``).

Each dump also embeds the telemetry registry snapshot and the
``/statusz`` provider snapshot, so the post-mortem file is
self-contained even when no exporter was running.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

__all__ = ["FlightRecorder", "recorder", "dump_now", "record_anomaly",
           "ENV_DIR", "ENV_EVENTS", "ENV_REJECT_RATE"]

ENV_DIR = "MXTPU_FLIGHT_DIR"
ENV_EVENTS = "MXTPU_FLIGHT_EVENTS"
ENV_REJECT_RATE = "MXTPU_FLIGHT_REJECT_RATE"

DEFAULT_EVENTS = 4096


class FlightRecorder:
    """Bounded ring of ``(ts, kind, fields)`` records + atomic dumps."""

    def __init__(self, max_events=None, min_dump_interval_s=30.0):
        if max_events is None:
            from ..base import env_int

            max_events = env_int(ENV_EVENTS, DEFAULT_EVENTS)
        self.max_events = max(1, int(max_events))
        self.min_dump_interval_s = float(min_dump_interval_s)
        self._lock = threading.Lock()
        self._events = deque(maxlen=self.max_events)  # guarded-by: _lock
        self._seen = 0                                # guarded-by: _lock
        # reason -> monotonic time of last dump (rate limiting must not
        # ride the wall clock: an NTP step backwards would re-arm — or
        # suppress — every reason at once)
        self._last_dump = {}                          # guarded-by: _lock
        self.dumps = 0                                # guarded-by: _lock

    # -- recording (the always-on hot path) --------------------------------
    def record(self, kind, **fields):
        """Append one event to the ring (cheap: one locked deque
        append; the ``maxlen`` deque evicts the oldest on overflow)."""
        # caller fields first, then the reserved keys — "t"/"kind" are
        # the ring's own schema and must never be clobbered by a
        # caller's same-named payload field
        ev = dict(fields) if fields else {}
        # post-mortem events correlate with external logs by timestamp
        # mxtpu-lint: disable=wall-clock (wall timestamp is the point)
        ev["t"] = time.time()
        ev["kind"] = kind
        with self._lock:
            self._events.append(ev)
            self._seen += 1

    def events(self):
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._events)

    @property
    def seen(self):
        """Total events ever recorded (``seen - len(events())`` have
        scrolled out of the ring)."""
        with self._lock:
            return self._seen

    def clear(self):
        with self._lock:
            self._events.clear()
            self._seen = 0
            self._last_dump = {}

    # -- dumping -----------------------------------------------------------
    def _dir(self, dir=None):
        return dir or os.environ.get(ENV_DIR)

    def dump(self, reason, dir=None, extra=None, force=False):
        """Write the ring (plus registry + statusz snapshots) to
        ``<dir>/flight-<ms>-<reason>.json`` atomically.  Returns the
        path, or None when no directory is configured (automatic dumps
        are opt-in via ``MXTPU_FLIGHT_DIR``) or the per-reason rate
        limit suppressed this one.  Never raises — a failing post-mortem
        writer must not add a second failure to the first."""
        d = self._dir(dir)
        if not d:
            return None
        # wall for the payload/filename (operators correlate dumps with
        # logs), monotonic for the rate limit (immune to NTP steps)
        # mxtpu-lint: disable=wall-clock (post-mortem file timestamp)
        now = time.time()
        mono = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason)
            if not force and last is not None \
                    and mono - last < self.min_dump_interval_s:
                return None
            self._last_dump[reason] = mono
            events = list(self._events)
            seen = self._seen
        payload = {"ts": round(now, 3), "reason": str(reason),
                   "pid": os.getpid(),
                   "events": events,
                   "events_seen": seen,
                   "ring_capacity": self.max_events}
        if extra:
            payload["extra"] = extra
        # self-contained post-mortem: fold in what the live endpoints
        # would have shown (guarded — the dump must survive a broken
        # provider)
        try:
            from mxnet_tpu_torch import telemetry

            payload["registry"] = telemetry.registry().snapshot()
        except Exception as e:
            # a broken snapshot must not kill the dump — but the dump
            # itself records that its registry section is missing
            payload.setdefault("snapshot_errors", []).append(
                f"registry: {e!r}")
        try:
            from . import statusz

            payload["statusz"] = statusz.snapshot()
        except Exception as e:
            payload.setdefault("snapshot_errors", []).append(
                f"statusz: {e!r}")
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in str(reason))[:64] or "dump"
        path = os.path.join(d, f"flight-{int(now * 1000)}-{safe}.json")
        try:
            os.makedirs(d, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, path)
        except OSError:
            return None
        with self._lock:
            self.dumps += 1
        return path


_recorder = None
_recorder_lock = threading.Lock()


def recorder():
    """The process-wide flight recorder (created on first use)."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def dump_now(reason="on_demand", dir=None):
    """On-demand post-mortem dump of the process-wide ring (bypasses
    the rate limit).  Returns the path or None."""
    return recorder().dump(reason, dir=dir, force=True)


def record_anomaly(site, dump_reason="numeric_anomaly", **info):
    """The numeric-watchdog sink: count
    ``mxtpu_numeric_anomalies_total{site}``, mark the ring, and fire a
    (rate-limited) flight dump — instead of silently corrupting a run.
    Returns the dump path or None."""
    from mxnet_tpu_torch import telemetry

    # straight into the registry (not the enabled-gated accessor): the
    # watchdog is its own opt-in, and an anomaly count must survive even
    # when MXTPU_TELEMETRY is unset — it rides the flight dump
    telemetry.registry().counter(
        "mxtpu_numeric_anomalies_total",
        "NaN/Inf detections by the numeric watchdog",
        ("site",)).labels(site=site).inc()
    rec = recorder()
    rec.record("anomaly", site=site, **info)
    return rec.dump(dump_reason, extra={"site": site, **info})
