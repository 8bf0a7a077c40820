"""Time-series ring: periodic metric snapshots -> windowed rates.

A copy of ``mxnet_tpu/telemetry/timeseries.py`` over the port's
registry.

The metrics registry (metrics.py) holds *monotonic* counters — tokens
generated, rejections, handoff bytes — which answer "how much, ever".
Operations questions are windowed: "tokens/sec over the last minute",
"p90 queue depth over the last five".  Prometheus answers those
server-side with ``rate()``; this module is the in-process analog, so
the serve monitor, the ``/statusz`` page and the fleet collector can
read windowed rates *locally* with no external scraper deployed.

A :class:`TimeSeriesRing` is a bounded ring of ``(t, {series: value})``
samples.  Values come from anywhere flat — :func:`flatten_registry`
folds the process registry into one dict (histograms contribute
``_count``/``_sum``), :func:`parse_prometheus_text` does the same for
a scraped ``/metrics`` body (the fleet collector feeds per-replica
rings from replicas' scraped statusz + metrics) — and the read side is

  ``rate(name, window_s)``          per-second increase of a counter
                                    (reset-aware: a restarted process
                                    restarts the series, not the math)
  ``delta(name, window_s)``         absolute increase over the window
  ``quantile_over(name, window_s)`` nearest-rank quantile of sampled
                                    values (gauges: queue depth, KV
                                    utilization)
  ``latest(name)`` / ``series(name, window_s)``

The reference's process-global ring (``MXTPU_TIMESERIES``,
``_INTERVAL``) is not here: its only sampler is the reference's
``ServeMonitor`` logging beat (``mxnet_tpu/monitor.py``), which comes
with the training framework core (ROADMAP §A15).  Until then
:func:`refuse_env` raises when ``MXTPU_TIMESERIES`` asks for a ring,
and the serving engine calls it, so the switch is never ignored.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque

__all__ = ["TimeSeriesRing", "flatten_registry", "parse_prometheus_text",
           "nearest_rank", "refuse_env", "ENV_CAPACITY"]


def nearest_rank(sorted_vals, q):
    """Nearest-rank quantile of an ascending list (None when empty) —
    THE quantile convention for the whole observability stack: the
    serve stats reservoirs, the ring's ``quantile_over`` and the fleet
    collector all call this one helper, so their percentiles can never
    disagree on the same data.  (``tools/trace_report.py`` carries an
    intentionally separate copy: it must stay stdlib-only.)"""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[int(idx)]

ENV_CAPACITY = "MXTPU_TIMESERIES"

# the /statusz "rates" teaser: headline serve counters rendered as
# 60-second windowed rates when present in the ring
_HEADLINE = (
    ("mxtpu_serve_tokens_generated_total", "tokens_per_sec"),
    ("mxtpu_serve_completed_total", "completed_per_sec"),
    ("mxtpu_serve_backpressure_rejects_total", "rejects_per_sec"),
    ("mxtpu_fleet_handoff_bytes_total{direction=received}",
     "handoff_recv_bytes_per_sec"),
)


def _series_key(name, label_names, label_values):
    if not label_names:
        return name
    labels = ",".join(f"{n}={v}"
                      for n, v in zip(label_names, label_values))
    return f"{name}{{{labels}}}"


def flatten_registry(registry):
    """One flat ``{series_key: float}`` view of a metrics Registry:
    counters/gauges contribute their value under
    ``name{label=value,...}`` (bare ``name`` when label-free);
    histograms contribute ``name_count`` and ``name_sum`` (both
    monotonic, so ``rate()`` works on them — count/sec and the mean
    over a window as ``delta(sum)/delta(count)``)."""
    out = {}
    for fam in registry.collect():
        for key, child in fam.children():
            if fam.kind == "histogram":
                out[_series_key(fam.name + "_count", fam.label_names,
                                key)] = float(child.count)
                out[_series_key(fam.name + "_sum", fam.label_names,
                                key)] = float(child.sum)
            else:
                out[_series_key(fam.name, fam.label_names,
                                key)] = float(child.value)
    return out


# one exposition line: name{labels} value  (labels optional; the
# histogram _bucket series are skipped — quantiles over raw samples
# are the ring's own job).  The value is matched loosely and parsed
# by float(): a character-class would silently drop legal spellings
# (repr(6.5e-05) carries a '-' INSIDE the exponent, "+Inf"/"NaN" vary
# by producer), and a dropped sample holes the series with no failure
# counted anywhere.
_PROM_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_prometheus_text(text):
    """Parse a Prometheus 0.0.4 text exposition into the same flat
    ``{series_key: float}`` shape :func:`flatten_registry` produces
    (label quoting stripped; ``_bucket`` series dropped)."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if not m:
            continue
        name, labels, value = m.groups()
        if name.endswith("_bucket"):
            continue
        try:
            v = float(value)
        except ValueError:
            continue
        if labels:
            pairs = _PROM_LABEL.findall(labels)
            key = (name + "{"
                   + ",".join(f"{k}={val}" for k, val in pairs) + "}")
        else:
            key = name
        out[key] = v
    return out


class TimeSeriesRing:
    """Bounded ring of ``(t, values)`` samples with windowed readers.

    Thread-safe: the write side may be a monitor/scrape thread while
    `/statusz` or the fleet view reads.  ``clock`` is injectable
    (fake-clock tests); it must be monotonic — every window computation
    is an elapsed-time question.
    """

    def __init__(self, capacity=512, clock=time.monotonic):
        self.capacity = max(2, int(capacity))
        self.clock = clock
        self._lock = threading.Lock()
        self._samples = deque(maxlen=self.capacity)  # guarded-by: _lock
        self._taken = 0                              # guarded-by: _lock
        self._last_sample_t = None                   # guarded-by: _lock

    # -- write side ----------------------------------------------------------
    def append(self, values, now=None):
        """Record one sample (a flat ``{series: number}`` dict;
        non-numeric values are dropped)."""
        t = self.clock() if now is None else now
        vals = {}
        for k, v in values.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            vals[str(k)] = float(v)
        with self._lock:
            self._samples.append((t, vals))
            self._taken += 1
        return t

    def sample_registry(self, registry, now=None, min_interval_s=0.0):
        """Append a registry snapshot, rate-limited to one sample per
        ``min_interval_s``.  Returns True when a sample was taken."""
        t = self.clock() if now is None else now
        with self._lock:
            if (self._last_sample_t is not None and min_interval_s > 0
                    and t - self._last_sample_t < min_interval_s):
                return False
            self._last_sample_t = t
        self.append(flatten_registry(registry), now=t)
        return True

    # -- read side -----------------------------------------------------------
    def _points(self, name, window_s, now):
        cutoff = None if window_s is None else now - window_s
        with self._lock:
            return [(t, vals[name]) for t, vals in self._samples
                    if name in vals
                    and (cutoff is None or t >= cutoff)]

    def series(self, name, window_s=None, now=None):
        """``[(t, value)]`` of one series, oldest first, optionally
        restricted to the trailing window."""
        now = self.clock() if now is None else now
        return self._points(name, window_s, now)

    def latest(self, name):
        """Most recent value of a series, or None."""
        with self._lock:
            for t, vals in reversed(self._samples):
                if name in vals:
                    return vals[name]
        return None

    def delta(self, name, window_s, now=None):
        """Absolute increase of a monotonic counter over the window —
        reset-aware: a value drop (process restart) contributes the
        fresh life's absolute level, never a negative step."""
        pts = self.series(name, window_s, now)
        if len(pts) < 2:
            return None
        total = 0.0
        for (_, a), (_, b) in zip(pts, pts[1:]):
            total += (b - a) if b >= a else b
        return total

    def rate(self, name, window_s, now=None):
        """Per-second increase of a monotonic counter over the trailing
        window (None with < 2 points or zero elapsed time)."""
        pts = self.series(name, window_s, now)
        if len(pts) < 2:
            return None
        dt = pts[-1][0] - pts[0][0]
        if dt <= 0:
            return None
        return self.delta(name, window_s, now) / dt

    def quantile_over(self, name, window_s, q, now=None):
        """Nearest-rank quantile of a series' sampled values over the
        window (the gauge analog of ``rate``: p90 queue depth)."""
        return nearest_rank(
            sorted(v for _, v in self.series(name, window_s, now)), q)

    def names(self):
        """Every series name currently present in the ring."""
        out = set()
        with self._lock:
            for _, vals in self._samples:
                out.update(vals)
        return sorted(out)

    def __len__(self):
        with self._lock:
            return len(self._samples)

    @property
    def taken(self):
        with self._lock:
            return self._taken

    def span_s(self):
        """Elapsed time covered by the ring's samples."""
        with self._lock:
            if len(self._samples) < 2:
                return 0.0
            return self._samples[-1][0] - self._samples[0][0]

    def statusz(self):
        """The ``/statusz`` ``timeseries`` section: ring shape plus
        60-second windowed rates of the headline serve counters."""
        rates = {}
        for name, label in _HEADLINE:
            r = self.rate(name, 60.0)
            if r is not None:
                rates[label] = round(r, 3)
        return {"samples": len(self), "capacity": self.capacity,
                "taken": self.taken, "span_s": round(self.span_s(), 3),
                "series": len(self.names()), "rates_60s": rates}


def refuse_env():
    """Raise when ``MXTPU_TIMESERIES`` asks for the process-global ring
    (a capacity > 0): its sampler, ``ServeMonitor``, is not ported."""
    from ..base import env_int

    if env_int(ENV_CAPACITY, 0) > 0:
        raise NotImplementedError(
            f"{ENV_CAPACITY}: the process-global time-series ring is not "
            "ported yet; its sampler is the reference's ServeMonitor "
            "(ROADMAP §A item 15)")
