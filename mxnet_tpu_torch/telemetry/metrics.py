"""Metrics registry: Counter / Gauge / Histogram families with label
sets, and the shared no-op objects the disabled path hands out.

A copy of ``mxnet_tpu/telemetry/metrics.py``: the same semantics and
consistency errors, so the two packages' registries export the same
text for the same updates.

Model follows Prometheus client conventions (a *family* is the named
metric; ``labels(...)`` resolves one *child* per label-value tuple) so
the text exposition in exporters.py is a straight serialization.  All
mutation goes through per-family locks — instrumented call sites may
live on the PrefetchingIter producer thread, the ShardedTrainer
prefetch thread, or an HTTP scrape thread simultaneously.

The disabled path never reaches any of this: ``telemetry.counter()``
returns the module-level ``NOOP`` singleton whose methods are empty —
one attribute call per event, no locks, no allocation (the contract
tests/test_telemetry.py pins for every instrumented site).
"""

from __future__ import annotations

import bisect
import threading

__all__ = ["Registry", "Counter", "Gauge", "Histogram", "NOOP",
           "DEFAULT_BUCKETS"]

# latency-oriented default buckets (seconds), Prometheus client defaults
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class _Noop:
    """Shared do-nothing stand-in for every metric object when
    telemetry is disabled.  ``labels()`` returns itself, so cached
    children at instrumented sites are this same singleton."""

    __slots__ = ()

    def labels(self, *args, **kwargs):
        return self

    def inc(self, amount=1):
        pass

    def dec(self, amount=1):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass


NOOP = _Noop()


class _Child:
    """One (family, label-values) time series."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0.0


class _CounterChild(_Child):
    __slots__ = ()

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self.value += amount


class _GaugeChild(_Child):
    __slots__ = ()

    def set(self, value):
        with self._lock:
            self.value = float(value)

    def inc(self, amount=1):
        with self._lock:
            self.value += amount

    def dec(self, amount=1):
        with self._lock:
            self.value -= amount


class _HistogramChild:
    __slots__ = ("_lock", "_uppers", "bucket_counts", "sum", "count")

    def __init__(self, lock, uppers):
        self._lock = lock
        self._uppers = uppers              # finite upper bounds, sorted
        self.bucket_counts = [0] * (len(uppers) + 1)   # + the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value):
        value = float(value)
        i = bisect.bisect_left(self._uppers, value)
        with self._lock:
            self.bucket_counts[i] += 1
            self.sum += value
            self.count += 1

    def cumulative(self):
        """[(upper_bound, cumulative_count)] with the trailing +Inf
        (``float('inf')``) bucket — the Prometheus ``le`` view."""
        with self._lock:
            counts = list(self.bucket_counts)
        out, acc = [], 0
        for ub, c in zip(list(self._uppers) + [float("inf")], counts):
            acc += c
            out.append((ub, acc))
        return out


class _Family:
    kind = None

    def __init__(self, name, help, label_names):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children = {}

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values, **kv):
        if values and kv:
            raise ValueError("pass label values positionally or by "
                             "keyword, not both")
        if kv:
            if set(kv) != set(self.label_names):
                raise ValueError(
                    f"{self.name}: expected labels {self.label_names}, "
                    f"got {tuple(sorted(kv))}")
            key = tuple(str(kv[n]) for n in self.label_names)
        else:
            if len(values) != len(self.label_names):
                raise ValueError(
                    f"{self.name}: expected {len(self.label_names)} label "
                    f"values, got {len(values)}")
            key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
            return child

    def _default(self):
        if self.label_names:
            raise ValueError(
                f"{self.name} has labels {self.label_names}; resolve a "
                "child with .labels(...) first")
        return self.labels()

    # label-free convenience: family acts as its own single child
    def inc(self, amount=1):
        self._default().inc(amount)

    def dec(self, amount=1):
        self._default().dec(amount)

    def set(self, value):
        self._default().set(value)

    def observe(self, value):
        self._default().observe(value)

    def children(self):
        """Sorted [(label_values_tuple, child)] snapshot."""
        with self._lock:
            return sorted(self._children.items())


class Counter(_Family):
    kind = "counter"

    def _new_child(self):
        return _CounterChild(self._lock)


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild(self._lock)


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help, label_names, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, label_names)
        uppers = sorted(float(b) for b in buckets if b != float("inf"))
        if not uppers:
            raise ValueError("histogram needs at least one finite bucket")
        self.buckets = tuple(uppers)

    def _new_child(self):
        return _HistogramChild(self._lock, self.buckets)


class Registry:
    """Process-wide metric store: get-or-create families by name, with
    kind/label-schema consistency enforced (two call sites registering
    the same name must agree, or one of them is silently measuring the
    wrong thing)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families = {}

    def _get_or_create(self, cls, name, help, label_names, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}, not {cls.kind}")
                if fam.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{fam.label_names}, not {tuple(label_names)}")
                if "buckets" in kw:
                    want = tuple(sorted(float(b) for b in kw["buckets"]
                                        if b != float("inf")))
                    if fam.buckets != want:
                        raise ValueError(
                            f"histogram {name!r} already registered with "
                            f"buckets {fam.buckets}, not {want} — two "
                            "sites observing into different bounds would "
                            "silently misbucket one of them")
                return fam
            fam = cls(name, help, label_names, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name, help="", label_names=()):
        return self._get_or_create(Counter, name, help, label_names)

    def gauge(self, name, help="", label_names=()):
        return self._get_or_create(Gauge, name, help, label_names)

    def histogram(self, name, help="", label_names=(),
                  buckets=DEFAULT_BUCKETS):
        return self._get_or_create(Histogram, name, help, label_names,
                                   buckets=buckets)

    def collect(self):
        """Sorted family list (stable exposition/snapshot order)."""
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def snapshot(self):
        """JSON-serializable view: {name: {kind, help, label_names,
        samples}}; histogram samples carry cumulative buckets with
        ``+Inf`` spelled as a string (JSON has no Infinity)."""
        out = {}
        for fam in self.collect():
            samples = []
            for key, child in fam.children():
                labels = dict(zip(fam.label_names, key))
                if fam.kind == "histogram":
                    samples.append({
                        "labels": labels,
                        "count": child.count,
                        "sum": child.sum,
                        "buckets": [["+Inf" if ub == float("inf")
                                     else ub, c]
                                    for ub, c in child.cumulative()],
                    })
                else:
                    samples.append({"labels": labels, "value": child.value})
            out[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "label_names": list(fam.label_names),
                             "samples": samples}
        return out

    def clear(self):
        """Drop every family (tests).  Handles cached by instrumented
        sites keep working but detach from future snapshots."""
        with self._lock:
            self._families.clear()
