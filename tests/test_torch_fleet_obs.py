"""The PyTorch port's fleet sensors against the JAX reference
(``mxnet_tpu_torch/telemetry/timeseries.py``'s process-global ring,
``monitor.ServeMonitor``, ``fleet/slo.py`` and ``fleet/collector.py``).

Ports ``tests/test_fleet_obs.py`` case by case (all but the slow
``fleet_bench`` contract): the time-series ring, ``ServeStats``
percentiles, the SLO grammar and multi-window burn math, the collector
(three-view agreement, scrape isolation, staleness, trace push), the
burn alert under kill/delay chaos, router hop instrumentation,
supervisor lifecycle annotations, the replica's ``/metrics`` and
``/flight_dump``, and ``tools/fleet_report.py`` over the port
collector's view; on port replicas over port engines on the CPU.

Cross-package cases: ``parse_slo_spec`` over the reference's grammar
cases (equal objectives, equal errors), ``Objective.judge`` and the burn
windows on the same request groups under one fake clock, the ring's
rates and quantiles and ``flatten_registry`` against
``parse_prometheus_text`` on the same samples, and ``ServeMonitor``'s
line on a port engine and a reference engine fed the same checkpoint
and prompts (greedy, so their ``stats()`` counts agree).  Also ported:
``ServeMonitor``'s reject reasons and perf tail, the collector's role
MFU aggregates and its stale-row rule.
"""

import json
import logging
import os
import re
import socket
import sys
import time
import urllib.request

import numpy as np
import pytest

import torch_port_fixtures as fx
from torch_port_fixtures import (  # noqa: F401  (autouse / fixtures)
    InProcHandle, collect_engines_after_module, fleet_cleanup,
    fresh_telemetry_per_module, http_get, http_post)

import mxnet_tpu as mx
import mxnet_tpu.fleet.slo as ref_slo
import mxnet_tpu.telemetry as ref_tel
from mxnet_tpu.telemetry import timeseries as ref_ts
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.fleet import (FaultInjector, FleetCollector, Objective,
                                   ReplicaServer, Router, SLOEvaluator,
                                   Supervisor, parse_slo_spec)
from mxnet_tpu_torch.fleet import slo as port_slo
from mxnet_tpu_torch.serve.stats import Reservoir, ServeStats, StatsRecorder
from mxnet_tpu_torch.telemetry import perf_attrib, timeseries
from mxnet_tpu_torch.telemetry.metrics import Registry

VOCAB = fx.VOCAB
HOP_S = 10.0          # per-hop timeout of the routers here


def _engine(**kw):
    return fx.fleet_engine(**kw)


def _prompts(n, seed=7, lo=6, hi=22):
    return fx.prompts(n, seed=seed, lo=lo, hi=hi)


@pytest.fixture
def tel():
    telemetry.reset()
    telemetry.enable()
    yield telemetry.registry()
    telemetry.disable()
    telemetry.reset()


# -- time-series ring ---------------------------------------------------------
def test_timeseries_ring_rates_quantiles_and_eviction():
    clock = {"now": 0.0}
    ring = timeseries.TimeSeriesRing(capacity=4,
                                     clock=lambda: clock["now"])
    for i in range(6):
        clock["now"] = float(i)
        ring.append({"tok_total": 10.0 * i, "queue": i % 3,
                     "skipme": "text"})
    # capacity 4: samples at t=2..5 survive, t=0/1 evicted
    assert len(ring) == 4 and ring.taken == 6
    assert ring.series("tok_total")[0][0] == 2.0
    assert ring.latest("tok_total") == 50.0
    assert ring.latest("skipme") is None          # non-numeric dropped
    # counter rate over the whole retained window: 30 tokens / 3s
    assert ring.rate("tok_total", window_s=10) == pytest.approx(10.0)
    assert ring.delta("tok_total", window_s=10) == pytest.approx(30.0)
    # narrower window: only t in [3.5, 5] -> points at 4, 5
    assert ring.rate("tok_total", window_s=1.5) == pytest.approx(10.0)
    assert ring.quantile_over("queue", 10, 1.0) == 2.0
    assert ring.quantile_over("queue", 10, 0.0) == 0.0
    assert ring.rate("missing", 10) is None
    assert ring.quantile_over("missing", 10, 0.5) is None
    assert ring.span_s() == pytest.approx(3.0)

    # counter RESET (process restart): the fresh life's level counts,
    # never a negative step
    ring2 = timeseries.TimeSeriesRing(capacity=8,
                                      clock=lambda: clock["now"])
    for t, v in [(0, 100.0), (1, 110.0), (2, 5.0), (3, 15.0)]:
        clock["now"] = float(t)
        ring2.append({"c": v})
    # increases: +10, reset->5 (counts 5), +10 => 25 over 3s
    assert ring2.delta("c", 10) == pytest.approx(25.0)


def test_flatten_registry_and_prometheus_parse_agree():
    reg = Registry()
    reg.counter("t_total", "x").inc(7)
    reg.gauge("g", "x", ("role",)).labels(role="decode").set(2.5)
    h = reg.histogram("lat_seconds", "x")
    h.observe(0.1)
    h.observe(0.2)
    flat = timeseries.flatten_registry(reg)
    assert flat["t_total"] == 7.0
    assert flat["g{role=decode}"] == 2.5
    assert flat["lat_seconds_count"] == 2.0
    assert flat["lat_seconds_sum"] == pytest.approx(0.3)
    # the prometheus text round-trip lands on the same keys/values
    parsed = timeseries.parse_prometheus_text(
        telemetry.to_prometheus_text(reg))
    assert parsed["t_total"] == 7.0
    assert parsed["g{role=decode}"] == 2.5
    assert parsed["lat_seconds_count"] == 2.0
    assert "lat_seconds_bucket{le=0.25}" not in parsed  # buckets dropped


def test_global_ring_inert_by_default_and_configurable():
    # inert: no env -> no ring object, sample() is a cheap no-op, and
    # /statusz carries no timeseries section
    timeseries.configure(0)
    assert timeseries.ring() is None
    assert timeseries.sample() is False
    assert "timeseries" not in telemetry.statusz.snapshot()
    try:
        ring = timeseries.configure(32, interval_s=0.0)
        assert timeseries.ring() is ring
        assert timeseries.sample() is True
        snap = telemetry.statusz.snapshot()
        assert snap["timeseries"]["capacity"] == 32
        assert snap["timeseries"]["samples"] >= 1
    finally:
        timeseries.configure(0)
    assert "timeseries" not in telemetry.statusz.snapshot()


def test_serve_monitor_samples_the_ring():
    eng = _engine()
    try:
        timeseries.configure(16, interval_s=0.0)
        mon = mt.monitor.ServeMonitor(eng, interval=1)
        req = eng.submit(_prompts(1)[0], max_new_tokens=3)
        while not req.done:
            eng.step()
            mon.tic()
        assert len(timeseries.ring()) >= 1
    finally:
        timeseries.configure(0)
        eng.shutdown()


def test_timeseries_env_ring_samples_through_the_monitor(monkeypatch, tel):
    """``MXTPU_TIMESERIES`` builds the ring on first use, the monitor's
    log ticks sample the registry into it, and its windowed tokens per
    second come from the engine's own token counter."""
    monkeypatch.setenv("MXTPU_TIMESERIES", "64")
    monkeypatch.setenv("MXTPU_TIMESERIES_INTERVAL", "0")
    timeseries._global_checked = False
    eng = _engine()
    try:
        mon = mt.monitor.ServeMonitor(eng, interval=2)
        for p in _prompts(3, seed=5):
            eng.submit(p, max_new_tokens=6)
        while eng.has_work():
            eng.step()
            mon.tic()
        ring = timeseries.ring()
        assert ring is not None and ring.capacity == 64
        assert len(ring) == ring.taken >= 2
        name = "mxtpu_serve_tokens_generated_total"
        assert ring.latest(name) <= eng.stats().tokens_generated
        assert ring.delta(name, 1e9) == pytest.approx(
            ring.latest(name) - ring.series(name)[0][1])
        assert telemetry.statusz.snapshot()["timeseries"]["samples"] \
            == len(ring)
    finally:
        timeseries.configure(0)
        eng.shutdown()


# -- ServeStats percentiles / TPOT -------------------------------------------
def test_reservoir_bounded_with_exact_aggregates():
    res = Reservoir(capacity=64)
    for i in range(1000):
        res.add(float(i))
    assert res.count == 1000 and res.max == 999.0
    assert res.mean == pytest.approx(499.5)
    assert len(res._sample) == 64                 # bounded
    # a uniform estimate: the median of 0..999 is ~500
    assert 250 <= res.percentile(0.5) <= 750
    small = Reservoir(capacity=64)
    for v in [1.0, 2.0, 3.0, 4.0]:
        small.add(v)
    assert small.percentile(0.5) == 3.0           # exact under capacity
    assert small.percentile(0.99) == 4.0
    assert Reservoir().percentile(0.5) is None


def test_stats_recorder_ttft_tpot_percentiles():
    clock = {"now": 0.0}
    rec = StatsRecorder(clock=lambda: clock["now"])
    for ms in (10, 20, 30, 40, 1000):
        rec.on_first_token(ms / 1e3)

    class _Req:
        first_token_t = 0.0

    # 4 single-token gaps of 50ms, then one 3-token step 150ms later
    # (=> three 50ms per-token observations)
    r = _Req()
    for k in range(1, 5):
        clock["now"] = 0.05 * k
        rec.on_tokens(r, 1)
    clock["now"] = 0.05 * 4 + 0.15
    rec.on_tokens(r, 3)

    class _Sched:
        max_batch = 4
        queue_depth = 0
        running = ()
        rejections = 0
        preemptions = 0
        reject_reasons = {}

        @staticmethod
        def tenant_stats():
            return {}

    class _Blocks:
        blocks_in_use = 0
        total_blocks = 8
        evictions = 0

        @staticmethod
        def utilization():
            return 0.0

        @staticmethod
        def prefix_stats():
            return {"hits": 0, "misses": 0, "hit_rate": None,
                    "tokens_saved": 0, "evictions": 0,
                    "discarded_tokens": 0, "host_hits": 0,
                    "host_restored_tokens": 0}

        @staticmethod
        def host_stats():
            return None

    s = rec.snapshot(_Sched, _Blocks)
    assert s.ttft_ms_p50 == 30.0
    assert s.ttft_ms_p99 == 1000.0 and s.ttft_ms_max == 1000.0
    assert s.ttft_ms_mean == pytest.approx(220.0)
    # all 7 per-token gaps are exactly 50ms
    assert s.tpot_ms_p50 == pytest.approx(50.0)
    assert s.tpot_ms_p99 == pytest.approx(50.0)
    assert s.tpot_ms_mean == pytest.approx(50.0)


def test_engine_feeds_tpot_and_statusz_stats_section(fleet_cleanup):
    rep = ReplicaServer(_engine()).start()
    fleet_cleanup.append(rep)
    code, _ = http_post(rep.url, "/generate",
                        {"prompt": [1, 2, 3, 4], "max_new_tokens": 6})
    assert code == 200
    s = rep.engine.stats()
    assert s.tpot_ms_p50 is not None and s.tpot_ms_p50 >= 0
    assert s.ttft_ms_p99 is not None
    sec = http_get(rep.url, "/statusz.json")["replica"]
    st = sec["stats"]
    assert st["tokens_generated"] == s.tokens_generated == 6
    assert st["completed"] == 1 and st["rejected"] == 0
    assert st["ttft_ms_p99"] == s.ttft_ms_p99
    assert st["tenants"] == {"default": 1}


# -- SLO grammar + burn math --------------------------------------------------
def test_slo_spec_grammar():
    objs = parse_slo_spec(
        "ttft_p99_ms=500;availability=0.999;tpot_p90_ms=80;"
        "total_p99_9_ms=2000")
    assert [o.key for o in objs] == ["ttft_p99_ms", "availability",
                                    "tpot_p90_ms", "total_p99_9_ms"]
    assert objs[0].budget == pytest.approx(0.01)
    assert objs[1].budget == pytest.approx(0.001)
    assert objs[2].budget == pytest.approx(0.10)
    assert objs[3].budget == pytest.approx(0.001)
    assert parse_slo_spec("") == [] and parse_slo_spec(None) == []
    for bad in ("ttft_p99_ms", "bogus=1", "availability=1.5",
                "ttft_p0_ms=5", "ttft_p99_ms=zzz",
                "availability=0.9;availability=0.99"):
        with pytest.raises(ValueError):
            parse_slo_spec(bad)
    # bad-event semantics
    lat = parse_slo_spec("ttft_p99_ms=100")[0]
    assert isinstance(lat, Objective)
    assert lat.is_bad({"status": "finished", "ttft_s": 0.2}) is True
    assert lat.is_bad({"status": "finished", "ttft_s": 0.05}) is False
    assert lat.is_bad({"status": "rejected", "ttft_s": None}) is None
    avail = parse_slo_spec("availability=0.99")[0]
    assert avail.is_bad({"status": "rejected"}) is True
    assert avail.is_bad({"status": "finished"}) is False


SLO_GRAMMAR = ["ttft_p99_ms=500;availability=0.999;tpot_p90_ms=80;"
               "total_p99_9_ms=2000", "", None, " ttft_p50_ms = 12.5 ;",
               "availability=0.5", "total_p90_ms=150",
               "ttft_p99_ms", "bogus=1", "availability=1.5",
               "ttft_p0_ms=5", "ttft_p99_ms=zzz", "tpot_p100_ms=3",
               "availability=0.9;availability=0.99", "total_p99_ms=-1"]


@pytest.mark.parametrize("spec", SLO_GRAMMAR)
def test_slo_spec_parses_as_reference(spec):
    """Each grammar case parses to the reference's objectives (key,
    kind, metric, percentile, target, budget), or fails with the
    reference's message."""
    def parse(mod):
        try:
            return [(o.key, o.kind, o.metric, o.q, o.target, o.budget)
                    for o in mod.parse_slo_spec(spec)]
        except ValueError as e:
            return f"ValueError: {e}"

    assert parse(port_slo) == parse(ref_slo)


def test_request_grouping_and_judging():
    """One client request = one SLO unit, however many lines it
    pushed: router line is the availability truth, latency takes the
    worst observed value, and multi-line requests never dilute the
    bad fraction."""
    from mxnet_tpu_torch.fleet.slo import group_requests, request_failed

    engine_ok = {"trace_id": "a", "status": "finished", "source":
                 "serve", "ttft_s": 0.01, "total_s": 0.02}
    router_slow = {"trace_id": "a", "status": "finished",
                   "source": "router", "ttft_s": None, "total_s": 0.9}
    prefill_ok = {"trace_id": "b", "status": "finished",
                  "source": "serve", "ttft_s": 0.01, "total_s": 0.02}
    router_dead = {"trace_id": "b", "status": "cancelled",
                   "source": "router", "ttft_s": None, "total_s": None}
    solo = {"trace_id": None, "status": "rejected", "source": "serve",
            "ttft_s": None, "total_s": None}
    groups = group_requests([engine_ok, router_slow, prefill_ok,
                             router_dead, solo])
    assert len(groups) == 3
    # availability: the router saw request b fail even though the
    # prefill replica's own line finished (its local 1-token request)
    assert request_failed([prefill_ok, router_dead]) is True
    assert request_failed([engine_ok, router_slow]) is False
    assert request_failed([solo]) is True
    assert request_failed([{"trace_id": "x", "status": "preempted",
                            "source": "serve"}]) is None
    # latency: worst line wins — the request is slow end-to-end even
    # though the engine's own line was fast
    total = parse_slo_spec("total_p99_ms=100")[0]
    assert total.judge([engine_ok, router_slow]) is True
    assert total.judge([engine_ok]) is False
    assert total.judge([router_dead]) is None
    ttft = parse_slo_spec("ttft_p99_ms=100")[0]
    # the router line has no TTFT; the engine line's counts
    assert ttft.judge([engine_ok, router_slow]) is False
    # burn math counts GROUPS: 10 requests with 3 lines each, all
    # failed, must read bad_fraction 1.0 — not 1/3
    clock = {"now": 100.0}
    col = _FakeCollector(lambda: clock["now"])
    for i in range(10):
        for src, status in (("serve", "finished"),
                            ("serve", "finished"),
                            ("router", "cancelled")):
            col.records.append({"t": 99.0, "trace_id": f"req{i}",
                                "status": status, "source": src,
                                "ttft_s": None, "total_s": None,
                                "replica": "r0"})
    ev = SLOEvaluator(parse_slo_spec("availability=0.9"), col,
                      fast_s=10, slow_s=10, fast_burn=1, slow_burn=1,
                      min_requests=5, clock=lambda: clock["now"])
    out = ev.evaluate()
    assert out[0]["total_fast"] == 10 and out[0]["bad_fast"] == 10
    assert out[0]["firing"]


class _FakeCollector:
    """Duck-typed collector for burn-math units: canned records plus
    call recording for annotations and flight dumps."""

    def __init__(self, clock):
        self.records = []
        self.clock = clock
        self.annotations = []
        self.dump_calls = []
        self.urls = {}

    def trace_records(self, window_s, now=None):
        now = self.clock() if now is None else now
        return [r for r in self.records if r["t"] >= now - window_s]

    def annotate(self, kind, **fields):
        self.annotations.append(dict(fields, kind=kind))

    def url_for_replica(self, name):
        return self.urls.get(name)

    def request_flight_dump(self, url, reason):
        self.dump_calls.append((url, reason))
        return f"{url}/dump.json"


def _rec_factory():
    ids = iter(range(10 ** 9))

    def rec(t, status="finished", ttft=0.01, replica="r0"):
        # unique trace id per record: each synthetic line is its own
        # client request (the burn math groups lines by trace id)
        return {"t": t, "status": status, "ttft_s": ttft, "tpot_s": 0.01,
                "total_s": 0.1, "replica": replica,
                "trace_id": f"t{next(ids)}"}

    return rec


def test_burn_rate_multi_window_fake_clock():
    """The SRE-workbook shape under a fake clock: a fresh burst fires
    only once the slow window ALSO burns; records aging out of the
    fast window resolve the alert; min_requests gates noise."""
    _rec = _rec_factory()
    clock = {"now": 1000.0}
    col = _FakeCollector(lambda: clock["now"])
    col.urls["bad-rep"] = "http://x"
    ev = SLOEvaluator(parse_slo_spec("ttft_p99_ms=100"), col,
                      fast_s=10.0, slow_s=100.0, fast_burn=5.0,
                      slow_burn=2.0, min_requests=5,
                      dump_interval_s=30.0,
                      clock=lambda: clock["now"])
    # a long clean history fills the slow window with good requests
    # (enough volume that an 8-request burst cannot burn the SLOW
    # window: 8/608 bad < slow_burn * budget)
    for i in range(600):
        col.records.append(_rec(900.0 + (i % 90), ttft=0.01))
    out = ev.evaluate()
    assert not out[0]["firing"] and out[0]["burn_fast"] == 0.0

    # burst of terrible TTFTs in the fast window: fast burns hard but
    # the slow window still holds 90 good requests -> burn_slow low
    for i in range(8):
        col.records.append(_rec(995.0 + i * 0.5, ttft=0.5,
                                replica="bad-rep"))
    out = ev.evaluate()
    assert out[0]["burn_fast"] >= 5.0
    assert not out[0]["firing"]            # slow window not burning yet

    # sustained: age the clean history out of the slow window
    clock["now"] = 1080.0
    for i in range(10):
        col.records.append(_rec(1070.0 + i, ttft=0.5,
                                replica="bad-rep"))
    out = ev.evaluate()
    assert out[0]["firing"]
    assert any(a["kind"] == "slo_alert" and a["state"] == "firing"
               for a in col.annotations)
    # the flight dump went to the offending replica, once (rate limit)
    assert col.dump_calls == [("http://x", "slo_burn_ttft_p99_ms")]
    ev.evaluate()
    assert len(col.dump_calls) == 1        # inside dump_interval_s
    # the registry-direct burning counter moved (no MXTPU_TELEMETRY)
    snap = telemetry.registry().snapshot().get("mxtpu_slo_burning")
    assert snap and any(s["labels"]["objective"] == "ttft_p99_ms"
                        and s["value"] >= 2 for s in snap["samples"])

    # recovery: bad records age out of the fast window
    clock["now"] = 1200.0
    for i in range(10):
        col.records.append(_rec(1195.0 + i * 0.4, ttft=0.01))
    out = ev.evaluate()
    assert not out[0]["firing"]
    assert any(a["kind"] == "slo_alert" and a["state"] == "resolved"
               for a in col.annotations)

    # min_requests: 3 terrible requests alone are noise, not an alert
    col2 = _FakeCollector(lambda: clock["now"])
    ev2 = SLOEvaluator(parse_slo_spec("availability=0.9"), col2,
                       fast_s=10, slow_s=10, fast_burn=1, slow_burn=1,
                       min_requests=5, clock=lambda: clock["now"])
    for i in range(3):
        col2.records.append(_rec(1199.0, status="rejected"))
    assert not ev2.evaluate()[0]["firing"]


def test_burn_windows_and_judging_equal_the_reference():
    """Both packages' evaluators over the same request groups under one
    fake clock: every pass's burn rates, counts and firing states,
    every annotation and every flight-dump call are equal, and so are
    ``Objective.judge`` verdicts on each group."""
    _rec = _rec_factory()
    clock = {"now": 1000.0}
    spec = "ttft_p99_ms=100;availability=0.95;total_p90_ms=50"
    cols = {m: _FakeCollector(lambda: clock["now"])
            for m in ("ref", "port")}
    evs = {}
    for tag, mod in (("ref", ref_slo), ("port", port_slo)):
        cols[tag].urls.update({"bad-rep": "http://x", "r0": "http://r0"})
        evs[tag] = mod.SLOEvaluator(
            mod.parse_slo_spec(spec), cols[tag], fast_s=10.0,
            slow_s=100.0, fast_burn=5.0, slow_burn=2.0, min_requests=5,
            dump_interval_s=30.0, clock=lambda: clock["now"])
    rng = np.random.RandomState(12)
    stages = [(1000.0, 300, 0.0), (1005.0, 12, 0.6), (1080.0, 20, 0.9),
              (1090.0, 5, 0.0), (1200.0, 15, 0.1)]
    outs = {"ref": [], "port": []}
    for now, n, bad_share in stages:
        clock["now"] = now
        for _ in range(n):
            bad = rng.rand() < bad_share
            rec = _rec(now - 9.5 * rng.rand(),
                       status=("rejected" if bad and rng.rand() < 0.3
                               else "finished"),
                       ttft=0.5 if bad else 0.01,
                       replica="bad-rep" if bad else "r0")
            rec["total_s"] = 0.2 if bad else 0.01
            if rng.rand() < 0.3:         # a router line for the request
                rec2 = dict(rec, source="router", ttft_s=None)
                for c in cols.values():
                    c.records.append(dict(rec2))
            for c in cols.values():
                c.records.append(dict(rec))
        for tag in evs:
            outs[tag].append(evs[tag].evaluate())
    assert outs["port"] == outs["ref"]
    assert any(o["firing"] for stage in outs["port"] for o in stage)
    assert cols["port"].annotations == cols["ref"].annotations
    assert cols["port"].dump_calls == cols["ref"].dump_calls
    assert evs["port"].statusz() == evs["ref"].statusz()
    groups = port_slo.group_requests(cols["port"].records)
    assert len(groups) == len(ref_slo.group_requests(cols["ref"].records))
    for a, b in zip(port_slo.parse_slo_spec(spec),
                    ref_slo.parse_slo_spec(spec)):
        assert [a.judge(g) for g in groups] == [b.judge(g) for g in groups]


# -- the ring and the registry flattener, both packages ----------------------
def test_ring_and_flattener_equal_the_reference():
    """The same samples give both packages' rings the same rates,
    deltas, quantiles and latest values; both registries, fed the same
    updates, flatten to the same dict, and each one's Prometheus text
    parses back to it."""
    clock = {"now": 0.0}
    rng = np.random.RandomState(4)
    rings = {m.__name__: m.TimeSeriesRing(capacity=16,
                                          clock=lambda: clock["now"])
             for m in (ref_ts, timeseries)}
    level = 0.0
    for i in range(24):
        clock["now"] = 0.5 * i
        level = (level + rng.randint(0, 50)) if i != 11 else 3.0  # reset
        sample = {"tok_total": level, "queue": int(rng.randint(0, 7)),
                  "util": float(rng.rand())}
        for r in rings.values():
            r.append(dict(sample))

    def read(r):
        out = [len(r), r.taken, r.span_s(), sorted(r.names())]
        for name in ("tok_total", "queue", "util", "missing"):
            for w in (1.0, 3.0, 100.0):
                out += [r.rate(name, w), r.delta(name, w)]
                out += [r.quantile_over(name, w, q)
                        for q in (0.0, 0.5, 0.9, 1.0)]
            out += [r.latest(name), r.series(name, 4.0)]
        return out

    ref_ring, port_ring = rings["mxnet_tpu.telemetry.timeseries"], \
        rings["mxnet_tpu_torch.telemetry.timeseries"]
    assert read(port_ring) == read(ref_ring)

    flats = {}
    for tag, mod, tmod in (("ref", ref_tel, ref_ts),
                           ("port", telemetry, timeseries)):
        reg = mod.metrics.Registry()
        reg.counter("t_total", "x").inc(7)
        fam = reg.counter("r_total", "x", ("reason",))
        fam.labels(reason="queue_full").inc(2)
        fam.labels(reason="deadline").inc(5)
        reg.gauge("g", "x", ("role",)).labels(role="decode").set(2.5)
        h = reg.histogram("lat_seconds", "x")
        for v in (0.1, 0.2, 0.7, 3.0):
            h.observe(v)
        flat = tmod.flatten_registry(reg)
        parsed = tmod.parse_prometheus_text(mod.to_prometheus_text(reg))
        assert parsed == pytest.approx(flat)
        flats[tag] = flat
    assert flats["port"] == flats["ref"]


# -- collector: scrape, aggregate, isolate ------------------------------------
def test_collector_three_view_agreement(fleet_cleanup, tel):
    """Acceptance gate: fleet /fleetz aggregates == sum of per-replica
    /statusz.json ground truth == the collector's registry series,
    for queue depth, tokens and reject counts."""
    reps = [ReplicaServer(_engine()).start() for _ in range(2)]
    fleet_cleanup.extend(reps)
    router = Router([r.url for r in reps], scrape_interval_s=0,
                    timeout_s=HOP_S)
    fleet_cleanup.append(router)
    router.scrape()
    for i, p in enumerate(_prompts(6, seed=11)):
        router.generate(p.tolist(), max_new_tokens=5,
                        request_id=f"tv-{i}")
    # two engine-level rejections (too long for the model: 400s)
    for r in reps:
        code, body = http_post(r.url, "/generate",
                               {"prompt": [1] * 30, "max_new_tokens": 60})
        assert code == 400 and body["error"] == "exceeds_max_len"

    col = FleetCollector(urls=[r.url for r in reps], interval_s=0)
    fleet_cleanup.append(col)
    assert col.scrape() == {"replicas": 2, "ok": 2, "failed": 0}
    view = col.fleet_view()

    # ground truth: every replica's own statusz
    truth = {"tokens_generated": 0, "completed": 0, "rejected": 0,
             "queue_depth": 0}
    for r in reps:
        sec = http_get(r.url, "/statusz.json")["replica"]
        truth["queue_depth"] += sec["queue_depth"]
        for k in ("tokens_generated", "completed", "rejected"):
            truth[k] += sec["stats"][k]
    assert truth["tokens_generated"] == 30 and truth["rejected"] == 2

    # view 2: the fleet aggregate
    assert view["totals"]["stale"] == 0
    for k, want in truth.items():
        assert view["totals"][k] == want, k
    assert view["roles"]["both"]["tokens_generated"] == \
        truth["tokens_generated"]
    assert view["roles"]["both"]["tenant_goodput"] == {"default": 6}

    # view 3: the collector's registry series
    snap = telemetry.registry().snapshot()
    for field in ("tokens_generated", "rejected", "queue_depth",
                  "completed"):
        fam = snap[f"mxtpu_fleet_agg_{field}"]
        total = sum(s["value"] for s in fam["samples"])
        assert total == truth[field], field


def test_collector_scrape_failure_isolation(fleet_cleanup):
    """A dead replica and a black-holed replica each degrade only
    their OWN series: failures counted, staleness marked, the live
    sibling keeps collecting samples."""
    rep = ReplicaServer(_engine()).start()
    fleet_cleanup.append(rep)
    # a socket that accepts connections but never answers (hung
    # replica) and a closed port (killed replica)
    hung = socket.socket()
    hung.bind(("127.0.0.1", 0))
    hung.listen(1)
    hung_url = f"http://127.0.0.1:{hung.getsockname()[1]}"
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_port = dead.getsockname()[1]
    dead.close()
    try:
        col = FleetCollector(
            urls=[rep.url, hung_url, f"http://127.0.0.1:{dead_port}"],
            interval_s=0, timeout_s=0.5)
        fleet_cleanup.append(col)
        for _ in range(2):
            out = col.scrape()
        assert out == {"replicas": 3, "ok": 1, "failed": 2}
        rows = {r["url"]: r for r in col.fleet_view()["replicas"]}
        live = rows[rep.url.rstrip("/")]
        assert not live["stale"] and live["samples"] == 2
        assert live["total_failures"] == 0
        for url, row in rows.items():
            if url == rep.url.rstrip("/"):
                continue
            assert row["stale"] and row["total_failures"] == 2
            assert row["consecutive_failures"] == 2
        # stale replicas are listed but never summed
        assert col.fleet_view()["totals"]["stale"] == 2
    finally:
        hung.close()


def test_collector_stale_replica_ages_out_of_totals(fleet_cleanup):
    """A replica that stops answering keeps its last values OUT of the
    fleet totals once stale (fake clock drives staleness)."""
    clock = {"now": 0.0}
    rep = ReplicaServer(_engine()).start()
    fleet_cleanup.append(rep)
    col = FleetCollector(urls=[rep.url], interval_s=0, stale_after=3.0,
                         clock=lambda: clock["now"])
    fleet_cleanup.append(col)
    col.scrape()
    assert col.fleet_view()["totals"]["replicas"] == 1
    assert col.fleet_view()["totals"]["stale"] == 0
    clock["now"] = 10.0          # > stale_after * max(interval, 1)
    view = col.fleet_view()
    assert view["totals"]["stale"] == 1
    assert view["replicas"][0]["stale"] is True


def test_collector_stale_row_drops_load_signals(fleet_cleanup):
    """Past the staleness age cap a replica's row carries identity and
    failure fields only, never its last-scraped load signals."""
    rep = ReplicaServer(_engine(), replica_id="r0", version="v1").start()
    fleet_cleanup.append(rep)
    clock = {"now": 0.0}
    col = FleetCollector(urls=[rep.url], interval_s=0, stale_after=3.0,
                         clock=lambda: clock["now"])
    fleet_cleanup.append(col)
    col.scrape()
    view = col.fleet_view()
    row = view["replicas"][0]
    assert not row["stale"]
    assert "queue_depth" in row and "kv_utilization" in row
    assert row["version"] == "v1"
    assert view["roles"]["both"]["versions"] == {"v1": 1}
    clock["now"] = 10.0              # > stale_after * max(interval, 1)
    view = col.fleet_view()
    row = view["replicas"][0]
    assert row["stale"]
    for f in ("queue_depth", "running", "in_flight", "kv_utilization",
              "tok_per_sec", "tokens_generated", "ttft_ms_p99"):
        assert f not in row, f
    assert row["replica"] == "r0" and row["version"] == "v1"
    assert row["scrapes"] == 1
    agg = view["roles"]["both"]
    assert agg["stale"] == 1 and agg["versions"] == {}


def test_collector_role_mfu_goodput_aggregates():
    """Role aggregates: MFU averages over fresh replicas, achieved
    TFLOP/s sums; replicas without a perf section are skipped, not
    zero-counted; ``fleet_report`` renders both columns."""
    sys.path.insert(0, os.path.join(fx.REPO, "tools"))
    import fleet_report

    col = FleetCollector(urls=["http://a:1", "http://b:1",
                               "http://c:1"], interval_s=0)
    try:
        perfs = [{"sampled": 5, "mfu": 0.2, "achieved_tflops": 1.0,
                  "tok_flops": 2e6, "cost_per_1k_tokens_s": 0.1},
                 {"sampled": 9, "mfu": 0.4, "achieved_tflops": 3.0,
                  "tok_flops": 2e6, "cost_per_1k_tokens_s": 0.3},
                 None]
        for view, perf in zip(col.views(), perfs):
            sec = {"replica": view.url, "role": "decode",
                   "state": "serving", "queue_depth": 0, "running": 0,
                   "stats": {"tokens_generated": 10, "completed": 1,
                             "rejected": 0},
                   "perf": perf}
            view.ring.append(FleetCollector._flatten_replica(sec),
                             now=col.clock())
            view.role = "decode"
            view.last_success_t = col.clock()
        view = col.fleet_view()
        agg = view["roles"]["decode"]
        assert agg["mfu_mean"] == pytest.approx(0.3)
        assert agg["achieved_tflops"] == pytest.approx(4.0)
        rows = {r["url"]: r for r in view["replicas"]}
        assert rows["http://a:1"]["perf_mfu"] == pytest.approx(0.2)
        assert rows["http://b:1"]["perf_sampled"] == 9
        assert "perf_mfu" not in rows["http://c:1"]
        text = fleet_report.render(view)
        assert "MFU%" in text and "TFLOPS" in text
        role_line = [ln for ln in text.splitlines()
                     if ln.startswith("decode")][0]
        assert "30.0" in role_line and "4.00" in role_line
    finally:
        col.stop()


# -- trace push + live stitching ---------------------------------------------
def test_trace_push_and_live_cross_stitch(fleet_cleanup, monkeypatch,
                                          tmp_path):
    col = FleetCollector(urls=[], interval_s=0, port=0)
    fleet_cleanup.append(col)
    col.start()
    monkeypatch.setenv("MXTPU_REQUEST_TRACE",
                       str(tmp_path / "trace.jsonl"))
    monkeypatch.setenv("MXTPU_TRACE_PUSH_URL", col.url + "/trace")
    rep = ReplicaServer(_engine()).start()
    fleet_cleanup.append(rep)
    col.add_replica(rep.url)
    router = Router([rep.url], scrape_interval_s=0, timeout_s=HOP_S)
    fleet_cleanup.append(router)
    router.scrape()
    res = router.generate([1, 2, 3, 4, 5], max_new_tokens=4,
                          request_id="push-1")
    # both lines (engine + router) ship asynchronously
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        recs = col.trace_records()
        if len(recs) >= 2:
            break
        time.sleep(0.05)
    recs = col.trace_records()
    assert len(recs) == 2
    by_replica = {r["replica"] for r in recs}
    # the engine line carries the replica id; the router line
    # attributes its terminal to the SERVING replica too
    assert by_replica == {rep.replica_id}
    # live stitch: one trace id across both lines
    assert {r["trace_id"] for r in recs} == {res.trace_id}
    engine_line = [r for r in recs if r["ttft_s"] is not None]
    assert len(engine_line) == 1          # router lines have no ttft
    assert engine_line[0]["status"] == "finished"
    view = col.fleet_view()
    assert view["traces"]["received"] == 2
    assert view["traces"]["window_availability"] == 1.0
    # the local JSONL file still got both lines (push is additive)
    lines = [json.loads(ln) for ln in
             (tmp_path / "trace.jsonl").read_text().splitlines()]
    assert {ln["replica"] for ln in lines} == {rep.replica_id, "router"}
    router_line = [ln for ln in lines if ln["replica"] == "router"][0]
    evs = [e["ev"] for e in router_line["events"]]
    assert "pick" in evs and "hop" in evs and evs[-1] == "finished"
    # the HTML and JSON pages serve the scraped view
    col.scrape()
    with urllib.request.urlopen(col.url + "/fleetz", timeout=10) as resp:
        assert "text/html" in resp.headers["Content-Type"]
        assert rep.replica_id in resp.read().decode()
    assert http_get(col.url, "/fleetz.json")["traces"]["received"] == 2


# -- the burn-alert E2E under chaos ------------------------------------------
def test_burn_alert_fires_under_kill_delay_chaos(fleet_cleanup,
                                                 monkeypatch, tmp_path):
    """Acceptance gate: delay+kill chaos on one replica pushes the
    total-latency objective's burn over BOTH windows -> the alert
    fires, annotates the timeline, and the flight dump lands via the
    offender's /flight_dump; the clean evaluator stays silent."""
    monkeypatch.setenv("MXTPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("MXTPU_PROFILEZ_DIR", str(tmp_path / "caps"))
    col = FleetCollector(urls=[], interval_s=0, port=0)
    fleet_cleanup.append(col)
    col.start()
    monkeypatch.setenv("MXTPU_TRACE_PUSH_URL", col.url + "/trace")
    slow = ReplicaServer(
        _engine(), replica_id="slow-replica",
        fault_injector=FaultInjector(
            ";".join(f"delay@{k}:0.4" for k in range(1, 7))))
    dying = ReplicaServer(_engine(), replica_id="dying-replica",
                          fault_injector=FaultInjector("kill@2"))
    good = ReplicaServer(_engine(), replica_id="good-replica")
    for r in (slow, dying, good):
        fleet_cleanup.append(r.start())
        col.add_replica(r.url)
    router = Router([slow.url, dying.url, good.url],
                    scrape_interval_s=0, retries=6, breaker_fails=20,
                    backoff_s=0.01, backoff_max_s=0.05, timeout_s=HOP_S)
    fleet_cleanup.append(router)
    router.scrape()
    ev = SLOEvaluator(parse_slo_spec("total_p90_ms=150"), col,
                      fast_s=120.0, slow_s=240.0, fast_burn=2.0,
                      slow_burn=1.0, min_requests=5,
                      dump_interval_s=0.0)
    col.slo = ev
    clean = SLOEvaluator(parse_slo_spec("total_p90_ms=60000;"
                                        "availability=0.5"), col,
                         fast_s=120.0, slow_s=240.0, fast_burn=2.0,
                         slow_burn=1.0, min_requests=5)
    # sequential load round-robins across the three replicas: the slow
    # one delays every arrival 400ms, the dying one is hard-killed
    # mid-stream on its second — every request still completes
    for i, p in enumerate(_prompts(12, seed=23)):
        res = router.generate(p.tolist(), max_new_tokens=4,
                              request_id=f"chaos-{i}")
        assert res.tokens                   # chaos stays client-invisible
        router.scrape()                     # track the kill
        col.scrape()                        # scrape + evaluate as live
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline \
            and len(col.trace_records()) < 20:
        time.sleep(0.05)
    col.scrape()                            # final evaluate
    state = ev.statusz()["objectives"][0]
    assert state["firing"], ev.statusz()
    assert any(a["kind"] == "slo_alert" and a["state"] == "firing"
               for a in col.annotations())
    # the flight dump landed on disk via the offender's /flight_dump
    # (the in-process recorder is shared, so exactly one file exists —
    # the per-reason rate limit suppressed later offenders)
    dumps = list((tmp_path / "flight").glob(
        "flight-*slo_burn_total_p90_ms*.json"))
    assert dumps, list((tmp_path / "flight").glob("*"))
    payload = json.loads(dumps[0].read_text())
    assert payload["reason"].startswith("slo_burn_total_p90_ms")
    assert payload["extra"]["requested_by"] == "fleet"
    # offender attribution: the worst offender is the delaying replica
    assert payload["extra"]["replica"] == "slow-replica"
    # the killed replica only degraded its OWN series
    rows = {r["replica"]: r for r in col.fleet_view()["replicas"]}
    assert rows["good-replica"]["total_failures"] == 0
    assert rows["slow-replica"]["total_failures"] == 0
    assert rows["dying-replica"]["total_failures"] >= 1
    assert rows["dying-replica"]["stale"] or \
        rows["dying-replica"]["consecutive_failures"] >= 1
    # and the same records leave a lenient evaluator silent
    assert not any(o["firing"] for o in clean.evaluate())
    assert clean.statusz()["objectives"][0]["fired_total"] == 0


# -- satellite: router hop instrumentation ------------------------------------
def test_router_hop_histogram_and_breaker_gauge(fleet_cleanup, tel):
    rep = ReplicaServer(_engine()).start()
    fleet_cleanup.append(rep)
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_port = dead.getsockname()[1]
    dead.close()
    router = Router([f"http://127.0.0.1:{dead_port}", rep.url],
                    scrape_interval_s=0, retries=4, backoff_s=0.01,
                    backoff_max_s=0.02, timeout_s=5)
    fleet_cleanup.append(router)
    res = router.generate([1, 2, 3], max_new_tokens=3,
                          request_id="hop-1")
    assert res.tokens
    snap = telemetry.registry().snapshot()
    fam = snap["mxtpu_fleet_router_hop_seconds"]
    by_outcome = {s["labels"]["outcome"]: s["count"]
                  for s in fam["samples"]}
    assert by_outcome.get("ok", 0) >= 1         # the serving hop
    assert by_outcome.get("retry", 0) >= 1      # the dead-replica hop
    gauge = snap["mxtpu_fleet_breaker_state"]
    states = {s["labels"]["replica"]: s["value"]
              for s in gauge["samples"]}
    # never-scraped routers label by URL; closed after the success
    assert states[rep.url] == 0.0


def test_router_trace_inert_without_env(fleet_cleanup):
    rep = ReplicaServer(_engine()).start()
    fleet_cleanup.append(rep)
    router = Router([rep.url], scrape_interval_s=0, timeout_s=HOP_S)
    fleet_cleanup.append(router)
    assert not router._trace.enabled
    assert router._trace_begin(4, 4, None, "tid") is None
    res = router.generate([1, 2, 3], max_new_tokens=3)
    assert res.tokens
    # engine tracer grew no pusher either (MXTPU_TRACE_PUSH_URL unset)
    assert rep.engine._rtrace._pusher is None


# -- satellite: supervisor lifecycle events -----------------------------------
def test_supervisor_lifecycle_annotations_and_reasons(fleet_cleanup, tel):
    col = FleetCollector(urls=[], interval_s=0)
    fleet_cleanup.append(col)
    spawned = []

    def spawn(slot):
        rep = ReplicaServer(_engine(),
                            replica_id=f"s{slot}-{len(spawned)}").start()
        fleet_cleanup.append(rep)
        spawned.append(rep)
        return InProcHandle(rep)

    sup = Supervisor(spawn, 1, restart_backoff_s=0.0, collector=col,
                     drain_timeout_s=10)
    sup.start()
    spawned[-1].hard_stop()                     # crash
    assert sup.check() == [0]
    sup.drain_and_restart(0)                    # rolling
    sup.stop()
    kinds = [a["kind"] for a in col.annotations()]
    assert "replica_crash_restart" in kinds
    assert "replica_respawn" in kinds
    assert kinds.count("rolling_restart_slot") >= 3   # 3 phases
    phases = [a["phase"] for a in col.annotations()
              if a["kind"] == "rolling_restart_slot"]
    assert phases == ["drain", "terminate", "respawned"]
    snap = telemetry.registry().snapshot()
    reasons = {s["labels"]["reason"]: s["value"]
               for s in snap["mxtpu_fleet_restarts_total"]["samples"]}
    assert reasons == {"crash": 1, "rolling": 1}


# -- replica endpoints --------------------------------------------------------
def test_replica_metrics_endpoint(fleet_cleanup, tel):
    rep = ReplicaServer(_engine()).start()
    fleet_cleanup.append(rep)
    code, _ = http_post(rep.url, "/generate",
                        {"prompt": [5, 6, 7], "max_new_tokens": 4})
    assert code == 200
    with urllib.request.urlopen(rep.url + "/metrics",
                                timeout=10) as resp:
        assert "version=0.0.4" in resp.headers["Content-Type"]
        text = resp.read().decode()
    parsed = timeseries.parse_prometheus_text(text)
    assert parsed.get("mxtpu_serve_tokens_generated_total", 0) >= 4


def test_replica_flight_dump_route_rate_limited(fleet_cleanup,
                                                monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_FLIGHT_DIR", str(tmp_path))
    rep = ReplicaServer(_engine()).start()
    fleet_cleanup.append(rep)
    code, body = http_post(rep.url, "/flight_dump", {"reason": "op_asked"})
    assert code == 200 and body["path"]
    assert os.path.exists(body["path"])
    assert "op_asked" in body["path"]
    # second request within the recorder's per-reason window: suppressed
    code, body2 = http_post(rep.url, "/flight_dump",
                            {"reason": "op_asked"})
    assert code == 200 and body2["path"] is None


# -- fleet_report rendering ---------------------------------------------------
def test_fleet_report_renders_live_view(fleet_cleanup):
    sys.path.insert(0, os.path.join(fx.REPO, "tools"))
    from fleet_report import render

    rep = ReplicaServer(_engine()).start()
    fleet_cleanup.append(rep)
    http_post(rep.url, "/generate", {"prompt": [1, 2, 3],
                                     "max_new_tokens": 3})
    col = FleetCollector(urls=[rep.url], interval_s=0,
                         slo_spec="availability=0.99")
    fleet_cleanup.append(col)
    col.scrape()
    col.annotate("rolling_restart", phase="start", slots=1)
    text = render(col.fleet_view())
    assert "both" in text and rep.replica_id in text
    # the availability objective renders, state ok (only the column
    # header mentions FIRING)
    assert "availability" in text and text.count("FIRING") == 1
    assert "rolling_restart" in text
    # the whole view survives a JSON round trip (the --file mode)
    json.loads(json.dumps(col.fleet_view(), default=str))


# -- env knob documentation pin ----------------------------------------------
def test_obs_env_knobs_documented():
    doc = open(os.path.join(fx.REPO, "docs", "env_vars.md")).read()
    for var in ("MXTPU_TIMESERIES", "MXTPU_TIMESERIES_INTERVAL",
                "MXTPU_TRACE_PUSH_URL", "MXTPU_FLEET_COLLECT_INTERVAL",
                "MXTPU_FLEET_COLLECT_PORT", "MXTPU_SLO_SPEC",
                "MXTPU_SLO_FAST_WINDOW", "MXTPU_SLO_SLOW_WINDOW",
                "MXTPU_SLO_FAST_BURN", "MXTPU_SLO_SLOW_BURN",
                "MXTPU_SLO_MIN_REQUESTS", "MXTPU_PROFILEZ_ON_BURN",
                "MXTPU_PROFILEZ_BURN_S"):
        assert var in doc, var
    src = ""
    for rel in ("fleet/collector.py", "fleet/slo.py",
                "telemetry/timeseries.py", "monitor.py"):
        with open(os.path.join(fx.REPO, "mxnet_tpu_torch", rel)) as f:
            src += f.read()
    for var in set(re.findall(r'"(MXTPU_[A-Z0-9_]+)"', src)):
        assert var in doc, var


# -- ServeMonitor: the reference's line --------------------------------------
def _monitor_line(mod, eng, logger_name):
    logger = logging.getLogger(logger_name)
    records = []

    class _Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    h = _Keep(level=logging.INFO)
    logger.addHandler(h)
    old = logger.level
    logger.setLevel(logging.INFO)
    try:
        mod.monitor.ServeMonitor(eng, interval=1, logger=logger).log_now()
    finally:
        logger.removeHandler(h)
        logger.setLevel(old)
    return records[-1]


def _timeless(line):
    # wall-clock latency fields honestly differ run to run; the line's
    # identity is about its format and counts, not the timings
    return re.sub(r"(ttft_ms|tok/s)=[0-9.]+", r"\1=X", line)


def test_serve_monitor_line_equals_the_reference():
    """A port engine and a reference engine fed the same checkpoint and
    prompts (greedy) log the same ``ServeMonitor`` line, timings aside:
    steps, queue, running, done, rejections with their reasons,
    preemptions, blocks and utilization."""
    prompts = _prompts(5, seed=17)
    lines = {}
    for tag, mod, eng in (("ref", mx, fx.ref_fleet_engine()),
                          ("port", mt, _engine())):
        reqs = [eng.submit(p, max_new_tokens=7) for p in prompts]
        try:
            eng.submit(np.arange(30, dtype=np.int32), max_new_tokens=60)
        except Exception:               # either package may raise here
            pass
        eng.run()
        assert all(r.status == "finished" for r in reqs)
        lines[tag] = _monitor_line(mod, eng, f"fleet_obs_monitor_{tag}")
        eng.shutdown()
    assert lines["port"].startswith("Serve: step ")
    assert "ttft_ms=" in lines["port"] and "mfu=" not in lines["port"]
    assert _timeless(lines["port"]) == _timeless(lines["ref"])


def test_serve_monitor_logs_rejection_reasons():
    """The same fake engine's stats give both packages' monitors the
    same lines, reasons bracket included."""
    def fake(mod_stats, **overrides):
        base = dict(steps=5, queue_depth=3, running=2, completed=3,
                    rejected=0, preemptions=0, evictions=0,
                    tokens_generated=10, prompt_tokens=12,
                    blocks_in_use=4, blocks_total=8,
                    block_utilization=0.5, peak_block_utilization=0.5,
                    ttft_ms_mean=None, ttft_ms_max=None,
                    decode_tok_per_sec=None, total_tok_per_sec=None)
        base.update(overrides)
        stats = mod_stats(**base)

        class _FakeEngine:
            def stats(self):
                return stats

        return _FakeEngine()

    from mxnet_tpu.serve.stats import ServeStats as RefServeStats

    lines = {}
    for tag, mod, st in (("ref", mx, RefServeStats),
                         ("port", mt, ServeStats)):
        lines[tag] = [
            _monitor_line(mod, fake(st), f"fleet_obs_reasons_{tag}"),
            _monitor_line(mod, fake(st, rejected=3, reject_reasons={
                "queue_full": 1, "deadline": 2}, ttft_ms_mean=12.34,
                decode_tok_per_sec=456.78),
                f"fleet_obs_reasons_{tag}")]
    first, second = lines["port"]
    assert "queue=3" in first and "rej=0[-]" in first
    assert "ttft_ms=- tok/s=-" in first
    assert "rej=3[deadline=2,queue_full=1]" in second
    assert "ttft_ms=12.3 tok/s=456.8" in second
    assert lines["port"] == lines["ref"]


def test_monitor_perf_tail_only_after_sample(monkeypatch):
    """The ``mfu=``/``tok_flops=`` tail appears only once a sampled
    timing exists; the attribution switched off logs the plain line."""
    prompts = _prompts(4, seed=3)

    def served(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        eng = _engine()
        for p in prompts:
            eng.submit(p, max_new_tokens=5)
        eng.run()
        line = _monitor_line(mt, eng, "fleet_obs_perf")
        eng.shutdown()
        for k in env:
            monkeypatch.delenv(k)
        return line

    plain = served()
    assert "mfu=" not in plain
    killed = served(**{perf_attrib.ENV_ENABLE: "0"})
    assert _timeless(killed) == _timeless(plain)
    sampled = served(**{perf_attrib.ENV_SAMPLE: "1"})
    assert "mfu=" in sampled and "tok_flops=" in sampled
    assert _timeless(sampled).startswith(_timeless(plain))


def test_training_monitor_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 15"):
        mt.monitor.Monitor
    with pytest.raises(AttributeError):
        mt.monitor.NoSuchThing
