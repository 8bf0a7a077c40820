"""The PyTorch port's telemetry package (``mxnet_tpu_torch/telemetry``,
``profiler.py``, ``flops.py``) against the JAX reference's.

The engine-free cases of ``tests/test_telemetry.py``,
``tests/test_observability.py`` and ``tests/test_profiling.py`` run on
both packages as cases of one parametrised test each: metric semantics
and registry consistency, the Prometheus golden text and its label
escaping, Chrome-trace nesting, ``traced`` and the event cap, the span
ring and virtual tracks, the flight ring's bound, its atomic dump and
its rate limit, ``/statusz`` provider isolation and ``/healthz``, the
step profiler's phase sum and env knobs, the time-series ring.  The two
packages' Prometheus texts are held equal byte for byte for one update
sequence, and their closed-form flop counts equal.  Port-only: the
profiler on ``torch.profiler`` (double start, reset on error, summary
of a CPU capture), ``bytes_by_device`` and the torch inventory, the
kernel-build and capture counters (``cudamon``), the trainer's step
metrics, and the ``MXTPU_TELEMETRY`` gate in a fresh process.

Every test starts and ends with both packages disabled, their
registries, tracers and flight rings empty.
"""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx

import mxnet_tpu.flops as ref_flops
import mxnet_tpu.telemetry as ref_tel
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.flops as port_flops
import mxnet_tpu_torch.telemetry as port_tel
from mxnet_tpu.telemetry import profiling as ref_profiling
from mxnet_tpu.telemetry import timeseries as ref_ts
from mxnet_tpu_torch import profiler as port_profiler
from mxnet_tpu_torch.telemetry import cudamon
from mxnet_tpu_torch.telemetry import profiling as port_profiling
from mxnet_tpu_torch.telemetry import statusz as port_statusz
from mxnet_tpu_torch.telemetry import timeseries as port_ts

REPO = fx.REPO
sys.path.insert(0, os.path.join(REPO, "tools"))

PKGS = {"ref": ref_tel, "port": port_tel}
PROFILING = {"ref": ref_profiling, "port": port_profiling}
TIMESERIES = {"ref": ref_ts, "port": port_ts}
BOTH = pytest.mark.parametrize("pkg", sorted(PKGS))


def _clean():
    for t in PKGS.values():
        t.disable()
        t.reset()
        t.flight.recorder().clear()


@pytest.fixture(autouse=True)
def clean_state():
    _clean()
    yield
    _clean()


@pytest.fixture
def tel(pkg):
    t = PKGS[pkg]
    t.enable()
    return t


# -- registry semantics -------------------------------------------------------
@BOTH
def test_counter_labels_and_increments(pkg):
    c = PKGS[pkg].Registry().counter("req_total", "requests", ("route",))
    c.labels(route="/a").inc()
    c.labels(route="/a").inc(3)
    c.labels("/b").inc()
    assert c.labels(route="/a").value == 4
    assert c.labels(route="/b").value == 1
    with pytest.raises(ValueError):
        c.labels(route="/a").inc(-1)
    with pytest.raises(ValueError):
        c.labels(wrong="x")
    with pytest.raises(ValueError):
        c.inc()


@BOTH
def test_gauge_set_inc_dec(pkg):
    g = PKGS[pkg].Registry().gauge("depth")
    g.set(7)
    g.inc(2)
    g.dec()
    assert g.labels().value == 8


@BOTH
def test_histogram_bucket_semantics(pkg):
    r = PKGS[pkg].Registry()
    h = r.histogram("lat", "latency", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    child = h.labels()
    assert child.count == 4
    assert child.sum == pytest.approx(55.55)
    assert child.cumulative() == [(0.1, 1), (1.0, 2), (10.0, 3),
                                  (float("inf"), 4)]
    h2 = r.histogram("lat2", buckets=(1.0, 2.0))
    h2.observe(1.0)
    assert h2.labels().cumulative()[0] == (1.0, 1)


@BOTH
def test_registry_consistency_enforced(pkg):
    r = PKGS[pkg].Registry()
    c = r.counter("x_total", "x", ("a",))
    assert r.counter("x_total", "x", ("a",)) is c
    with pytest.raises(ValueError):
        r.gauge("x_total")
    with pytest.raises(ValueError):
        r.counter("x_total", label_names=("b",))
    h = r.histogram("h_seconds", buckets=(1.0, 5.0))
    assert r.histogram("h_seconds", buckets=(1.0, 5.0)) is h
    with pytest.raises(ValueError):
        r.histogram("h_seconds", buckets=(0.1, 1.0))


@BOTH
def test_disabled_returns_noop_objects(pkg):
    t = PKGS[pkg]
    assert not t.enabled()
    assert t.counter("anything_total") is t.NOOP
    assert t.gauge("anything") is t.NOOP
    assert t.histogram("anything_seconds") is t.NOOP
    assert t.span("anything") is t.NOOP_SPAN
    t.NOOP.labels(a=1).inc()
    t.NOOP.observe(3.0)
    with t.span("x"):
        pass
    assert t.registry().snapshot() == {}
    assert t.tracer().trace_events() == [
        {"name": "process_name", "ph": "M",
         "pid": os.getpid(), "args": {"name": "mxtpu host"}}]


# -- tracer -------------------------------------------------------------------
@BOTH
def test_chrome_trace_json_valid_and_nested(tel, tmp_path):
    with tel.span("outer", step=1):
        with tel.span("inner"):
            pass
    path = tel.tracer().write(str(tmp_path / "trace.json"))
    with open(path) as f:
        payload = json.load(f)
    events = payload["traceEvents"]
    xs = {e["name"]: e for e in events if e["ph"] == "X"}
    assert set(xs) == {"outer", "inner"}
    for e in xs.values():
        assert e["pid"] == os.getpid()
        assert isinstance(e["tid"], int)
        assert e["ts"] >= 0 and e["dur"] >= 0
    outer, inner = xs["outer"], xs["inner"]
    assert outer["ts"] <= inner["ts"]
    assert outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"]
    assert outer["args"] == {"step": 1}
    metas = {e["name"] for e in events if e["ph"] == "M"}
    assert {"process_name", "thread_name"} <= metas
    assert "t0_epoch" in payload["otherData"]


@BOTH
def test_traced_decorator(tel):
    @tel.traced("work")
    def fn(x):
        return x + 1

    assert fn(1) == 2
    names = [e["name"] for e in tel.tracer().trace_events()
             if e["ph"] == "X"]
    assert names == ["work"]


@BOTH
def test_tracer_event_cap_keeps_newest(pkg):
    tr = PKGS[pkg].SpanTracer(max_events=3)
    for i in range(7):
        tr.add_complete(f"e{i}", 0.0, 1.0)
    kept = [e["name"] for e in tr.trace_events() if e["ph"] == "X"]
    assert kept == ["e4", "e5", "e6"]
    assert tr.dropped == 4


@BOTH
def test_span_tracer_virtual_tracks(pkg):
    tr = PKGS[pkg].SpanTracer(max_events=10)
    tr.set_track_name(10_001, "serve-req-slot-1")
    tr.add_complete("decode", 0.0, 1.0, args={"rid": 3}, tid=10_001,
                    cat="request")
    events = tr.trace_events()
    x = [e for e in events if e["ph"] == "X"][0]
    assert x["tid"] == 10_001 and x["cat"] == "request"
    names = {e["tid"]: e["args"]["name"] for e in events
             if e["name"] == "thread_name"}
    assert names[10_001] == "serve-req-slot-1"


def test_span_annotates_an_active_torch_profiler_capture(tmp_path):
    """While a port profiler capture runs, a span enters a
    ``record_function`` of its name (it shows in the device trace);
    with none running it enters nothing."""
    port_tel.enable()
    with port_tel.span("outside"):
        pass
    assert port_tel.tracer().ann_errors == 0
    with port_profiler.trace(str(tmp_path)):
        with port_tel.span("serve.step"):
            torch.ones(4).add_(1)
    with pytest.warns(UserWarning, match="no device events"):
        names = {n for n, _, _ in port_profiler.summarize(
            str(tmp_path), top=100)}
    assert "serve.step" in names and "outside" not in names
    assert port_tel.tracer().ann_errors == 0


# -- exporters ----------------------------------------------------------------
GOLDEN = (
    "# TYPE depth gauge\n"
    "depth 6\n"
    "# HELP lat_seconds latency\n"
    "# TYPE lat_seconds histogram\n"
    'lat_seconds_bucket{le="0.1"} 1\n'
    'lat_seconds_bucket{le="1"} 2\n'
    'lat_seconds_bucket{le="+Inf"} 3\n'
    "lat_seconds_sum 5.55\n"
    "lat_seconds_count 3\n"
    "# HELP req_total requests served\n"
    "# TYPE req_total counter\n"
    'req_total{route="/a"} 4\n')


@BOTH
def test_prometheus_exposition_golden(pkg):
    t = PKGS[pkg]
    r = t.Registry()
    r.counter("req_total", "requests served", ("route",)).labels(
        route="/a").inc(4)
    r.gauge("depth").set(6)
    h = r.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    assert t.to_prometheus_text(r) == GOLDEN


@BOTH
def test_prometheus_label_escape_roundtrip(pkg):
    import metrics_report

    t = PKGS[pkg]
    r = t.Registry()
    nasty = 'dir\\name "q"\nline2'
    r.counter("esc_total", "", ("path",)).labels(path=nasty).inc()
    parsed = metrics_report.parse_prometheus_text(t.to_prometheus_text(r))
    assert parsed["esc_total"]["samples"][0]["labels"]["path"] == nasty


def _update_sequence(t):
    """One sequence of updates covering every kind, labels in and out of
    order, escapes, float and integer values, wide histograms."""
    r = t.Registry()
    c = r.counter("mxtpu_x_total", "x things", ("kind", "bucket"))
    for kind, bucket, n in (("decode", 8, 3), ("decode", 16, 1),
                            ("prefill", 2, 0.5), ("decode", 8, 2)):
        c.labels(kind=kind, bucket=bucket).inc(n)
    r.counter("plain_total").inc(1e16)
    g = r.gauge("util", "a \"quoted\" help", ("dev",))
    g.labels(dev='a"b\\c\nd').set(0.1 + 0.2)
    g.labels(dev="z").set(-3)
    g.labels(dev="z").dec(0.25)
    h = r.histogram("prog_seconds", "", ("kind",),
                    buckets=(1e-5, 2.5e-4, 0.5, 2.5))
    for i, v in enumerate((6.5e-05, 3e-4, 0.7, 1e-6, 9.0, 0.5)):
        h.labels(kind=("decode", "verify")[i % 2]).observe(v)
    r.histogram("empty_seconds", "none yet")
    return r


def test_prometheus_text_equal_across_packages():
    """The port's text exposition is the reference's, byte for byte, and
    so is its registry snapshot, for the same update sequence."""
    ref = _update_sequence(ref_tel)
    port = _update_sequence(port_tel)
    text = port_tel.to_prometheus_text(port)
    assert text == ref_tel.to_prometheus_text(ref)
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())
    # and the time-series helpers read it the same way
    assert (port_ts.parse_prometheus_text(text)
            == ref_ts.parse_prometheus_text(text))
    assert port_ts.flatten_registry(port) == ref_ts.flatten_registry(ref)


@BOTH
def test_dump_and_http_endpoint(tel, tmp_path):
    tel.counter("x_total", "x").inc()
    with tel.span("s"):
        pass
    paths = tel.dump(str(tmp_path / "out"))
    with open(paths["prometheus"]) as f:
        assert "x_total 1" in f.read()
    with open(paths["jsonl"]) as f:
        line = json.loads(f.read())
    assert line["metrics"]["x_total"]["samples"][0]["value"] == 1
    with open(paths["trace"]) as f:
        json.load(f)
    server = tel.serve_http(tel.registry(), 0)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        body = urllib.request.urlopen(f"{url}/metrics",
                                      timeout=10).read().decode()
        assert "x_total 1" in body
        js = json.loads(urllib.request.urlopen(f"{url}/metrics.json",
                                               timeout=10).read())
        assert js["x_total"]["samples"][0]["value"] == 1
        health = json.loads(urllib.request.urlopen(f"{url}/healthz",
                                                   timeout=10).read())
        assert health["status"] == "ok"
        snap = json.loads(urllib.request.urlopen(f"{url}/statusz.json",
                                                 timeout=10).read())
        assert snap["process"]["pid"] == os.getpid()
        html = urllib.request.urlopen(f"{url}/statusz",
                                      timeout=10).read().decode()
        assert "mxtpu /statusz" in html
    finally:
        server.shutdown()


@BOTH
def test_internal_error_moves_a_counter(tel):
    tel._note_internal_error("site_a")
    snap = tel.registry().snapshot()["mxtpu_telemetry_errors_total"]
    assert snap["samples"] == [{"labels": {"site": "site_a"}, "value": 1.0}]


# -- flight recorder ----------------------------------------------------------
@BOTH
def test_flight_ring_bounded(pkg):
    rec = PKGS[pkg].flight.FlightRecorder(max_events=8,
                                          min_dump_interval_s=0)
    for i in range(20):
        rec.record("step", id=i)
    events = rec.events()
    assert len(events) == 8 and rec.seen == 20
    assert [e["id"] for e in events] == list(range(12, 20))


@BOTH
def test_flight_dump_atomic_and_rate_limited(pkg, tmp_path, monkeypatch):
    monkeypatch.delenv("MXTPU_FLIGHT_DIR", raising=False)
    flight = PKGS[pkg].flight
    rec = flight.FlightRecorder(max_events=8, min_dump_interval_s=3600)
    rec.record("error", site="x", t="caller")
    p1 = rec.dump("breach", dir=str(tmp_path))
    p2 = rec.dump("breach", dir=str(tmp_path))
    p3 = rec.dump("breach", dir=str(tmp_path), force=True)
    assert p1 and p2 is None and p3
    with open(p1) as f:
        payload = json.load(f)
    assert payload["reason"] == "breach"
    ev = payload["events"][0]
    assert ev["kind"] == "error" and ev["t"] > 1e9   # schema keys win
    assert "registry" in payload and "statusz" in payload
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    assert flight.FlightRecorder().dump("whatever") is None
    assert flight.dump_now("on_demand", dir=str(tmp_path / "now"))


@BOTH
def test_record_anomaly_counts_and_dumps(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_FLIGHT_DIR", str(tmp_path))
    t = PKGS[pkg]
    p = t.flight.record_anomaly("decode_logits", step=3, batch_size=2)
    assert p and p.endswith("numeric_anomaly.json")
    assert t.flight.record_anomaly("decode_logits", step=4) is None
    snap = t.registry().snapshot()["mxtpu_numeric_anomalies_total"]
    assert snap["samples"] == [{"labels": {"site": "decode_logits"},
                                "value": 2.0}]
    kinds = [e["kind"] for e in t.flight.recorder().events()]
    assert kinds == ["anomaly", "anomaly"]


# -- /statusz -----------------------------------------------------------------
@BOTH
def test_statusz_broken_provider_is_isolated(pkg):
    statusz = PKGS[pkg].statusz

    def broken():
        raise ValueError("provider exploded")

    name = statusz.register("test.broken", broken)
    try:
        snap = statusz.snapshot()
        assert "provider exploded" in snap["test.broken"]["error"]
        assert "process" in snap
    finally:
        statusz.unregister(name)


@BOTH
def test_statusz_weak_provider_and_health(pkg):
    statusz = PKGS[pkg].statusz

    class Obj:
        def statusz(self):
            return {"x": 1}

    obj = Obj()
    name = statusz.register_weak(obj, "test.obj")
    assert statusz.snapshot()[name] == {"x": 1}
    del obj
    assert name not in statusz.snapshot()
    statusz.register_health("test.h", lambda: {"status": "draining"})
    statusz.register_health("test.bad", lambda: 1 / 0)
    try:
        h = statusz.health()
        assert h["status"] == "error"      # sorted: test.bad first
        assert h["checks"]["test.h"] == {"status": "draining"}
    finally:
        statusz.unregister_health("test.h")
        statusz.unregister_health("test.bad")


def test_statusz_torch_section_and_bytes_by_device():
    snap = port_statusz.snapshot()
    assert "jax" not in snap
    assert snap["torch"]["version"] == torch.__version__
    assert snap["torch"]["cuda_runtime"] == torch.version.cuda
    assert snap["torch"]["cuda_initialized"] == torch.cuda.is_initialized()
    buf = torch.zeros(10, dtype=torch.float32)
    views = [buf[:4], buf[4:], buf]                  # one storage
    other = torch.zeros(3, dtype=torch.bfloat16)
    got = port_statusz.bytes_by_device(views + [other, np.zeros(7), None])
    assert got == {"cpu": 40 + 6}


# -- step profiler ------------------------------------------------------------
@BOTH
def test_step_profiler_phases_sum_to_wall(pkg):
    profiling = PROFILING[pkg]
    clock = {"now": 100.0}
    sp = profiling.StepProfiler(clock=lambda: clock["now"], ring=4)
    laps = [("schedule", 0.010), ("prefill_dispatch", 0.002),
            ("device_wait", 0.050), ("host_sync", 0.001),
            ("decode_dispatch", 0.004), ("device_wait", 0.030)]
    for step in range(6):
        sp.begin(step)
        for phase, dt in laps:
            clock["now"] += dt
            sp.lap(phase)
        clock["now"] += 0.003
        sp.commit(emitted=2, prefills=1, decodes=1)
    entries = sp.recent()
    assert [e["step"] for e in entries] == [2, 3, 4, 5]
    for e in entries:
        assert e["wall_s"] == pytest.approx(0.1, abs=1e-12)
        assert sum(e["phases"].values()) == pytest.approx(e["wall_s"],
                                                          rel=1e-12)
        assert e["phases"]["device_wait"] == pytest.approx(0.08)
        assert e["phases"]["callbacks"] == pytest.approx(0.003)
    st = sp.statusz()
    assert st["enabled"] is True and st["steps"] == 6
    assert sum(st["totals_s"].values()) == pytest.approx(st["wall_s"])
    fr = st["fractions"]
    assert set(fr) == set(profiling.PHASES)
    assert sum(fr.values()) == pytest.approx(1.0)
    assert fr["device_wait"] == pytest.approx(0.8)
    assert set(st["clock_anchor"]) == {"perf", "epoch"}
    assert sp.summary()["steps"] == 6


@BOTH
def test_step_profiler_env_knobs(pkg, monkeypatch):
    profiling = PROFILING[pkg]
    monkeypatch.setenv(profiling.ENV_ENABLE, "0")
    noop = profiling.make_step_profiler()
    assert noop is profiling.NOOP_STEP_PROFILER
    noop.begin(1)
    noop.lap("schedule")
    noop.commit()
    assert noop.recent() == [] and noop.summary() is None
    assert noop.statusz() == {"enabled": False}
    monkeypatch.setenv(profiling.ENV_ENABLE, "1")
    monkeypatch.setenv(profiling.ENV_RING, "7")
    live = profiling.make_step_profiler()
    assert live.enabled and live._ring.maxlen == 7


# -- time-series ring ---------------------------------------------------------
@BOTH
def test_timeseries_ring_rates(pkg):
    ts = TIMESERIES[pkg]
    ring = ts.TimeSeriesRing(capacity=8, clock=lambda: 0.0)
    for t, v in ((0.0, 0.0), (1.0, 10.0), (2.0, 30.0), (3.0, 5.0),
                 (4.0, 15.0)):
        ring.append({"c_total": v, "g": v / 10, "s": "x"}, now=t)
    assert ring.delta("c_total", None, now=4.0) == 45.0   # reset-aware
    assert ring.rate("c_total", None, now=4.0) == pytest.approx(11.25)
    assert ring.quantile_over("g", None, 0.5, now=4.0) == 1.0
    assert ring.latest("g") == 1.5 and ring.names() == ["c_total", "g"]
    assert len(ring) == 5 and ring.span_s() == 4.0
    assert ts.nearest_rank([1, 2, 3, 4], 0.9) == 4


# -- profiler on torch.profiler -----------------------------------------------
def test_profiler_double_start_raises(tmp_path):
    """A second start while a capture runs raises ProfilerActive before
    touching torch.profiler; after stop a new capture starts."""
    port_profiler.start(str(tmp_path / "a"))
    try:
        with pytest.raises(port_profiler.ProfilerActive,
                           match="already active"):
            port_profiler.start(str(tmp_path / "b"))
        assert port_profiler.active_logdir() == str(tmp_path / "a")
    finally:
        port_profiler.stop()
    assert not (tmp_path / "b").exists()
    with port_profiler.trace(str(tmp_path / "b")):
        with port_profiler.scope("work"):
            torch.ones(3).mul_(2)
    assert port_profiler.active_logdir() is None
    runs = list((tmp_path / "b" / "plugins" / "profile").iterdir())
    assert len(runs) == 1 and list(runs[0].glob("*.trace.json.gz"))


def test_profiler_stop_resets_state_on_error(monkeypatch):
    monkeypatch.setattr(port_profiler, "_start_capture", lambda d: object())

    def boom(prof, logdir):
        raise RuntimeError("collector failed")

    monkeypatch.setattr(port_profiler, "_stop_capture", boom)
    port_profiler.start("/nonexistent/prof-x")
    with pytest.raises(RuntimeError, match="collector failed"):
        port_profiler.stop()
    assert port_profiler.active_logdir() is None
    with pytest.raises(RuntimeError, match="collector failed"):
        with port_profiler.trace("/nonexistent/prof-y"):
            pass
    assert port_profiler.active_logdir() is None


def test_profiler_start_returns_once_the_card_records(monkeypatch):
    """ROADMAP §C14: CUPTI turns the card's kernel records on some time
    after ``torch.profiler``'s start, and a graph replayed at once lost
    its first kernels from the trace.  ``profiler.start`` returns only
    after the start, a device synchronize and ``START_SETTLE_S``, in that
    order, and not at all before the start."""
    import torch.profiler as tprof

    calls = []

    class FakeProfile:
        def __init__(self, activities):
            pass

        def start(self):
            calls.append("start")

        def stop(self):
            calls.append("stop")

    monkeypatch.setattr(tprof, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append("synchronize"))
    monkeypatch.setattr(port_profiler.time, "sleep",
                        lambda s: calls.append(("sleep", s)))
    port_profiler._start_capture("/nonexistent/prof-settle")
    assert port_profiler.START_SETTLE_S > 0
    assert calls == ["start", "synchronize",
                     ("sleep", port_profiler.START_SETTLE_S)]


def test_profiler_summarize_device_events_and_memory(tmp_path):
    """summarize() sums a trace's kernel events by name (a synthetic
    trace in the capture layout), and device_memory() is empty without
    CUDA."""
    import gzip

    run = tmp_path / "plugins" / "profile" / "r1"
    run.mkdir(parents=True)
    events = [{"ph": "M", "name": "process_name", "pid": 1,
               "args": {"name": "python3"}},
              {"ph": "X", "cat": "kernel", "name": "paged_attention_split",
               "pid": 0, "dur": 12.0},
              {"ph": "X", "cat": "kernel", "name": "paged_attention_split",
               "pid": 0, "dur": 13.0},
              {"ph": "X", "cat": "kernel", "name": "paged_attention_combine",
               "pid": 0, "dur": 3.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
               "dur": 900.0}]
    with gzip.open(run / "h.1.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    assert port_profiler.summarize(str(tmp_path)) == [
        ("paged_attention_split", 0.025, 2),
        ("paged_attention_combine", 0.003, 1)]
    with pytest.raises(FileNotFoundError):
        port_profiler.summarize(str(tmp_path / "none"))
    if not torch.cuda.is_available():
        assert port_profiler.device_memory() == {}


# -- flops --------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(n_layers=2, d_model=32, num_heads=4, head_dim=8, kv_heads=4,
         vocab=53),
    dict(n_layers=4, d_model=768, num_heads=12, head_dim=64, kv_heads=3,
         vocab=50304, d_ff=2048, swiglu=True),
])
def test_flops_closed_forms_equal_reference(kw):
    for ctx in (1, 64, 256):
        assert (port_flops.gpt_token_flops(context=ctx, **kw)
                == ref_flops.gpt_token_flops(context=ctx, **kw))
    for seq, lp in ((1, None), (16, None), (256, 1)):
        assert (port_flops.gpt_prefill_flops(seq_len=seq,
                                             logits_positions=lp, **kw)
                == ref_flops.gpt_prefill_flops(seq_len=seq,
                                               logits_positions=lp, **kw))


def test_peaks_by_card_name(monkeypatch):
    assert port_flops.peak_flops_per_chip("cpu") is None
    assert port_flops.peak_hbm_bytes_per_chip(torch.device("cpu")) is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert port_flops.peak_flops_per_chip("cuda:0") == 989e12
    assert port_flops.peak_hbm_bytes_per_chip("cuda:0") == 3.35e12
    for other in ("NVIDIA A10G", "NVIDIA H100 PCIe"):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None, n=other: n)
        assert port_flops.peak_flops_per_chip("cuda:0") is None
    # count_flops, which raised here until A15b-1, counts a graph: one
    # (2, 3) x (3, 4) FullyConnected is 2 * 2 * 3 * 4 FLOPs
    fc = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4)
    assert port_flops.count_flops(fc, data=(2, 3)) == 48


# -- cudamon: kernel builds and captures --------------------------------------
def test_cudamon_counts_builds_and_captures(monkeypatch, tmp_path):
    """A library found built is a hit; one built is a miss and a put,
    with its nvcc seconds; captures count by kind; nothing is counted
    with telemetry off."""
    from mxnet_tpu_torch import _build

    csrc, out, bin_ = (tmp_path / d for d in ("csrc", "out", "bin"))
    for d in (csrc, out, bin_):
        d.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    nvcc = bin_ / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'while [ $# -gt 0 ]; do [ "$1" = -o ] && touch "$2"; shift; done\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("MXTPU_TORCH_BUILD_DIR", str(out))
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_SECONDS", {})
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    _build.build_library("mxtt_off", ("a.cu",))     # telemetry off
    port_tel.enable()
    _build.build_library("mxtt_fake", ("a.cu",))    # built: miss + put
    _build.build_library("mxtt_fake", ("a.cu",))    # found: hit
    cudamon.note_capture("decode")
    cudamon.note_capture("decode")
    cudamon.note_capture("restore")
    snap = port_tel.registry().snapshot()

    def value(name):
        return [s["value"] for s in snap[name]["samples"]]

    assert value("mxtpu_compile_cache_hits") == [1.0]
    assert value("mxtpu_compile_cache_misses") == [1.0]
    assert value("mxtpu_compile_cache_puts") == [1.0]
    secs = snap["mxtpu_cuda_nvcc_seconds"]["samples"]
    assert [s["labels"] for s in secs] == [{"library": "mxtt_fake"}]
    assert secs[0]["count"] == 1
    caps = {s["labels"]["kind"]: s["value"]
            for s in snap["mxtpu_cuda_graph_captures_total"]["samples"]}
    assert caps == {"decode": 2.0, "restore": 1.0}


# -- trainer ------------------------------------------------------------------
def test_trainer_step_metrics_and_span():
    """ShardedTrainer.step counts steps, observes its host seconds and
    records a trainer.step span, under the reference's names."""
    port_tel.enable()
    tr = fx.port_trainer("gpt2", "sgd")
    batch = fx.train_batch()
    for _ in range(2):
        tr.step(batch)
    snap = port_tel.registry().snapshot()
    assert snap["mxtpu_trainer_steps_total"]["samples"][0]["value"] == 2
    assert snap["mxtpu_trainer_step_seconds"]["samples"][0]["count"] == 2
    assert snap["mxtpu_trainer_step_seconds"]["kind"] == "histogram"
    names = [e["name"] for e in port_tel.tracer().trace_events()
             if e["ph"] == "X"]
    assert names == ["trainer.step", "trainer.step"]


# -- the env gate and the atexit dump, in a fresh process ---------------------
_GATE = r"""
import sys
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry

assert telemetry.enabled()
import numpy as np
tr = mt.parallel.ShardedTrainer(
    mt.models.gpt(11, 4, num_layers=1, d_model=8, num_heads=2),
    {"data": (2, 4), "softmax_label": (2, 4)}, device="cpu",
    input_dtypes={"data": np.int32, "softmax_label": np.int32})
b = {"data": np.ones((2, 4), np.int32), "softmax_label": np.ones((2, 4),
                                                                 np.int32)}
tr.step(b)
bad = sorted(k for k in sys.modules if k in ("jax", "mxnet_tpu")
             or k.startswith(("jax.", "mxnet_tpu.")))
print("BAD=" + ",".join(bad))
"""


def test_telemetry_env_gate_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, MXTPU_TELEMETRY="1",
               MXTPU_TELEMETRY_DIR=str(tmp_path / "tel"))
    r = subprocess.run([sys.executable, "-c", _GATE], env=env, timeout=300,
                       capture_output=True, text=True, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "BAD=\n" in r.stdout
    with open(tmp_path / "tel" / "metrics.prom") as f:
        assert "mxtpu_trainer_steps_total 1" in f.read()
    with open(tmp_path / "tel" / "host_trace.json") as f:
        trace = json.load(f)
    assert any(e["name"] == "trainer.step" for e in trace["traceEvents"])
    with open(tmp_path / "tel" / "metrics.jsonl") as f:
        line = json.loads(f.read())
    assert line["metrics"]["mxtpu_trainer_steps_total"]["samples"][0][
        "value"] == 1


def test_metrics_report_renders_port_artifacts(tmp_path, capsys):
    import metrics_report

    port_tel.enable()
    port_tel.counter("req_total", "requests", ("route",)).labels(
        route="/a").inc(5)
    h = port_tel.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    out = str(tmp_path / "out")
    paths = port_tel.dump(out)
    for target in (out, paths["prometheus"], paths["jsonl"]):
        assert metrics_report.main([target]) == 0
        text = capsys.readouterr().out
        assert "req_total" in text and "route=/a" in text
        assert "lat_seconds" in text and "p99" in text


def test_port_package_surface():
    assert mt.telemetry is port_tel and mt.profiler is port_profiler
    assert mt.flops is port_flops
    assert set(ref_tel.__all__) <= set(port_tel.__all__)
