"""The PyTorch port's on-demand profiler windows against the reference's
cases (``mxnet_tpu_torch/fleet/replica.py`` ``/profilez``,
``fleet/collector.py`` ``capture_fleet``, the SLO burn capture and the
stitched fleet timeline).

Ports the five ``/profilez``, ``capture_fleet``, SLO-capture and
timeline cases of ``tests/test_profiling.py`` on port replicas over
port engines on the CPU.  Where the reference accepts a capture that
ends ``"failed"``, these require ``"done"`` and a trace that holds the
replica's step thread's operators: torch's profiler records the host
operators of the thread that starts it, so the step thread owns every
window.  Added: a window over a replica mid-traffic holds whole steps
(its ``serve.step`` spans equal the steps it counts, and the tokens
are an uncontended engine's), and ``drain`` or ``hard_stop`` during a
window ends it early with its artifact kept.
"""

import gzip
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

import torch_port_fixtures as fx
from torch_port_fixtures import (  # noqa: F401  (autouse / fixtures)
    collect_engines_after_module, fleet_cleanup,
    fresh_telemetry_per_module, http_get, http_post)

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import profiler as profiler_mod
from mxnet_tpu_torch.fleet import (FaultInjector, FleetCollector,
                                   ReplicaServer, Router, SLOEvaluator,
                                   parse_slo_spec)

sys.path.insert(0, os.path.join(fx.REPO, "tools"))


def _engine(**kw):
    return fx.fleet_engine(**kw)


def _wait_capture(url, cap_id, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        meta = http_get(url, f"/profilez/{cap_id}")
        if meta.get("state") in ("done", "failed"):
            return meta
        time.sleep(0.05)
    return meta


def _trace_events(meta):
    with gzip.open(meta["trace_file"]) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X"]


def _assert_step_thread_ops(meta, rep):
    """The capture ended ``done`` and its trace holds operators the
    replica's step thread ran."""
    assert meta["state"] == "done", meta
    assert meta["trace_file"] and os.path.exists(meta["trace_file"])
    tid = rep._step_thread.native_id
    ops = [e for e in _trace_events(meta)
           if e["name"].startswith("aten::") and e.get("tid") == tid]
    assert ops, "no operator of the step thread in the trace"
    return ops


@pytest.fixture
def tel():
    mt.telemetry.reset()
    mt.telemetry.enable()
    yield mt.telemetry.registry()
    mt.telemetry.disable()
    mt.telemetry.reset()


# -- POST /profilez ------------------------------------------------------------
def test_profilez_capture_conflict_and_rate_limit(fleet_cleanup,
                                                  monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_PROFILEZ_DIR", str(tmp_path / "caps"))
    monkeypatch.setenv("MXTPU_PROFILEZ_INTERVAL_S", "30")
    rep = ReplicaServer(_engine()).start()
    fleet_cleanup.append(rep)
    st, cap = http_post(rep.url, "/profilez",
                        {"duration_s": 0.4, "reason": "unit"})
    assert st == 200, cap
    assert cap["state"] == "running" and cap["replica"] == rep.replica_id
    assert cap["started_epoch"] > 0
    # concurrent window -> clean 409, never a RuntimeError->500
    st2, body2 = http_post(rep.url, "/profilez", {"duration_s": 0.2})
    assert st2 == 409 and body2["error"] == "capture_in_progress"
    assert body2["id"] == cap["id"]
    # serving continues during the window
    gst, gen = http_post(rep.url, "/generate",
                         {"prompt": [1, 2, 3, 4], "max_new_tokens": 4})
    assert gst == 200 and gen["tokens"]
    meta = _wait_capture(rep.url, cap["id"])
    _assert_step_thread_ops(meta, rep)
    # the raw artifact serves back over the id
    with urllib.request.urlopen(
            f"{rep.url}/profilez/{cap['id']}/trace", timeout=10) as resp:
        blob = resp.read()
        assert resp.headers["Content-Type"] == "application/gzip"
    assert blob[:2] == b"\x1f\x8b" and len(blob) > 100
    # back-to-back window -> rate limited with a retry hint
    st3, body3 = http_post(rep.url, "/profilez", {"duration_s": 0.2})
    assert st3 == 429 and body3["error"] == "rate_limited"
    assert 0 < body3["retry_after_s"] <= 30
    # bad duration -> 400, unknown id -> 404
    assert http_post(rep.url, "/profilez", {"duration_s": -1})[0] == 400
    assert http_post(rep.url, "/profilez", {"duration_s": "x"})[0] == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        http_get(rep.url, "/profilez/nope")
    assert ei.value.code == 404
    assert json.loads(ei.value.read())["error"] == "unknown_capture"


def test_profilez_duration_clamp_and_stop_during_capture(
        fleet_cleanup, monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_PROFILEZ_DIR", str(tmp_path / "caps"))
    monkeypatch.setenv("MXTPU_PROFILEZ_MAX_S", "8")
    monkeypatch.setenv("MXTPU_PROFILEZ_INTERVAL_S", "0")
    rep = ReplicaServer(_engine()).start()
    st, cap = http_post(rep.url, "/profilez", {"duration_s": 9999})
    assert st == 200 and cap["duration_s"] == 8.0   # clamped
    assert os.path.dirname(cap["logdir"]) == str(tmp_path / "caps")
    code, out = http_post(rep.url, "/generate",
                          {"prompt": [1, 2, 3], "max_new_tokens": 3})
    assert code == 200 and out["tokens"]
    # stopping the replica mid-window ends the capture early on the
    # step thread, keeps its artifact and releases the profiler
    t0 = time.monotonic()
    rep.stop()
    assert profiler_mod.active_logdir() is None
    assert time.monotonic() - t0 < 8.0, \
        "stop waited out the full capture window"
    _assert_step_thread_ops(rep._captures[cap["id"]], rep)
    # released: a fresh window starts fine
    profiler_mod.start(str(tmp_path / "after"))
    profiler_mod.stop()


def test_capture_fleet_concurrent_windows_and_annotation(
        fleet_cleanup, monkeypatch, tmp_path):
    """``capture_fleet`` opens one window per replica concurrently.
    In-process replicas share ONE profiler, so exactly one window wins
    and the others refuse cleanly (409 -> None); the annotation records
    who accepted, and the winner's window ends ``done``."""
    monkeypatch.setenv("MXTPU_PROFILEZ_DIR", str(tmp_path / "caps"))
    monkeypatch.setenv("MXTPU_PROFILEZ_INTERVAL_S", "0")
    reps = [ReplicaServer(_engine(), replica_id=f"cf-{i}").start()
            for i in range(2)]
    for r in reps:
        fleet_cleanup.append(r)
    col = FleetCollector(urls=[r.url for r in reps], interval_s=0)
    fleet_cleanup.append(col)
    col.scrape()                    # views need names before filtering
    results = col.capture_fleet(duration_s=1.0, reason="unit_fleet")
    assert set(results) == {"cf-0", "cf-1"}
    accepted = [n for n, p in results.items() if p]
    assert len(accepted) == 1, results
    winner = [r for r in reps if r.replica_id == accepted[0]][0]
    code, out = http_post(winner.url, "/generate",
                          {"prompt": [1, 2, 3], "max_new_tokens": 3})
    assert code == 200 and out["tokens"]
    ann = [a for a in col.annotations() if a["kind"] == "fleet_capture"]
    assert ann and ann[-1]["reason"] == "unit_fleet"
    caps = {c["replica"]: c for c in ann[-1]["captures"]}
    assert caps[accepted[0]]["accepted"] is True
    assert sum(c["accepted"] for c in caps.values()) == 1
    # role filter: no replica advertises "prefill" here -> no targets
    assert col.capture_fleet(duration_s=0.2, roles=("prefill",)) == {}
    # the winning window finishes, holding its own step thread's work
    meta = _wait_capture(winner.url, results[accepted[0]]["id"])
    _assert_step_thread_ops(meta, winner)
    # the refused window left no entry behind on the loser
    loser = [r for r in reps if r is not winner][0]
    assert all(c["state"] != "refused" for c in loser._captures.values())


# -- SLO fast-burn -> automatic capture + flight dump -------------------------
def test_slo_burn_triggers_capture_and_dump_carries_id(
        fleet_cleanup, monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("MXTPU_PROFILEZ_DIR", str(tmp_path / "caps"))
    monkeypatch.setenv("MXTPU_PROFILEZ_INTERVAL_S", "0")
    monkeypatch.setenv("MXTPU_PROFILEZ_BURN_S", "1.0")
    col = FleetCollector(urls=[], interval_s=0, port=0)
    fleet_cleanup.append(col)
    col.start()
    monkeypatch.setenv("MXTPU_TRACE_PUSH_URL", col.url + "/trace")
    slow = ReplicaServer(
        _engine(), replica_id="slow-profilee",
        fault_injector=FaultInjector(
            ";".join(f"delay@{k}:0.4" for k in range(1, 9))))
    fleet_cleanup.append(slow.start())
    col.add_replica(slow.url)
    router = Router([slow.url], scrape_interval_s=0, retries=4,
                    backoff_s=0.01, backoff_max_s=0.05, timeout_s=10)
    fleet_cleanup.append(router)
    router.scrape()
    ev = SLOEvaluator(parse_slo_spec("total_p90_ms=150"), col,
                      fast_s=120.0, slow_s=240.0, fast_burn=2.0,
                      slow_burn=1.0, min_requests=5,
                      dump_interval_s=0.0)
    assert ev.capture_on_burn and ev.capture_s == 1.0
    col.slo = ev
    for i, p in enumerate(fx.prompts(8, seed=29)):
        res = router.generate(p.tolist(), max_new_tokens=4,
                              request_id=f"burn-{i}")
        assert res.tokens
        col.scrape()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline \
            and len(col.trace_records()) < 10:
        time.sleep(0.05)
    col.scrape()
    assert ev.statusz()["objectives"][0]["firing"], ev.statusz()
    # the alert captured the offender and chained the id into the dump
    dump_ann = [a for a in col.annotations()
                if a["kind"] == "slo_flight_dump"]
    assert dump_ann, col.annotations()
    entry = dump_ann[0]["dumps"][0]
    assert entry["replica"] == "slow-profilee"
    assert entry["path"], entry
    cap_id = entry["capture_id"]
    assert cap_id, entry
    meta = _wait_capture(slow.url, cap_id)
    _assert_step_thread_ops(meta, slow)
    assert meta["reason"].startswith("slo_burn_total_p90_ms")
    # the on-disk flight dump carries the same capture id
    dumps = list((tmp_path / "flight").glob("flight-*slo_burn*.json"))
    assert dumps
    payload = json.loads(dumps[0].read_text())
    assert payload["extra"]["capture_id"] == cap_id


# -- the stitched fleet timeline ----------------------------------------------
def test_timeline_report_stitches_fleet_run(fleet_cleanup, monkeypatch,
                                            tmp_path):
    import timeline_report

    trace_file = tmp_path / "trace.jsonl"
    monkeypatch.setenv("MXTPU_REQUEST_TRACE", str(trace_file))
    monkeypatch.setenv("MXTPU_PROFILEZ_DIR", str(tmp_path / "caps"))
    rep = ReplicaServer(_engine()).start()
    fleet_cleanup.append(rep)
    router = Router([rep.url], scrape_interval_s=0, timeout_s=10)
    fleet_cleanup.append(router)
    router.scrape()
    st, cap = http_post(rep.url, "/profilez", {"duration_s": 0.5})
    assert st == 200, cap
    for i in range(4):
        res = router.generate([1, 2, 3, 4, 5], max_new_tokens=4,
                              request_id=f"tl-{i}")
        assert res.tokens
    meta = _wait_capture(rep.url, cap["id"])
    _assert_step_thread_ops(meta, rep)
    cap_file = tmp_path / "cap.json"
    cap_file.write_text(json.dumps(meta))
    # both line kinds must have flushed (router + engine per request)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        lines = [json.loads(ln) for ln
                 in trace_file.read_text().splitlines()] \
            if trace_file.exists() else []
        if len(lines) >= 8:
            break
        time.sleep(0.05)
    assert len(lines) >= 8, len(lines)
    statusz_file = tmp_path / "statusz.json"
    statusz_file.write_text(json.dumps(http_get(rep.url, "/statusz.json")))
    out = tmp_path / "TIMELINE.json"
    summary_file = tmp_path / "summary.json"
    rc = timeline_report.main([
        "--trace", str(trace_file), "--statusz", str(statusz_file),
        "--capture", str(cap_file), "--out", str(out),
        "--json", str(summary_file), "--check"])
    assert rc == 0
    doc = json.loads(out.read_text())
    evs = doc["traceEvents"]
    assert evs and all("name" in e and "ph" in e for e in evs)
    assert all(e.get("dur", 0) >= 0 for e in evs if e["ph"] == "X")
    summary = json.loads(summary_file.read_text())["summary"]
    assert summary["requests"] == 4
    assert summary["router_hops"] == 4
    assert summary["unresolved_hops"] == []
    assert summary["steps"] > 0
    assert summary["device_events"] > 0 and summary["captures_missing"] == 0
    # fleet lines and the capture carry clock anchors
    assert summary["unanchored"] == 0
    # request events land under both the router and the replica pids
    req_pids = {e["pid"] for e in evs if e.get("cat") == "request"}
    assert len(req_pids) == 2
    # and a router-only trace id is what --check must catch
    orphan = tmp_path / "orphan.jsonl"
    orphan.write_text(json.dumps({
        "trace_id": "lost-req", "rid": 1, "status": "finished",
        "source": "router", "replica": "router",
        "events": [{"ev": "pick", "t": 0.0},
                   {"ev": "finished", "t": 0.1}]}) + "\n")
    rc = timeline_report.main([
        "--trace", str(orphan), "--out",
        str(tmp_path / "bad.json"), "--check"])
    assert rc == 1


# -- windows owned by the step thread -----------------------------------------
def test_profilez_window_mid_traffic_holds_whole_steps(
        fleet_cleanup, monkeypatch, tmp_path, tel):
    """A window opened while the replica serves a stream of requests
    opens and closes between two steps: its ``serve.step`` spans equal
    the steps it counts, its ``serve.decode`` spans the decode steps,
    all on the step thread; the tokens are an uncontended engine's and
    the window counts ``started`` and ``done``."""
    monkeypatch.setenv("MXTPU_PROFILEZ_DIR", str(tmp_path / "caps"))
    prompts = fx.prompts(6, seed=41)
    want = fx.fleet_tokens(prompts, 24)
    rep = ReplicaServer(_engine(), replica_id="busy").start()
    fleet_cleanup.append(rep)
    got, errs, done = [], [], threading.Event()

    def traffic():
        # rounds over the prompts until the window has closed
        try:
            while not done.is_set():
                for i, p in enumerate(prompts):
                    code, out = http_post(rep.url, "/generate",
                                          {"prompt": p.tolist(),
                                           "max_new_tokens": 24})
                    got.append((i, out["tokens"] if code == 200
                                else out))
        except Exception as e:      # judged below
            errs.append(repr(e))

    th = threading.Thread(target=traffic)
    th.start()
    while rep.engine.decode_steps == 0 and th.is_alive():
        time.sleep(0.005)
    st, cap = http_post(rep.url, "/profilez", {"duration_s": 0.5})
    assert st == 200, cap
    meta = _wait_capture(rep.url, cap["id"])
    done.set()
    th.join(timeout=120)
    assert not th.is_alive() and not errs, errs
    assert len(got) >= len(prompts)
    assert all(toks == want[i] for i, toks in got)
    ops = _assert_step_thread_ops(meta, rep)
    tid = rep._step_thread.native_id
    evs = _trace_events(meta)
    spans = {name: [e for e in evs if e["name"] == name]
             for name in ("serve.step", "serve.decode")}
    assert meta["steps"] > 0 and meta["decode_steps"] > 0, meta
    assert len(spans["serve.step"]) == meta["steps"]
    assert len(spans["serve.decode"]) == meta["decode_steps"]
    assert all(e.get("tid") == tid for s in spans.values() for e in s)
    # the window opens before the first step's operators
    first = min(e["ts"] for e in spans["serve.step"])
    assert all(e["ts"] >= first for e in ops)
    snap = mt.telemetry.registry().snapshot()
    outcomes = {s["labels"]["outcome"]: s["value"] for s in
                snap["mxtpu_fleet_profilez_total"]["samples"]}
    assert outcomes == {"started": 1, "done": 1}


@pytest.mark.parametrize("end", ["drain", "hard_stop"])
def test_profilez_window_ends_early_at_drain_and_hard_stop(
        fleet_cleanup, monkeypatch, tmp_path, end):
    """``drain`` and ``hard_stop`` during a window end it on the step
    thread before its duration, with the artifact kept (``done``), and
    release the process's profiler."""
    monkeypatch.setenv("MXTPU_PROFILEZ_DIR", str(tmp_path / "caps"))
    rep = ReplicaServer(_engine(), replica_id=f"end-{end}").start()
    fleet_cleanup.append(rep)
    st, cap = http_post(rep.url, "/profilez", {"duration_s": 8})
    assert st == 200, cap
    code, out = http_post(rep.url, "/generate",
                          {"prompt": [3, 4, 5], "max_new_tokens": 4})
    assert code == 200 and out["tokens"]
    t0 = time.monotonic()
    getattr(rep, end)()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline \
            and rep._captures[cap["id"]]["state"] == "running":
        time.sleep(0.02)
    assert time.monotonic() - t0 < 8.0
    meta = dict(rep._captures[cap["id"]])
    _assert_step_thread_ops(meta, rep)
    assert meta["steps"] >= 1
    assert profiler_mod.active_logdir() is None
    if end == "drain":
        # a draining replica opens no new window
        st2, body = http_post(rep.url, "/profilez", {"duration_s": 0.2})
        assert st2 == 503 and body["error"] == "not_ready"


def test_profiler_prime_starts_and_stops_once(monkeypatch):
    """``profiler.prime`` runs one throwaway capture a process, leaves no
    capture active, and does nothing after that or while another
    capture holds the profiler."""
    monkeypatch.setattr(profiler_mod, "_primed", False)
    starts = []
    real_start = profiler_mod.start

    def counting_start(logdir):
        starts.append(logdir)
        return real_start(logdir)

    monkeypatch.setattr(profiler_mod, "start", counting_start)
    assert profiler_mod.prime() is True
    assert profiler_mod.prime() is False
    assert len(starts) == 1 and not os.path.exists(starts[0])
    assert profiler_mod.active_logdir() is None
    monkeypatch.setattr(profiler_mod, "_primed", False)
    real_start(str(starts[0]) + "-held")
    try:
        assert profiler_mod.prime() is False    # held: not primed
        assert profiler_mod._primed is False
    finally:
        profiler_mod.stop()


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_replica_primes_the_profiler_before_ready(fleet_cleanup,
                                                  monkeypatch, device):
    """A replica over a CUDA engine primes the profiler on its step
    thread before it goes READY (a first window then does not pay
    CUPTI's set-up while the replica serves); one over a CPU engine
    does not.  The engine's device is stood in for: its step loop
    finds no work."""
    seen = []

    def prime():
        seen.append((threading.current_thread().name, rep.state))
        return True

    monkeypatch.setattr(profiler_mod, "prime", prime)
    eng = _engine()
    if device == "cuda":
        monkeypatch.setattr(eng, "device", _FakeDevice("cuda"))
    rep = ReplicaServer(eng, replica_id=f"prime-{device}")
    fleet_cleanup.append(rep)
    rep.start()
    assert rep.state == "ready"
    if device == "cuda":
        assert seen == [(rep._step_thread.name, "starting")]
    else:
        assert seen == []


class _FakeDevice:
    """A ``torch.device`` stood in for: its ``type`` alone."""

    def __init__(self, kind):
        self.type = kind
