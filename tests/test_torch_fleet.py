"""The PyTorch port's fleet core against the JAX reference
(``mxnet_tpu_torch/fleet``: replica front, retrying router, supervisor,
chaos hooks, process front; the launch-counter lock of
``ops/paged_attention_cuda.py``).

Ports ``tests/test_fleet.py`` case by case (all but the slow
``fleet_bench`` contract): real ``ReplicaServer`` HTTP servers over port
engines on the CPU, the port's ``Router`` and ``Supervisor``, a *kill*
fault as the in-process hard stop.  Token identity is against one
uncontended port engine (``tests/test_torch_engine.py`` holds that one
against the reference).  Hops get at least 2 s and hang faults are
released by the replica's stop event, not by sleeps.

Cross-package cases: ``parse_fault_spec`` over the reference's grammar
cases, the router's ``_load_score`` and ``_pick`` on the same scrape
payloads, and the process front's weights against the reference
front's numpy draw.  Added: two engines stepped on two threads count
the paged op's launches exactly; the process front as a subprocess
(ready line, ``/generate``, SIGTERM; it imports neither ``jax`` nor the
reference); the names later ROADMAP items own refuse.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch_port_fixtures as fx
from torch_port_fixtures import (  # noqa: F401  (autouse / fixtures)
    InProcHandle, collect_engines_after_module, fleet_cleanup,
    fresh_telemetry_per_module, http_get, http_post)

import mxnet_tpu.fleet as ref_fleet
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.fleet import (DEAD, DRAINING, READY, FaultInjector,
                                   NoReplicaAvailable, PermanentError,
                                   ReplicaServer, Router, Supervisor,
                                   parse_fault_spec)
from mxnet_tpu_torch.ops import paged_attention_cuda as pac
from mxnet_tpu_torch.serve import BlockManager, Scheduler
from mxnet_tpu_torch.serve.scheduler import Request
from mxnet_tpu_torch.telemetry import statusz

VOCAB = fx.VOCAB
HOP_S = 10.0          # per-hop timeout of the routers here (>= 2 s)


def _engine(**kw):
    return fx.fleet_engine(**kw)


def _prompts(n, seed=7, lo=6, hi=22):
    return fx.prompts(n, seed=seed, lo=lo, hi=hi)


def _reference_tokens(prompts, max_new):
    return fx.fleet_tokens(prompts, max_new)


# -- fault spec ---------------------------------------------------------------
GRAMMAR = ["kill@5;delay@2:0.25;refuse@3:2;hang@7:30", "", None, "kill@5",
           "refuse@1;kill@9", " delay@2 ; hang@1:0.5 ", "refuse@3:0"]
BAD_SPECS = ["kill", "boom@3", "kill@0", "kill@x", "delay@2:abc"]


def test_fault_spec_grammar():
    faults = parse_fault_spec("kill@5;delay@2:0.25;refuse@3:2;hang@7:30")
    assert [(f.action, f.at) for f in faults] == \
        [("kill", 5), ("delay", 2), ("refuse", 3), ("hang", 7)]
    assert faults[1].arg == 0.25
    assert faults[2].matches(3) and faults[2].matches(4)
    assert not faults[2].matches(5)          # refuse range is [3, 5)
    assert faults[0].matches(5) and not faults[0].matches(6)
    assert parse_fault_spec("") == [] and parse_fault_spec(None) == []
    for bad in ("kill", "boom@3", "kill@0", "kill@x"):
        with pytest.raises(ValueError):
            parse_fault_spec(bad)

    inj = FaultInjector("refuse@2;kill@4")
    got = [inj.on_request() for _ in range(4)]
    assert got[0] is None and got[2] is None
    assert got[1].action == "refuse" and got[3].action == "kill"
    assert inj.count == 4 and len(inj.fired) == 2


@pytest.mark.parametrize("spec", GRAMMAR + BAD_SPECS)
def test_fault_spec_parses_as_reference(spec):
    """Each grammar case parses to the reference's rules (or fails as
    the reference does), and the rules match the same arrivals."""
    def parse(mod):
        try:
            return [(f.action, f.at, f.arg,
                     [f.matches(i) for i in range(1, 12)])
                    for f in mod.parse_fault_spec(spec)]
        except ValueError:
            return "ValueError"

    assert parse(mt.fleet.faults) == parse(ref_fleet.faults)


# -- scheduler satellites -----------------------------------------------------
def test_scheduler_rejects_expired_deadline_at_submit():
    m = BlockManager(num_blocks=9, block_size=4)
    s = Scheduler(m, max_batch=2, max_queue=8, clock=lambda: 0.0)
    dead = s.submit(Request(np.arange(1, 4), 4, deadline_s=0.0))
    assert dead.status == "rejected"
    assert dead.reject_reason == "deadline_at_submit"
    neg = s.submit(Request(np.arange(1, 4), 4, deadline_s=-1.0))
    assert neg.reject_reason == "deadline_at_submit"
    live = s.submit(Request(np.arange(1, 4), 4, deadline_s=5.0))
    assert live.status == "waiting"
    assert s.rejections == 2
    assert s.reject_reasons == {"deadline_at_submit": 2}
    assert s.queue_depth == 1                # rejected ones never queued


def test_scheduler_tenant_fair_share_cap_and_rotation():
    clock = {"now": 0.0}
    m = BlockManager(num_blocks=33, block_size=4)
    s = Scheduler(m, max_batch=4, max_queue=4, max_prefills_per_step=2,
                  clock=lambda: clock["now"], tenant_share=0.5)
    a1 = s.submit(Request(np.arange(1, 5), 2, tenant="abuser"))
    a2 = s.submit(Request(np.arange(1, 5), 2, tenant="abuser"))
    a3 = s.submit(Request(np.arange(1, 5), 2, tenant="abuser"))
    assert a1.status == a2.status == "waiting"
    assert a3.status == "rejected" and a3.reject_reason == "tenant_share"
    b1 = s.submit(Request(np.arange(1, 5), 2, tenant="polite"))
    assert b1.status == "waiting"
    prefills, _ = s.schedule()
    assert [(r.tenant, r.rid) for r in prefills] == \
        [("abuser", a1.rid), ("polite", b1.rid)]
    stats = s.tenant_stats()
    assert stats["abuser"]["rejected"] == 1
    assert stats["abuser"]["submitted"] == 2
    assert stats["polite"]["submitted"] == 1
    d1 = s.submit(Request(np.arange(1, 5), 2))               # None
    d2 = s.submit(Request(np.arange(1, 5), 2, tenant="default"))
    d3 = s.submit(Request(np.arange(1, 5), 2))
    assert d1.status == d2.status == "waiting"
    assert d3.status == "rejected" and d3.reject_reason == "tenant_share"


def test_engine_tenant_plumbing_and_trace_id():
    eng = _engine()
    req = eng.submit(_prompts(1)[0], max_new_tokens=4, tenant="acme",
                     trace_id="fleet-abc123")
    assert req.trace_id == "fleet-abc123"
    eng.run()
    st = eng.stats()
    assert st.tenants["acme"]["completed"] == 1
    assert st.tenants["acme"]["latency_s_mean"] is not None
    assert eng.statusz()["tenants"]["acme"]["completed"] == 1
    eng.shutdown()


# -- the launch counters under two stepping engines ---------------------------
def _counting_paged(q, k_cache, v_cache, block_tables, context_lens,
                    **kw):
    """The plain path in the op's place, counting through the op's own
    lock as a launch does (one split and one combine launch a call)."""
    from mxnet_tpu_torch.ops.attention import paged_attention_torch

    out = paged_attention_torch(q, k_cache, v_cache, block_tables,
                                context_lens, **kw)
    pac.count_launches(1, 1)
    return out


def test_two_engines_on_two_threads_count_launches_exactly(monkeypatch):
    """Two engines stepped on two threads: the process counters equal
    the sum of both engines' launches (layers x decode calls each)."""
    monkeypatch.setenv("MXTPU_TORCH_PAGED_ATTENTION", "cuda")
    monkeypatch.setattr(pac, "paged_attention_cuda", _counting_paged)
    engines = [_engine(), _engine()]
    prompts = _prompts(8, seed=5)
    for eng in engines:
        for p in prompts:
            eng.submit(p, max_new_tokens=24)
    before = (pac.launches, pac.combine_launches)
    go = threading.Barrier(2)

    def pump(eng):
        go.wait()
        eng.run()

    threads = [threading.Thread(target=pump, args=(e,)) for e in engines]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    expected = sum(
        eng._cfg.n_layers * sum(prog.calls for (kind, _), prog
                                in eng._programs.items()
                                if kind == "decode")
        for eng in engines)
    assert expected > 0
    assert pac.launches - before[0] == expected
    assert pac.combine_launches - before[1] == expected
    for eng in engines:
        eng.shutdown()


def test_capture_takes_off_only_its_own_counts():
    """The capture bookkeeping in ``serve/engine.py``: a thread that
    counts launches (its warm-up and capture) and then takes its own
    tally off leaves a sibling thread's launches, counted meanwhile, in
    the counts."""
    before = (pac.launches, pac.combine_launches)
    started, stop = threading.Event(), threading.Event()
    sibling_tally = []

    def sibling():
        t0 = pac.thread_counts()
        started.set()
        while not stop.is_set():
            pac.count_launches(1, 0)
        t1 = pac.thread_counts()
        sibling_tally.append((t1[0] - t0[0], t1[1] - t0[1]))

    t = threading.Thread(target=sibling)
    t.start()
    started.wait()
    mine0 = pac.thread_counts()
    for _ in range(2000):
        pac.count_launches(1, 1)            # "warm-up and capture"
    mine1 = pac.thread_counts()
    pac.add_counts(*[a - b for a, b in zip(mine0, mine1)])
    stop.set()
    t.join()
    assert mine1[0] - mine0[0] == 2000
    (theirs,) = sibling_tally
    assert theirs[0] > 0
    assert (pac.launches - before[0],
            pac.combine_launches - before[1]) == theirs


def test_counter_updates_under_thread_stress():
    """Many threads counting launches, replaying (``add_counts``) and
    taking a capture's counts off again, with the interpreter switching
    threads every microsecond: the counts come out exact (a lost
    update would break it)."""
    n_threads, n_iter = 16, 400
    before = (pac.launches, pac.combine_launches)
    interval = sys.getswitchinterval()
    go = threading.Barrier(n_threads)

    def worker():
        go.wait()
        for _ in range(n_iter):
            pac.count_launches(1, 1)
            pac.add_counts(2, 1)
            mine0 = pac.thread_counts()
            pac.count_launches(1, 0)           # a "capture" ...
            mine1 = pac.thread_counts()
            pac.add_counts(*[a - b for a, b in zip(mine0, mine1)])

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert pac.launches - before[0] == 3 * n_threads * n_iter
    assert pac.combine_launches - before[1] == 2 * n_threads * n_iter


# -- replica front ------------------------------------------------------------
def test_replica_roundtrip_idempotency_and_statusz(fleet_cleanup):
    prompts = _prompts(1, seed=11)
    [ref] = _reference_tokens(prompts, 8)
    rep = ReplicaServer(_engine(), replica_id="r0").start()
    fleet_cleanup.append(rep)
    assert rep.state == READY
    code, out = http_post(rep.url, "/generate",
                          {"prompt": prompts[0].tolist(),
                           "max_new_tokens": 8, "request_id": "req-1",
                           "tenant": "acme"})
    assert code == 200 and out["tokens"] == ref
    assert out["replica"] == "r0" and out["tenant"] == "acme"
    code, again = http_post(rep.url, "/generate",
                            {"prompt": prompts[0].tolist(),
                             "max_new_tokens": 8, "request_id": "req-1"})
    assert code == 200 and again["tokens"] == ref and again["deduped"]
    assert rep.engine.stats().completed == 1
    snap = http_get(rep.url, "/statusz.json")
    assert snap["replica"]["replica"] == "r0"
    assert snap["replica"]["state"] == "ready"
    assert "queue_depth" in snap["replica"]
    assert "kv_utilization" in snap["replica"]
    code, err = http_post(rep.url, "/generate",
                          {"prompt": [1] * 60, "max_new_tokens": 30})
    assert code == 400 and err["error"] == "exceeds_max_len"
    assert err["retriable"] is False
    for bad in ({"prompt": [], "max_new_tokens": 4},
                {"prompt": [1, 2], "max_new_tokens": 0},
                {"prompt": [1, 2], "max_new_tokens": 4,
                 "deadline_s": "abc"},
                {"max_new_tokens": 4}):
        code, err = http_post(rep.url, "/generate", bad)
        assert code == 400 and err["error"] == "bad_request", (bad, err)
        assert err["retriable"] is False
    rep.stop()
    assert rep.engine.params is None          # engine released


def test_replica_sections_match_reference(fleet_cleanup):
    """``/healthz`` and the ``/statusz.json`` replica section carry the
    reference replica's keys (and ``stats``' keys) on the same traffic,
    the routing signals with equal values; ``/metrics`` and
    ``/flight_dump`` read the port's registry and recorder."""
    prompts = _prompts(2, seed=13)
    reps = {"port": ReplicaServer(_engine(), replica_id="same").start(),
            "ref": ref_fleet.ReplicaServer(fx.ref_fleet_engine(),
                                           replica_id="same").start()}
    fleet_cleanup.extend(reps.values())
    for rep in reps.values():
        for i, p in enumerate(prompts):
            code, _ = http_post(rep.url, "/generate",
                                {"prompt": p.tolist(), "max_new_tokens": 6,
                                 "request_id": f"s{i}"})
            assert code == 200
    hz = {k: http_get(r.url, "/healthz") for k, r in reps.items()}
    sec = {k: http_get(r.url, "/statusz.json")["replica"]
           for k, r in reps.items()}
    assert set(hz["port"]) == set(hz["ref"])
    assert set(sec["port"]) == set(sec["ref"])
    assert set(sec["port"]["stats"]) == set(sec["ref"]["stats"])
    for key in ("state", "role", "in_flight", "queue_depth", "running",
                "waiting_handoffs", "host_kv_utilization"):
        assert hz["port"][key] == hz["ref"][key], key
    for key in ("served", "max_batch", "kv_utilization", "handoff",
                "pull", "faults_fired"):
        assert sec["port"][key] == sec["ref"][key], key
    assert hz["port"]["kv_summary"] == hz["ref"]["kv_summary"]
    with urllib.request.urlopen(f"{reps['port'].url}/metrics",
                                timeout=10) as resp:
        assert resp.status == 200
    code, out = http_post(reps["port"].url, "/flight_dump",
                          {"reason": "unit"})
    assert code == 200 and out["replica"] == "same"


def _fleet_families(text):
    """``{family: (type, sorted label names, bucket bounds)}`` of the
    ``mxtpu_fleet_*`` families in a Prometheus text exposition."""
    import re

    fams = {}
    for line in text.splitlines():
        if line.startswith("# TYPE mxtpu_fleet_"):
            _, _, name, kind = line.split()
            fams[name] = [kind, set(), set()]
        elif line.startswith("mxtpu_fleet_"):
            name, _, rest = line.partition("{")
            base = re.sub(r"_(bucket|sum|count)$", "", name)
            if base not in fams:
                continue
            labels = dict(re.findall(r'(\w+)="([^"]*)"', rest))
            le = labels.pop("le", None)
            if le is not None:
                fams[base][2].add(le)
            fams[base][1].update(labels)
    return {k: (v[0], sorted(v[1]), sorted(v[2])) for k, v in fams.items()}


def test_fleet_metric_families_match_reference(fleet_cleanup):
    """The same traffic through a reference fleet and a port fleet, both
    with telemetry on: the ``mxtpu_fleet_*`` families carry the
    reference's names, types, label names and buckets, so the
    reference's Prometheus parsers read the port's."""
    import mxnet_tpu.telemetry as ref_tel
    from mxnet_tpu_torch import telemetry as port_tel

    texts = {}
    try:
        for tag, pkg, tel, make in (
                ("ref", ref_fleet, ref_tel, fx.ref_fleet_engine),
                ("port", mt.fleet, port_tel, _engine)):
            tel.reset()
            tel.enable()
            pre = pkg.ReplicaServer(make(), replica_id="fp",
                                    role="prefill").start()
            dec = pkg.ReplicaServer(make(host_kv_bytes=fx.FLEET_POOL),
                                    replica_id="fd", role="decode").start()
            both = pkg.ReplicaServer(make(), replica_id="fb").start()
            fleet_cleanup.extend([pre, dec, both])
            router = pkg.Router([pre.url, dec.url], scrape_interval_s=0,
                                timeout_s=HOP_S)
            router.scrape()
            for i, p in enumerate(_prompts(2, seed=81)):
                router.generate(p.tolist(), max_new_tokens=4,
                                request_id=f"m{i}")
            both.drain()
            http_post(both.url, "/flight_dump", {"reason": "m"})
            texts[tag] = tel.to_prometheus_text(tel.registry())
            router.stop()
            for rep in (pre, dec, both):
                rep.stop()
            tel.disable()
    finally:
        for tel in (ref_tel, port_tel):
            tel.disable()
            tel.reset()
    ref, port = (_fleet_families(texts[k]) for k in ("ref", "port"))
    assert len(ref) >= 8
    assert port == ref


def test_profilez_knobs_are_honoured(fleet_cleanup, monkeypatch, tmp_path):
    """``MXTPU_PROFILEZ_DIR``, ``_MAX_S`` and ``_INTERVAL_S`` configure
    the replica's ``/profilez`` windows with the reference's defaults
    (10 s, 30 s, a temporary directory) when unset."""
    for var in ("MXTPU_PROFILEZ_DIR", "MXTPU_PROFILEZ_MAX_S",
                "MXTPU_PROFILEZ_INTERVAL_S"):
        monkeypatch.delenv(var, raising=False)
    eng = _engine()
    ref_eng = fx.ref_fleet_engine()
    port_rep, ref_rep = ReplicaServer(eng), ref_fleet.ReplicaServer(ref_eng)
    for rep in (port_rep, ref_rep):
        assert (rep._profilez_dir, rep._profilez_max_s,
                rep._profilez_interval_s) == (None, 10.0, 30.0)
    eng.shutdown()
    ref_eng.shutdown()
    monkeypatch.setenv("MXTPU_PROFILEZ_DIR", str(tmp_path / "caps"))
    monkeypatch.setenv("MXTPU_PROFILEZ_MAX_S", "0.3")
    monkeypatch.setenv("MXTPU_PROFILEZ_INTERVAL_S", "60")
    rep = ReplicaServer(_engine(), replica_id="pz").start()
    fleet_cleanup.append(rep)
    code, out = http_post(rep.url, "/profilez", {"duration_s": 5})
    assert code == 200 and out["duration_s"] == 0.3
    assert out["logdir"] == str(tmp_path / "caps" / out["id"])
    code, late = http_post(rep.url, "/profilez", {"duration_s": 0.1})
    assert code in (409, 429) and late["error"] in (
        "capture_in_progress", "rate_limited")
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline \
            and http_get(rep.url, f"/profilez/{out['id']}")["state"] \
            == "running":
        time.sleep(0.05)
    meta = http_get(rep.url, f"/profilez/{out['id']}")
    assert meta["state"] == "done", meta
    assert meta["trace_file"].startswith(out["logdir"])
    code, again = http_post(rep.url, "/profilez", {"duration_s": 0.1})
    assert code == 429 and 0 < again["retry_after_s"] <= 60


def test_abandoned_engine_is_collected(fleet_cleanup):
    """A kill fault's hard stop abandons the engine mid-traffic; once
    the replica's threads end, nothing keeps it: it is collected (its
    buffers and, on CUDA, its graph pool freed) while a sibling serves
    on."""
    import gc
    import weakref

    victim = ReplicaServer(_engine(), replica_id="v",
                           fault_injector=FaultInjector("kill@1")).start()
    sibling = ReplicaServer(_engine(), replica_id="s").start()
    fleet_cleanup.append(sibling)
    prompt = _prompts(1, seed=73)[0].tolist()
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        http_post(victim.url, "/generate",
                  {"prompt": prompt, "max_new_tokens": 8})
    assert victim.state == DEAD
    gone = weakref.ref(victim.engine)
    threads = (victim._http_thread, victim._step_thread)
    del victim
    for t in threads:
        t.join(timeout=30)
    deadline = time.monotonic() + 30
    while gone() is not None and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.05)
    assert gone() is None
    code, out = http_post(sibling.url, "/generate",
                          {"prompt": prompt, "max_new_tokens": 8})
    assert code == 200
    assert out["tokens"] == _reference_tokens([prompt], 8)[0]


def test_handler_device_paths_hold_the_step_lock(fleet_cleanup):
    """Every handler path that touches the device runs under the
    replica's step lock (which the step thread holds around
    ``engine.step()``, so a capture there stays valid): a prefill
    handoff's export, ``/chain_export``, and a submit naming an adapter
    (its first request loads the adapter's device slot)."""
    seen = []

    def guard(rep, obj, name):
        fn = getattr(obj, name)

        def wrapped(*a, **kw):
            seen.append((name, rep._step_lock.locked()))
            return fn(*a, **kw)

        setattr(obj, name, wrapped)

    pre = ReplicaServer(_engine(), replica_id="lp", role="prefill")
    guard(pre, pre.engine.blocks, "export_blocks")
    pre.start()
    fleet_cleanup.append(pre)
    prompt = _prompts(1, seed=75, lo=12, hi=13)[0].tolist()
    code, out = http_post(pre.url, "/generate",
                          {"prompt": prompt, "max_new_tokens": 4})
    assert code == 200 and out["handoff"]["records"]
    code, out = http_post(pre.url, "/chain_export", {"prompt": prompt})
    assert code == 200 and out["records"]
    eng = _engine(adapters=3, adapter_rank=2)
    rng = np.random.RandomState(0)
    stems = {s: (rng.randn(2, din).astype(np.float32) * 0.1,
                 rng.randn(dout, 2).astype(np.float32) * 0.1)
             for s, (dout, din) in list(eng.adapter_store.stems.items())[:2]}
    eng.adapter_store.register("ad1", stems)
    rep = ReplicaServer(eng, replica_id="la")
    guard(rep, eng.adapter_store, "acquire")
    rep.start()
    fleet_cleanup.append(rep)
    code, out = http_post(rep.url, "/generate",
                          {"prompt": prompt, "max_new_tokens": 4,
                           "adapter": "ad1"})
    assert code == 200 and out["tokens"]
    assert [n for n, _ in seen] == ["export_blocks", "export_blocks",
                                    "acquire"]
    assert all(locked for _, locked in seen), seen


def test_drain_finishes_inflight_token_identically(fleet_cleanup):
    prompts = _prompts(3, seed=23)
    refs = _reference_tokens(prompts, 40)
    rep = ReplicaServer(_engine(), replica_id="drainee").start()
    fleet_cleanup.append(rep)
    router = Router([rep.url], scrape_interval_s=0.1, timeout_s=30,
                    retries=1)
    fleet_cleanup.append(router)
    router.scrape()
    router.start()
    results = {}

    def client(i):
        results[i] = http_post(rep.url, "/generate",
                               {"prompt": prompts[i].tolist(),
                                "max_new_tokens": 40,
                                "request_id": f"d-{i}"}, timeout=60)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(3)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline \
            and not rep.engine.scheduler.running:
        time.sleep(0.002)
    assert rep.engine.scheduler.running, "requests never started"
    code, out = http_post(rep.url, "/drain", {})
    assert code == 200 and out["state"] == DRAINING
    assert rep.engine.scheduler.has_work(), \
        "drain landed after all work finished — test is vacuous"
    code, rej = http_post(rep.url, "/generate",
                          {"prompt": prompts[0].tolist(),
                           "max_new_tokens": 4})
    assert code == 503 and rej["retriable"] is True
    for t in threads:
        t.join(timeout=60)
    for i in range(3):
        code, out = results[i]
        assert code == 200, out
        assert out["tokens"] == refs[i]
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline \
            and router.snapshot()[0]["state"] != "draining":
        time.sleep(0.05)
    assert router.snapshot()[0]["state"] == "draining"
    with pytest.raises(NoReplicaAvailable):
        router.generate(prompts[0].tolist(), max_new_tokens=4)
    assert rep.drained()


def test_chaos_kill_mid_stream_all_requests_complete(fleet_cleanup):
    n_req, max_new = 8, 16
    prompts = _prompts(n_req, seed=31)
    refs = _reference_tokens(prompts, max_new)
    injector = FaultInjector("kill@2")
    reps = []
    for i in range(3):
        rep = ReplicaServer(
            _engine(), replica_id=f"c{i}",
            fault_injector=injector if i == 1 else None).start()
        fleet_cleanup.append(rep)
        reps.append(rep)
    router = Router([r.url for r in reps], scrape_interval_s=0,
                    timeout_s=30, retries=4, backoff_s=0.01,
                    backoff_max_s=0.05, breaker_fails=3,
                    breaker_reset_s=5.0)
    router.scrape()
    results = {}
    for i, p in enumerate(prompts):
        res = router.generate(p.tolist(), max_new_tokens=max_new,
                              request_id=f"chaos-{i}")
        assert i not in results
        results[i] = res
    assert reps[1].state == DEAD, "kill fault never fired"
    assert injector.fired and injector.fired[0][1].action == "kill"
    assert len(results) == n_req
    for i in range(n_req):
        assert results[i].tokens == refs[i], f"request {i} diverged"
    assert any(r.attempts > 1 for r in results.values())
    served = sum(r.engine.stats().completed for r in reps
                 if r.state != DEAD)
    assert served >= n_req - 2
    snap = {s["replica"]: s for s in router.snapshot()}
    assert snap["c1"]["consecutive_failures"] >= 1 \
        or snap["c1"]["breaker_open"] or snap["c1"]["state"] == "down"


def test_rolling_restart_zero_client_rejects(fleet_cleanup):
    n_req, max_new = 18, 8
    prompts = _prompts(n_req, seed=41)
    refs = _reference_tokens(prompts, max_new)

    def spawn(slot):
        rep = ReplicaServer(_engine(), replica_id=f"slot{slot}").start()
        fleet_cleanup.append(rep)
        return InProcHandle(rep)

    router = Router([], scrape_interval_s=0.1, timeout_s=30, retries=6,
                    backoff_s=0.02, backoff_max_s=0.2, breaker_fails=10)
    fleet_cleanup.append(router)
    sup = Supervisor(spawn, 3, router=router, drain_timeout_s=30)
    sup.start()
    router.scrape()
    router.start()
    first_gen = set(sup.urls())
    results, failures = {}, {}

    def load():
        for i, p in enumerate(prompts):
            try:
                results[i] = router.generate(
                    p.tolist(), max_new_tokens=max_new,
                    request_id=f"roll-{i}")
            except Exception as e:           # any client-visible failure
                failures[i] = repr(e)
            time.sleep(0.01)

    t = threading.Thread(target=load, daemon=True)
    t.start()
    sup.rolling_restart()
    t.join(timeout=120)
    assert not failures, f"client saw failures: {failures}"
    assert len(results) == n_req
    for i in range(n_req):
        assert results[i].tokens == refs[i]
    assert not (set(sup.urls()) & first_gen)
    sup.stop()


def test_router_circuit_breaker_opens_and_half_opens(fleet_cleanup):
    import socket

    clock = {"now": 0.0}
    rep = ReplicaServer(_engine(), replica_id="live").start()
    fleet_cleanup.append(rep)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead_url = f"http://127.0.0.1:{s.getsockname()[1]}"
    s.close()
    router = Router([dead_url, rep.url], scrape_interval_s=0,
                    timeout_s=HOP_S, retries=4, backoff_s=0.0,
                    backoff_max_s=0.0, breaker_fails=2,
                    breaker_reset_s=10.0, clock=lambda: clock["now"],
                    sleep=lambda s_: None)
    prompt = _prompts(1)[0].tolist()
    for i in range(3):
        res = router.generate(prompt, max_new_tokens=2,
                              request_id=f"cb-{i}")
        assert res.tokens
    snap = {x["url"]: x for x in router.snapshot()}
    assert snap[dead_url]["breaker_open"], snap
    res = router.generate(prompt, max_new_tokens=2, request_id="cb-x")
    assert res.attempts == 1
    clock["now"] = 11.0
    assert not {x["url"]: x for x in
                router.snapshot()}[dead_url]["breaker_open"]
    res = router.generate(prompt, max_new_tokens=2, request_id="cb-y")
    assert res.tokens
    assert {x["url"]: x for x in
            router.snapshot()}[dead_url]["breaker_open"]


def test_router_timeout_retries_hung_replica(fleet_cleanup):
    """A hop into a hung replica times out (3 s here) and the request
    completes on the sibling; the hang ends when the replica stops."""
    hung = ReplicaServer(_engine(), replica_id="hung",
                         fault_injector=FaultInjector("hang@1:60")).start()
    live = ReplicaServer(_engine(), replica_id="live2").start()
    fleet_cleanup.extend([hung, live])
    router = Router([hung.url, live.url], scrape_interval_s=0,
                    timeout_s=3.0, retries=3, backoff_s=0.01,
                    backoff_max_s=0.05)
    router.scrape()
    prompts = _prompts(1, seed=51)
    [ref] = _reference_tokens(prompts, 6)
    saw_timeout = False
    for i in range(3):
        res = router.generate(prompts[0].tolist(), max_new_tokens=6,
                              request_id=f"hang-{i}")
        assert res.tokens == ref
        saw_timeout = saw_timeout or any(
            h["status"] == "timeout" for h in res.hops)
    assert saw_timeout, "no attempt ever hit the hung replica"
    t0 = time.monotonic()
    hung.stop()                  # releases the held handler at once
    assert time.monotonic() - t0 < 10


def test_router_retries_queue_full_on_sibling(fleet_cleanup):
    tiny = ReplicaServer(_engine(max_queue=1, max_batch=1),
                         replica_id="tiny").start()
    big = ReplicaServer(_engine(), replica_id="big").start()
    fleet_cleanup.extend([tiny, big])
    router = Router([tiny.url, big.url], scrape_interval_s=0,
                    timeout_s=30, retries=4, backoff_s=0.01,
                    backoff_max_s=0.02)
    prompts = _prompts(6, seed=61)
    results = {}

    def client(i):
        results[i] = router.generate(prompts[i].tolist(),
                                     max_new_tokens=8,
                                     request_id=f"qf-{i}")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert len(results) == 6
    refs = _reference_tokens(prompts, 8)
    for i in range(6):
        assert results[i].tokens == refs[i]


def test_router_deadline_is_end_to_end(fleet_cleanup):
    rep = ReplicaServer(_engine(), replica_id="dl").start()
    fleet_cleanup.append(rep)
    rep.drain()
    router = Router([rep.url], scrape_interval_s=0, timeout_s=HOP_S,
                    retries=10, backoff_s=0.05, backoff_max_s=0.05)
    with pytest.raises(PermanentError, match="exhausted"):
        router.generate(_prompts(1)[0].tolist(), max_new_tokens=4,
                        deadline_s=0.15, request_id="dl-1")


def _payloads():
    rng = np.random.RandomState(17)
    out = []
    for i in range(12):
        out.append({"max_batch": int(rng.choice([0, 1, 4, 8])) or None,
                    "queue_depth": int(rng.randint(0, 9)),
                    "running": int(rng.randint(0, 5)),
                    "waiting_handoffs": int(rng.randint(0, 3)),
                    "kv_utilization": float(rng.rand()),
                    "state": str(rng.choice(["ready", "draining",
                                             "ready", "down"])),
                    "role": str(rng.choice(["both", "prefill",
                                            "decode"])),
                    "model": [None, "m1"][i % 2],
                    "adapters": {"ids": ["a1"]} if i % 3 == 0 else None,
                    "replica": f"n{i}"})
    return out


def test_router_load_score_and_pick_match_reference():
    """On the same scrape payloads the two routers score every replica
    the same and pick the same one, for every filter the pick has."""
    payloads = _payloads()
    for sec in payloads:
        assert Router._load_score(sec) == \
            ref_fleet.Router._load_score(sec)
    urls = [f"http://127.0.0.1:{9000 + i}" for i in range(len(payloads))]
    routers = {"port": Router(urls, scrape_interval_s=0),
               "ref": ref_fleet.Router(urls, scrape_interval_s=0)}
    for r in routers.values():
        for state, sec in zip(r._replicas, payloads):
            state.state = sec["state"]
            state.role = sec["role"]
            state.model = sec["model"]
            state.adapters = (list(sec["adapters"]["ids"])
                              if sec["adapters"] else None)
            state.load = r._load_score(sec)
            state.name = sec["replica"]
    weights = {urls[3]: 0.7, urls[5]: 0.2}
    for want in (None, "prefill", "decode"):
        for model in (None, "m1"):
            for adapter in (None, "a1"):
                for w in (None, weights):
                    for exclude in (set(), {urls[0], urls[2]}):
                        picks = [r._pick(set(exclude), want=want, weights=w,
                                         model=model, adapter=adapter)
                                 for r in (routers["port"],
                                           routers["ref"])]
                        names = [p.name if p is not None else None
                                 for p in picks]
                        assert names[0] == names[1], (want, model,
                                                      adapter, w)
    for r in routers.values():
        r.stop()


def test_supervisor_crash_restart_with_backoff(fleet_cleanup):
    clock = {"now": 0.0}
    spawned = []

    def spawn(slot):
        rep = ReplicaServer(_engine(),
                            replica_id=f"s{slot}-{len(spawned)}").start()
        fleet_cleanup.append(rep)
        spawned.append(rep)
        return InProcHandle(rep)

    sup = Supervisor(spawn, 1, restart_backoff_s=1.0,
                     restart_backoff_max_s=8.0,
                     clock=lambda: clock["now"], sleep=lambda s: None)
    sup.start()
    assert len(spawned) == 1
    assert sup.check() == []
    spawned[-1].hard_stop()
    assert sup.check() == [0]
    assert len(spawned) == 2
    spawned[-1].hard_stop()
    assert sup.check() == []
    clock["now"] = 1.1
    with sup._lock:
        sup._rolling.add(0)
    assert sup.check() == []
    with sup._lock:
        sup._rolling.discard(0)
    assert sup.check() == [0]
    assert len(spawned) == 3
    with sup._lock:
        assert sup._restarts[0] == 2
    sup.note_healthy(0)
    with sup._lock:
        assert sup._restarts[0] == 0
    sup.stop()


def test_supervisor_pool_resize_and_later_items(fleet_cleanup):
    """``add_slot`` / ``remove_slot`` follow the router; the catalog
    rebalancer and the A14b-3 names refuse with their item."""
    def spawn(slot):
        rep = ReplicaServer(_engine(), replica_id=f"p{slot}").start()
        fleet_cleanup.append(rep)
        return InProcHandle(rep)

    router = Router([], scrape_interval_s=0)
    sup = Supervisor(spawn, 1, router=router, drain_timeout_s=10)
    sup.start()
    slot = sup.add_slot()
    assert slot == 1 and sup.pool_size() == 2
    assert len(router.replicas()) == 2
    assert sup.remove_slot(0) and sup.pool_size() == 1
    assert [r.url for r in router.replicas()] == sup.urls()
    assert not sup.remove_slot(0)
    with pytest.raises(NotImplementedError, match="14b-3"):
        sup.rebalance_catalog()
    with pytest.raises(NotImplementedError, match="14b-3"):
        Supervisor(spawn, 1, catalog=object())
    for name, item in (("Autoscaler", "14b-3"), ("Deployer", "14b-3"),
                       ("CatalogRebalancer", "14b-3"),
                       ("parse_autoscale_spec", "14b-3")):
        with pytest.raises(NotImplementedError, match=item):
            getattr(mt.fleet, name)
    cmd = mt.fleet.supervisor.replica_command(7, ["--device", "cpu"])
    assert cmd[1:] == ["-m", "mxnet_tpu_torch.fleet.serve_replica",
                       "--port", "7", "--device", "cpu"]
    sup.stop()


def test_kill_fault_fires_even_on_dedup_cache_hit(fleet_cleanup):
    rep = ReplicaServer(_engine(), replica_id="kd",
                        fault_injector=FaultInjector("kill@2")).start()
    fleet_cleanup.append(rep)
    prompt = _prompts(1, seed=71)[0].tolist()
    code, out = http_post(rep.url, "/generate",
                          {"prompt": prompt, "max_new_tokens": 4,
                           "request_id": "same-id"})
    assert code == 200
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        http_post(rep.url, "/generate",
                  {"prompt": prompt, "max_new_tokens": 4,
                   "request_id": "same-id"})
    assert rep.state == DEAD


def test_prestamped_trace_id_rejection_still_writes_jsonl(tmp_path,
                                                          monkeypatch):
    trace_file = tmp_path / "trace.jsonl"
    monkeypatch.setenv("MXTPU_REQUEST_TRACE", str(trace_file))
    eng = _engine()
    req = eng.submit([1] * 60, max_new_tokens=30,
                     trace_id="fleet-prestamp")
    assert req.status == "rejected"
    assert req.reject_reason == "exceeds_max_len"
    eng.shutdown()
    lines = [json.loads(ln) for ln in
             trace_file.read_text().splitlines() if ln.strip()]
    assert len(lines) == 1
    assert lines[0]["trace_id"] == "fleet-prestamp"
    assert lines[0]["status"] == "rejected"
    assert [e["ev"] for e in lines[0]["events"]] == \
        ["submitted", "rejected"]


def test_telemetry_healthz_endpoint_is_cheap():
    from mxnet_tpu_torch import telemetry

    calls = {"statusz": 0}
    sname = statusz.register("expensive.provider",
                             lambda: calls.__setitem__(
                                 "statusz", calls["statusz"] + 1) or {})
    hname = statusz.register_health("unit.h", lambda: {"status": "ok",
                                                       "n": 1})
    server = telemetry.serve_http(telemetry.registry(), 0)
    try:
        port = server.server_address[1]
        hz = http_get(f"http://127.0.0.1:{port}", "/healthz")
        assert hz["status"] == "ok"
        assert hz["checks"]["unit.h"]["n"] == 1
        assert calls["statusz"] == 0
        statusz.register_health("unit.drain",
                                lambda: {"status": "draining"})
        hz = http_get(f"http://127.0.0.1:{port}", "/healthz")
        assert hz["status"] == "draining"
        statusz.register_health("unit.broken", lambda: 1 / 0)
        hz = http_get(f"http://127.0.0.1:{port}", "/healthz")
        assert hz["checks"]["unit.broken"]["status"] == "error"
    finally:
        statusz.unregister(sname)
        statusz.unregister_health(hname)
        statusz.unregister_health("unit.drain")
        statusz.unregister_health("unit.broken")
        server.shutdown()


def test_trace_stitching_groups_by_trace_id(tmp_path, monkeypatch,
                                            fleet_cleanup):
    """The router's line and the replica's line of one routed request
    share its trace id, and ``tools/trace_report.py --stitch`` groups
    them as one two-hop request."""
    monkeypatch.setenv("MXTPU_REQUEST_TRACE", str(tmp_path / "t.jsonl"))
    sys.path.insert(0, os.path.join(fx.REPO, "tools"))
    import trace_report

    rep = ReplicaServer(_engine(), replica_id="tr").start()
    fleet_cleanup.append(rep)
    router = Router([rep.url], scrape_interval_s=0, timeout_s=HOP_S)
    router.scrape()
    res = router.generate(_prompts(1, seed=3)[0].tolist(),
                          max_new_tokens=4, trace_id="stitch-1")
    rep.stop()
    router.stop()
    lines = [json.loads(ln) for ln in
             (tmp_path / "t.jsonl").read_text().splitlines() if ln.strip()]
    hops = [ln for ln in lines if ln.get("trace_id") == res.trace_id]
    assert sorted(h.get("replica") for h in hops) == ["router", "tr"]
    s = trace_report.stitch([(h, {}, h["status"], None, True)
                             for h in hops])
    assert s["requests"] == 1 and s["multi_hop"] == 1
    assert s["max_hops"] == 2 and s["unresolved"] == []


def test_replica_and_fleet_env_knobs_documented():
    """Every ``MXTPU_*`` knob the port's fleet reads has a row in
    docs/env_vars.md, and ROADMAP names its family."""
    import re

    src = ""
    fdir = os.path.join(fx.REPO, "mxnet_tpu_torch", "fleet")
    for name in sorted(os.listdir(fdir)):
        if name.endswith(".py"):
            with open(os.path.join(fdir, name)) as f:
                src += f.read()
    knobs = set(re.findall(r'"(MXTPU_[A-Z0-9_]+)"', src))
    assert {"MXTPU_FAULT_SPEC", "MXTPU_FLEET_ROLE", "MXTPU_FLEET_TIMEOUT",
            "MXTPU_ROUTE_AFFINITY", "MXTPU_PROFILEZ_DIR"} <= knobs
    with open(os.path.join(fx.REPO, "docs", "env_vars.md")) as f:
        doc = f.read()
    for var in sorted(knobs):
        assert var in doc, f"{var} missing from docs/env_vars.md"
    with open(os.path.join(fx.REPO, "ROADMAP.md")) as f:
        roadmap = f.read()
    for family in ("MXTPU_FLEET_*", "MXTPU_ROUTE_*", "MXTPU_FAULT_SPEC",
                   "MXTPU_PROFILEZ_*"):
        assert family in roadmap, family


# -- the process front --------------------------------------------------------
class _Args:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_process_front_draws_the_reference_front_weights():
    """``build_model`` draws the reference front's weights value for
    value: same names, order, shapes and float32 bytes."""
    sys.path.insert(0, os.path.join(fx.REPO, "tools"))
    import mxnet_tpu as mx
    import serve_replica as ref_front

    from mxnet_tpu_torch.fleet import serve_replica as port_front

    args = _Args(max_model_len=32, kv_heads=None, vocab=61, layers=2,
                 d_model=32, heads=4, seed=5)
    _, ref = ref_front.build_model(mx, args)
    cfg, port = port_front.build_model(args)
    assert cfg["kv_heads"] == 1
    assert list(port) == list(ref)
    for name in ref:
        assert port[name].dtype == np.float32
        assert port[name].tobytes() == ref[name].tobytes(), name


def test_process_front_subprocess_ready_generate_sigterm(tmp_path):
    """``python -m mxnet_tpu_torch.fleet.serve_replica --device cpu``:
    its ready line, a ``/generate`` equal to an in-process engine's on
    the same draw, a clean SIGTERM exit, and not one ``jax`` or
    reference module imported (``-X importtime`` lists them all)."""
    from mxnet_tpu_torch.fleet import serve_replica as port_front

    flags = ["--layers", "1", "--d-model", "32", "--heads", "4",
             "--vocab", "61", "--max-model-len", "32", "--seed", "2"]
    err = open(tmp_path / "stderr.txt", "w")
    env = dict(os.environ, PYTHONPATH=fx.REPO)
    for var in ("MXTPU_FAULT_SPEC", "MXTPU_WARMUP_MANIFEST",
                "MXTPU_AOT_DIR", "MXTPU_FLEET_ROLE"):
        env.pop(var, None)
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m",
         "mxnet_tpu_torch.fleet.serve_replica", "--device", "cpu"] + flags,
        stdout=subprocess.PIPE, stderr=err, text=True, cwd=fx.REPO,
        env=env)
    try:
        ready = {}
        t = threading.Thread(
            target=lambda: ready.update(json.loads(proc.stdout.readline())))
        t.start()
        t.join(timeout=120)
        assert ready.get("ready") is True, ready
        assert ready["backend"] == "cpu" and ready["device_name"] == "cpu"
        assert ready["role"] == "both" and ready["warmed"] == 0
        url = f"http://{ready['host']}:{ready['port']}"
        prompt = [3, 1, 4, 1, 5, 9, 2, 6]
        code, out = http_post(url, "/generate",
                              {"prompt": prompt, "max_new_tokens": 5})
        assert code == 200
        cfg, params = port_front.build_model(
            port_front.parse_args(flags))
        eng = mt.serve.Engine(params, num_heads=cfg["num_heads"],
                              device="cpu", block_size=8, num_blocks=128,
                              max_batch=4, max_model_len=32,
                              max_prefills_per_step=2)
        req = eng.submit(np.asarray(prompt, np.int32), max_new_tokens=5)
        eng.run()
        eng.shutdown()
        assert out["tokens"] == list(req.tokens)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()
    loaded = [ln.rsplit("|", 1)[-1].strip()
              for ln in (tmp_path / "stderr.txt").read_text().splitlines()
              if ln.startswith("import time:") and "|" in ln]
    assert "mxnet_tpu_torch.fleet" in loaded
    bad = [m for m in loaded
           if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes")
           or m == "mxnet_tpu" or m.startswith("mxnet_tpu.")]
    assert bad == []


def test_process_front_refuses_aot_dir(monkeypatch):
    from mxnet_tpu_torch.fleet import serve_replica as port_front

    monkeypatch.setenv("MXTPU_AOT_DIR", "/nonexistent")
    with pytest.raises(NotImplementedError, match="item 12"):
        port_front.main(["--device", "cpu"])
