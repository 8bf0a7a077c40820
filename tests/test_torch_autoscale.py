"""The PyTorch port's fleet control plane against the JAX reference
(``mxnet_tpu_torch/fleet/autoscaler.py`` and ``deploy.py``).

Ports ``tests/test_autoscale.py`` case by case, in two tiers:

* policy: the spec grammar through both packages'
  ``parse_autoscale_spec`` (equal results, the same errors), and every
  policy scenario of the reference's file as a scripted timeline run
  through both packages' ``Autoscaler`` with a fixed clock, a fake
  collector and fake pools: the same actions at every step, the same
  pools, timeline notes, counters and ``statusz``;
* fleet: real ``ReplicaServer`` HTTP fronts over port engines on the CPU
  pin ``Supervisor.replace_slot`` (also a crash during it),
  ``add_slot``/``remove_slot`` retirement, the deployer's token-parity
  gate (pass, and a rollback on other weights: seed 3 against seed 11),
  a rollback on an SLO burn, a mixed-version fleet, and the knobs'
  documentation.  The canary signatures of port replicas equal those of
  reference replicas fed the same numpy params (float32).
"""

import os
import threading
import time

import pytest

import torch_port_fixtures as fx
from torch_port_fixtures import (  # noqa: F401  (autouse / fixtures)
    InProcHandle, collect_engines_after_module, fleet_cleanup,
    fresh_telemetry_per_module, http_get)

import mxnet_tpu as mx
import mxnet_tpu.fleet as ref_fleet
import mxnet_tpu.telemetry as ref_tel
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.telemetry as port_tel
from mxnet_tpu_torch.fleet import (Autoscaler, Deployer, FleetCollector,
                                   ReplicaServer, Router, Supervisor,
                                   parse_autoscale_spec)

PACKAGES = {"ref": (ref_fleet, ref_tel), "port": (mt.fleet, port_tel)}


@pytest.fixture
def tel():
    """Both packages' telemetry on and empty for one test."""
    for t in (ref_tel, port_tel):
        t.reset()
        t.enable()
    yield port_tel.registry()
    for t in (ref_tel, port_tel):
        t.disable()
        t.reset()


def _samples(registry, name):
    snap = registry.snapshot()
    return sorted((tuple(sorted(s["labels"].items())), s["value"])
                  for s in snap.get(name, {}).get("samples", ()))


# -- spec grammar -------------------------------------------------------------
SPECS = ["prefill=1:4;decode=1:8;up_queue=16;down_idle_s=30", "both=2:2",
         "both=2:4;up_queue=1.5;down_idle_s=4;cooldown_s=2",
         " decode = 0:3 ; up_kv=0.5;;up_host_kv=0.9 ", "prefill=0:0",
         "both=1:2;up_handoffs=0;cooldown_s=0"]
BAD_SPECS = ["prefill=4:1", "prefill=1", "replica=1:2", "up_queue=-3",
             "prefill=1:2;prefill=1:3", "up_queue=16", "prefill=a:b", "wat",
             "", "both=", "both=-1:2", "up_queue=x;both=1:2", "both=1:2:3"]


@pytest.mark.parametrize("spec", SPECS + BAD_SPECS)
def test_autoscale_spec_parses_as_reference(spec):
    def parse(pkg):
        try:
            return pkg.parse_autoscale_spec(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    got, want = parse(mt.fleet), parse(ref_fleet)
    assert got == want
    if spec in BAD_SPECS:
        assert got[0] == "ValueError"


def test_autoscale_spec_grammar():
    cfg = parse_autoscale_spec(
        "prefill=1:4;decode=1:8;up_queue=16;down_idle_s=30")
    assert cfg["bounds"] == {"prefill": (1, 4), "decode": (1, 8)}
    assert cfg["up_queue"] == 16.0 and cfg["down_idle_s"] == 30.0
    assert cfg["up_handoffs"] == 4.0 and cfg["cooldown_s"] == 15.0
    with pytest.raises(ValueError, match="no autoscale spec"):
        Autoscaler(_FakeCollector(), _FakePool(1), spec=None)
    with pytest.raises(ValueError, match="no such pool"):
        Autoscaler(_FakeCollector(), {"both": _FakePool(1)},
                   spec="decode=1:2")


# -- policy-test fakes (the reference file's) ---------------------------------
class _FakePool:
    """Actuator stub: real pool bookkeeping, no spawning."""

    def __init__(self, n=1):
        self.slots = list(range(n))
        self._next = n
        self.added = []
        self.removed = []

    def pool_size(self):
        return len(self.slots)

    def active_slots(self):
        return list(self.slots)

    def add_slot(self, factory=None):
        slot = self._next
        self._next += 1
        self.slots.append(slot)
        self.added.append(slot)
        return slot

    def remove_slot(self, slot):
        self.slots.remove(slot)
        self.removed.append(slot)
        return True


class _CatalogPool(_FakePool):
    """A pool with the supervisor's catalog actuator: a scale-up must
    trigger one rebalance pass."""

    def __init__(self, n=1):
        super().__init__(n)
        self.rebalances = []

    def rebalance_catalog(self, reason="manual"):
        self.rebalances.append(reason)
        return []


class _FakeCollector:
    def __init__(self):
        self.roles = {}
        self.slo = None
        self.slo_section = None
        self.notes = []

    def fleet_view(self):
        return {"roles": self.roles, "slo": self.slo_section}

    def annotate(self, kind, **fields):
        self.notes.append(dict(kind=kind, **fields))


def _agg(replicas=1, stale=0, queue=0, running=0, handoffs=0, kv=None,
         hkv=None):
    return {"replicas": replicas, "stale": stale, "queue_depth": queue,
            "running": running, "waiting_handoffs": handoffs,
            "kv_utilization_mean": kv, "host_kv_utilization_mean": hkv}


_TTFT_FIRING = {"objectives": [{"objective": "ttft_p99_ms",
                                "firing": True}]}

# Each scenario of tests/test_autoscale.py:214-367 as data: the pools
# (role -> size), the spec, and a timeline of steps.  A step sets the
# clock, the role aggregates and the SLO section (each kept until a later
# step sets it), optionally shrinks a pool out of band, then evaluates.
_FLAP = [dict(t=i * 0.5, roles={"both": _agg(1, queue=50) if i % 2 == 0
                                else _agg(1)}) for i in range(20)]
SCENARIOS = {
    "scale_up_on_queue_step": dict(
        pools={"prefill": 1}, spec="prefill=1:4;up_queue=16",
        steps=[dict(t=0.0, roles={"prefill": _agg(1, queue=3)}),
               dict(t=0.0, roles={"prefill": _agg(1, queue=40)}),
               dict(t=20.0, roles={"prefill": _agg(2, queue=40)})]),
    "scale_down_only_after_quiet_windows": dict(
        pools={"both": 3}, spec="both=1:4;down_idle_s=30;cooldown_s=5",
        steps=[dict(t=t, roles={"both": _agg(3)})
               for t in (0.0, 29.0, 31.0, 36.0, 60.0, 67.0, 200.0)]),
    "hysteresis_flapping_load": dict(
        pools={"both": 1}, spec="both=1:8;up_queue=4;cooldown_s=10",
        steps=_FLAP + [dict(t=10.5, roles={"both": _agg(1, queue=50)})]),
    "per_role_independence_and_decode_signals": dict(
        pools={"prefill": 1, "decode": 1},
        spec="prefill=1:4;decode=1:4;up_queue=8;up_handoffs=4;cooldown_s=0",
        steps=[dict(t=0.0, roles={"prefill": _agg(1, queue=100),
                                  "decode": _agg(1)}),
               dict(t=1.0, roles={"prefill": _agg(2),
                                  "decode": _agg(1, handoffs=9)}),
               dict(t=2.0, roles={"prefill": _agg(2),
                                  "decode": _agg(2, hkv=0.95)}),
               dict(t=3.0, roles={"prefill": _agg(2),
                                  "decode": _agg(3, queue=100)}),
               dict(t=4.0, roles={"prefill": _agg(2),
                                  "decode": _agg(3, kv=0.9)})]),
    "min_max_bounds_and_burn_signals": dict(
        pools={"both": 2}, spec="both=1:2;cooldown_s=0",
        steps=[dict(t=0.0, roles={"both": _agg(2, queue=500)}),
               dict(t=0.0, roles={"both": _agg(2)}, slo=_TTFT_FIRING),
               dict(t=0.0, shrink={"both": [0]}),
               dict(t=1000.0, roles={"both": _agg(2)}),
               dict(t=1001.0, slo={"objectives": [
                   {"objective": "tpot_p99_ms", "firing": True}]}),
               dict(t=1002.0, slo=None)]),
    "below_min_restored_without_aggregates": dict(
        pools={"both": 0}, spec="both=1:2;cooldown_s=0",
        steps=[dict(t=0.0), dict(t=1.0)]),
    "never_scales_on_stale_aggregates": dict(
        pools={"both": 2}, spec="both=1:4;down_idle_s=1;cooldown_s=0",
        steps=[dict(t=t, roles={"both": _agg(2, stale=2, queue=500)})
               for t in (0.0, 5.0, 50.0)]),
    "scale_up_triggers_catalog_pass": dict(
        pools={"both": 1}, spec="both=1:3;up_queue=2;cooldown_s=1",
        catalog=True,
        steps=[dict(t=0.0, roles={"both": _agg(1, queue=5)}),
               dict(t=0.5, roles={"both": _agg(2, queue=9)}),
               dict(t=2.0, roles={"both": _agg(2, queue=9)})]),
}


def _run_scenario(pkg, tel_mod, sc):
    tel_mod.reset()                 # the counters of this run alone
    tel_mod.enable()
    col = _FakeCollector()
    pool_cls = _CatalogPool if sc.get("catalog") else _FakePool
    pools = {role: pool_cls(n) for role, n in sc["pools"].items()}
    clock = {"now": 0.0}
    a = pkg.Autoscaler(col, pools, spec=sc["spec"],
                       clock=lambda: clock["now"])
    trace = []
    for step in sc["steps"]:
        clock["now"] = step["t"]
        if "roles" in step:
            col.roles = step["roles"]
        if "slo" in step:
            col.slo_section = step["slo"]
        for role, slots in step.get("shrink", {}).items():
            pools[role].slots = list(slots)
        acts = a.evaluate()
        trace.append((step["t"], acts,
                      {r: list(p.slots) for r, p in pools.items()}))
    return {"trace": trace, "statusz": a.statusz(), "notes": col.notes,
            "added": {r: p.added for r, p in pools.items()},
            "removed": {r: p.removed for r, p in pools.items()},
            "rebalances": {r: getattr(p, "rebalances", None)
                           for r, p in pools.items()},
            "events": _samples(tel_mod.registry(),
                               "mxtpu_fleet_scale_events_total")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_scenario_matches_reference(name, tel):
    sc = SCENARIOS[name]
    got = _run_scenario(mt.fleet, port_tel, sc)
    want = _run_scenario(ref_fleet, ref_tel, sc)
    assert got == want
    assert any(acts for _, acts, _ in got["trace"]) or name.startswith(
        "never_scales")


def test_policy_scenarios_pin_the_reference_decisions(tel):
    """The reference file's own expectations, on the port's runs."""
    def actions(name):
        return [acts for _, acts, _ in _run_scenario(
            mt.fleet, port_tel, SCENARIOS[name])["trace"]]

    assert actions("scale_up_on_queue_step") == [
        [], [("prefill", "up", "queue")], [("prefill", "up", "queue")]]
    down = _run_scenario(mt.fleet, port_tel,
                         SCENARIOS["scale_down_only_after_quiet_windows"])
    assert [a for _, a, _ in down["trace"]] == [
        [], [], [("both", "down", "idle")], [], [],
        [("both", "down", "idle")], []]
    assert down["removed"] == {"both": [2, 1]}   # newest slots first
    flap = actions("hysteresis_flapping_load")
    assert sum(len(a) for a in flap[:20]) == 1 and flap[20] == [
        ("both", "up", "queue")]
    assert actions("per_role_independence_and_decode_signals") == [
        [("prefill", "up", "queue")], [("decode", "up", "handoffs")],
        [("decode", "up", "host_kv")], [], [("decode", "up", "kv")]]
    assert actions("min_max_bounds_and_burn_signals")[:4] == [
        [], [], [("both", "up", "ttft_burn")], []]
    assert actions("below_min_restored_without_aggregates")[0] == [
        ("both", "up", "min_bound")]
    assert not any(actions("never_scales_on_stale_aggregates"))
    cat = _run_scenario(mt.fleet, port_tel,
                        SCENARIOS["scale_up_triggers_catalog_pass"])
    assert cat["rebalances"] == {"both": ["scale_up_both",
                                          "scale_up_both"]}
    assert [n["kind"] for n in cat["notes"]] == ["autoscale", "autoscale"]
    key = (("direction", "up"), ("reason", "queue"), ("role", "both"))
    assert cat["events"] == [(key, 2.0)]


class _BrokenCollector(_FakeCollector):
    def fleet_view(self):
        raise OSError("scrape failed")


@pytest.mark.parametrize("side", sorted(PACKAGES))
def test_background_loop_counts_errors_and_stops(side, tel):
    """``start`` pumps ``evaluate``; a failing pass is counted, never
    fatal; ``stop`` joins the loop (both packages)."""
    pkg, tel_mod = PACKAGES[side]
    a = pkg.Autoscaler(_BrokenCollector(), {"both": _FakePool(1)},
                       spec="both=1:2", interval_s=0.01)
    assert a.start() is a and a.start() is a       # idempotent
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not _samples(
            tel_mod.registry(), "mxtpu_fleet_autoscaler_errors_total"):
        time.sleep(0.01)
    a.stop()
    assert a._loop is None
    errors = _samples(tel_mod.registry(),
                      "mxtpu_fleet_autoscaler_errors_total")
    assert errors and errors[0][1] >= 1.0
    assert not any(t.name == "mxtpu-fleet-autoscaler"
                   and t.is_alive() for t in threading.enumerate())


# -- fleet tests: real replicas over port engines -----------------------------
def _params_b():
    """Same architecture, DIFFERENT weights (seed 11): the "new
    checkpoint that is not the weights it claims to be"."""
    return fx.ref_params(fx.ref_net("gpt2"), seed=11)


def _port_engine(params=None):
    if params is None:
        return fx.fleet_engine()
    return mt.serve.Engine(params, num_heads=fx.VARIANTS["gpt2"]["num_heads"],
                           device="cpu", **fx.FLEET_ENGINE_KW)


def _factory(fleet_cleanup, version, params=None):
    """spawn(slot) -> in-process port replica handle tagged ``version``."""
    def spawn(slot):
        rep = ReplicaServer(_port_engine(params),
                            replica_id=f"{version}-s{slot}",
                            version=version).start()
        fleet_cleanup.append(rep)
        return InProcHandle(rep)
    return spawn


def test_collector_stale_row_drops_load_signals(fleet_cleanup):
    rep = ReplicaServer(_port_engine(), replica_id="r0",
                        version="v1").start()
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
    clock["now"] = 10.0
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


def test_replace_slot_swaps_factory_and_router_membership(fleet_cleanup,
                                                          tel):
    old = _factory(fleet_cleanup, "v1")
    new = _factory(fleet_cleanup, "v2")
    col = FleetCollector(urls=[], interval_s=0)
    fleet_cleanup.append(col)
    router = Router([], scrape_interval_s=0)
    fleet_cleanup.append(router)
    sup = Supervisor(old, 1, drain_timeout_s=10, router=router,
                     collector=col)
    fleet_cleanup.append(sup)
    sup.start()
    old_url = sup.urls()[0]
    assert http_get(old_url, "/healthz")["version"] == "v1"
    handle = sup.replace_slot(0, new, reason="deploy")
    assert handle.url != old_url
    assert http_get(handle.url, "/healthz")["version"] == "v2"
    assert http_get(handle.url, "/statusz.json")["replica"]["version"] \
        == "v2"
    assert [r.url for r in router.replicas()] == [handle.url]
    phases = [a["phase"] for a in col.annotations()
              if a["kind"] == "deploy_replace_slot"]
    assert phases == ["drain", "terminate", "respawned"]
    reasons = {dict(k)["reason"]: v for k, v in
               _samples(port_tel.registry(), "mxtpu_fleet_restarts_total")}
    assert reasons == {"deploy": 1}


def test_replace_slot_crash_during_replace(fleet_cleanup):
    old = _factory(fleet_cleanup, "v1")
    new = _factory(fleet_cleanup, "v2")
    sup = Supervisor(old, 1, drain_timeout_s=10)
    fleet_cleanup.append(sup)
    sup.start()
    sup.handles()[0].replica.hard_stop()      # crash
    handle = sup.replace_slot(0, new, reason="deploy")
    assert handle is not None
    assert http_get(handle.url, "/healthz")["version"] == "v2"
    assert len(sup.urls()) == 1               # no double spawn


def test_add_remove_slot_retires_indices(fleet_cleanup):
    spawn = _factory(fleet_cleanup, "v1")
    router = Router([], scrape_interval_s=0)
    fleet_cleanup.append(router)
    sup = Supervisor(spawn, 1, drain_timeout_s=10, router=router)
    fleet_cleanup.append(sup)
    sup.start()
    assert sup.add_slot() == 1
    assert sup.pool_size() == 2 and len(router.replicas()) == 2
    assert sup.remove_slot(1) is True
    assert sup.pool_size() == 1 and len(router.replicas()) == 1
    assert sup.active_slots() == [0]
    assert sup.remove_slot(1) is False        # already retired
    assert sup.check() == []                  # monitor skips retired
    assert sup.add_slot() == 2                # indices never reused
    assert sup.pool_size() == 2
    assert len(sup.rolling_restart()) == 2    # active slots only


def _counter(name):
    return sum(v for _, v in _samples(port_tel.registry(), name))


def test_rolling_deploy_parity_gate_pass(fleet_cleanup, tel):
    old = _factory(fleet_cleanup, "v1")
    new = _factory(fleet_cleanup, "v2")      # same weights, new tag
    sup = Supervisor(old, 2, drain_timeout_s=10)
    fleet_cleanup.append(sup)
    sup.start()
    dep = Deployer(sup)                       # bare sup -> {"both": sup}
    ref = dep.probe(sup.urls()[0], "both")
    report = dep.rollout(new, version="v2")
    assert report["status"] == "ok" and report["reason"] is None
    assert report["replaced"] == 2 and report["rolled_back"] == 0
    assert report["refs"] == {"both": 3}
    for url in sup.urls():
        assert http_get(url, "/healthz")["version"] == "v2"
        assert dep.probe(url, "both") == ref  # weight reload: parity
    assert _counter("mxtpu_deploy_slots_replaced_total") == 2.0
    assert _counter("mxtpu_deploy_rollbacks_total") == 0.0


def test_rolling_deploy_parity_failure_rolls_back(fleet_cleanup, tel):
    old = _factory(fleet_cleanup, "v1")
    bad = _factory(fleet_cleanup, "v2", _params_b())  # other weights
    sup = Supervisor(old, 2, drain_timeout_s=10)
    fleet_cleanup.append(sup)
    sup.start()
    dep = Deployer(sup)
    ref = dep.probe(sup.urls()[0], "both")
    report = dep.rollout(bad, version="v2", old_factory=old)
    assert report["status"] == "rolled_back"
    assert report["reason"] == "parity"
    assert report["replaced"] == 1            # the first slot failed
    assert report["rolled_back"] == 1
    assert sup.pool_size() == 2
    for url in sup.urls():
        assert http_get(url, "/healthz")["version"] == "v1"
        assert dep.probe(url, "both") == ref
    assert _counter("mxtpu_deploy_rollbacks_total") == 1.0


class _FiringSLO:
    def __init__(self):
        self.firing = False

    def statusz(self):
        return {"objectives": [{"objective": "ttft_p99_ms",
                                "firing": self.firing}]}


def test_rolling_deploy_rollback_on_slo_burn(fleet_cleanup, tel):
    old = _factory(fleet_cleanup, "v1")
    new = _factory(fleet_cleanup, "v2")
    col = FleetCollector(urls=[], interval_s=0)
    fleet_cleanup.append(col)
    col.slo = _FiringSLO()
    sup = Supervisor(old, 2, drain_timeout_s=10, collector=col)
    fleet_cleanup.append(sup)
    sup.start()
    dep = Deployer(sup, collector=col)
    col.slo.firing = True                     # the fleet is burning
    report = dep.rollout(new, version="v2", old_factory=old)
    assert report["status"] == "rolled_back"
    assert report["reason"] == "slo_burn"
    for url in sup.urls():
        assert http_get(url, "/healthz")["version"] == "v1"
    kinds = [a["kind"] for a in col.annotations()]
    assert "deploy_rollback" in kinds
    phases = [a.get("phase") for a in col.annotations()
              if a["kind"] == "deploy_rollout"]
    assert phases == ["start", "done"]


def test_rolling_deploy_probe_error_and_spawn_failure(fleet_cleanup, tel):
    """An unanswerable replacement (a replica stopped before its probe)
    rolls back as ``probe_error``; a factory giving no url as
    ``spawn_failed`` (the reference's other two triggers)."""
    old = _factory(fleet_cleanup, "v1")
    live_new = _factory(fleet_cleanup, "v2")

    def dead_on_arrival(slot):
        h = live_new(slot)
        h.replica.stop()
        return h

    class _NoUrl:
        url = None

        def poll(self):
            return 1

        def terminate(self, grace_s=None):
            pass

    for factory, reason in ((dead_on_arrival, "probe_error"),
                            (lambda slot: _NoUrl(), "spawn_failed")):
        sup = Supervisor(old, 1, drain_timeout_s=10)
        fleet_cleanup.append(sup)
        sup.start()
        report = Deployer(sup, probe_timeout_s=5).rollout(
            factory, version="v2", old_factory=old)
        assert (report["status"], report["reason"]) == ("rolled_back",
                                                        reason)
        assert http_get(sup.urls()[0], "/healthz")["version"] == "v1"


def test_mixed_version_fleet_routes_and_surfaces_versions(fleet_cleanup):
    r1 = ReplicaServer(_port_engine(), replica_id="old-r",
                       version="v1").start()
    r2 = ReplicaServer(_port_engine(), replica_id="new-r",
                       version="v2").start()
    fleet_cleanup += [r1, r2]
    router = Router([r1.url, r2.url], scrape_interval_s=0)
    fleet_cleanup.append(router)
    col = FleetCollector(urls=[r1.url, r2.url], interval_s=0)
    fleet_cleanup.append(col)
    col.scrape()
    view = col.fleet_view()
    rows = {r["replica"]: r for r in view["replicas"]}
    assert rows["old-r"]["version"] == "v1"
    assert rows["new-r"]["version"] == "v2"
    assert view["roles"]["both"]["versions"] == {"v1": 1, "v2": 1}
    dep = Deployer({"both": None}, canary_max_new=6)
    assert dep.probe(r1.url, "both") == dep.probe(r2.url, "both")
    prompts = fx.prompts(6, seed=5, lo=7, hi=8)
    for i, p in enumerate(prompts):
        res = router.generate(p.tolist(), max_new_tokens=5,
                              request_id=f"mix-{i}")
        assert res.tokens


def test_canary_tokens_equal_reference_replicas(fleet_cleanup):
    """float32: each package's deployer probing its own replica over the
    same numpy params (seed 3, then seed 11) reads the same canary
    signature; the port's deployer reads a reference replica's too (the
    wire is shared), and the two checkpoints' signatures differ."""
    sigs = {}
    for seed, params in ((3, None), (11, _params_b())):
        port_rep = ReplicaServer(_port_engine(params), replica_id="p",
                                 version="v").start()
        ref_eng = (fx.ref_fleet_engine() if params is None else
                   mx.serve.Engine(params, symbol=fx.ref_net("gpt2"),
                                   **fx.FLEET_ENGINE_KW))
        ref_rep = ref_fleet.ReplicaServer(ref_eng, replica_id="r",
                                          version="v").start()
        fleet_cleanup += [port_rep, ref_rep]
        port_sig = Deployer({"both": None}).probe(port_rep.url, "both")
        ref_sig = ref_fleet.Deployer({"both": None}).probe(ref_rep.url,
                                                           "both")
        assert port_sig == ref_sig
        assert Deployer({"both": None}).probe(ref_rep.url, "both") \
            == ref_sig
        assert [len(s) for s in port_sig] == [8, 8, 8]
        sigs[seed] = port_sig
    assert sigs[3] != sigs[11]


@pytest.mark.parametrize("var,value,attr,want", [
    ("MXTPU_DEPLOY_CANARY_NEW", "5", "canary_max_new", 5),
    ("MXTPU_DEPLOY_PROBE_TIMEOUT", "2.5", "probe_timeout_s", 2.5),
    (None, None, "canary_max_new", 8),
    (None, None, "probe_timeout_s", 30.0)])
def test_deploy_knobs_are_honoured_as_the_reference(monkeypatch, var, value,
                                                    attr, want):
    if var:
        monkeypatch.setenv(var, value)
    else:
        monkeypatch.delenv("MXTPU_DEPLOY_CANARY_NEW", raising=False)
        monkeypatch.delenv("MXTPU_DEPLOY_PROBE_TIMEOUT", raising=False)
    port = getattr(Deployer({"both": None}), attr)
    assert port == getattr(ref_fleet.Deployer({"both": None}), attr) == want


def test_autoscale_spec_env_is_read_when_spec_is_none(monkeypatch):
    monkeypatch.setenv("MXTPU_AUTOSCALE_SPEC", "both=2:4;cooldown_s=3")
    a = Autoscaler(_FakeCollector(), _FakePool(2))
    b = ref_fleet.Autoscaler(_FakeCollector(), _FakePool(2))
    assert a.cfg == b.cfg and a.cfg["cooldown_s"] == 3.0
    assert a.statusz() == b.statusz()


def test_control_plane_env_knobs_documented():
    with open(os.path.join(fx.REPO, "docs", "env_vars.md")) as f:
        text = f.read()
    for var in ("MXTPU_AUTOSCALE_SPEC", "MXTPU_DEPLOY_CANARY_NEW",
                "MXTPU_DEPLOY_PROBE_TIMEOUT"):
        assert f"`{var}`" in text, var
    with open(os.path.join(fx.REPO, "ROADMAP.md")) as f:
        roadmap = f.read()
    for var in ("MXTPU_AUTOSCALE_SPEC", "MXTPU_DEPLOY_CANARY_NEW",
                "MXTPU_DEPLOY_PROBE_TIMEOUT"):
        assert var in roadmap, var


def test_a_slot_leaves_the_rotation_before_it_stops_or_respawns(
        fleet_cleanup):
    """``replace_slot`` and ``remove_slot`` take the slot's url out of
    the router's rotation when its drain starts, and a crash restart
    before its spawn: a connect to a stopped replica's port is not
    always refused (on the card's host it waited out the router's hop
    timeout), so nothing may be routed there once it stops."""
    router = Router([], scrape_interval_s=0)
    fleet_cleanup.append(router)
    seen = []                       # router membership at each event

    def members():
        return sorted(r.url for r in router.replicas())

    class Handle(InProcHandle):
        def terminate(self, grace_s=None):
            seen.append(("terminate", self.url in members()))
            super().terminate()

    def spawn(slot):
        seen.append(("spawn", [u for u in members()
                               if u in {h.url for h in sup.handles()
                                        if h is not None
                                        and h.replica.state == "dead"}]))
        rep = ReplicaServer(_port_engine(), replica_id=f"s{slot}").start()
        fleet_cleanup.append(rep)
        return Handle(rep)

    sup = Supervisor(spawn, 2, router=router, drain_timeout_s=10,
                     restart_backoff_s=0.0)
    fleet_cleanup.append(sup)
    sup.start()
    seen.clear()
    old = sup.handles()[0].url
    sup.replace_slot(0, reason="deploy")
    assert seen[0] == ("terminate", False)         # out before it stops
    assert old not in members() and len(members()) == 2
    sup.handles()[1].replica.hard_stop()           # a crash
    dead = sup.handles()[1].url
    seen.clear()
    assert sup.check() == [1]
    assert seen[0] == ("spawn", [])                # out before the spawn
    assert dead not in members() and len(members()) == 2
    seen.clear()
    assert sup.remove_slot(1)
    assert seen == [("terminate", False)]
    assert members() == [sup.handles()[0].url]
