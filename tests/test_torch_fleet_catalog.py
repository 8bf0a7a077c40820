"""The PyTorch port's catalog rebalancer against the JAX reference
(``mxnet_tpu_torch/fleet/catalog.py`` and ``Supervisor(catalog=)``).

Ports the rebalance cases of ``tests/test_fleet_catalog.py``
(``:264-349``): spread moves planned hot-first and applied under the
``max_moves`` cap with per-move failure isolation, the opt-in
``retire_idle`` policy, and the supervisor's ``rebalance_catalog``
actuator, on real ``ReplicaServer`` fronts over port engines with
adapters (CPU, float32).  Cross-package cases: ``plan()`` of both
packages on the same ``fleet_view`` dicts; a moved adapter serves the
tokens of a reference replica holding the same adapter; a reference
replica's export loads into a port replica.  Added: a 503
``adapter_pinned`` is reported, not retried; a failing pass is annotated
by the supervisor and never raised; the moves counter by outcome.
"""

import json
import urllib.error

import numpy as np
import pytest

import torch_port_fixtures as fx
from torch_port_fixtures import (  # noqa: F401  (autouse / fixtures)
    collect_engines_after_module, fleet_cleanup, fresh_telemetry_per_module,
    http_get, http_post)

import mxnet_tpu as mx
import mxnet_tpu.fleet as ref_fleet
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.telemetry as port_tel
from mxnet_tpu_torch.fleet import (CatalogRebalancer, FleetCollector,
                                   ReplicaServer, Supervisor)
from mxnet_tpu_torch.serve import adapters as port_adapters

RANK = 4
ALPHA = 8.0


def _lora(seed):
    """One adapter's ``{stem: (A, B)}`` over the fleet model's stems
    (the reference file's draw)."""
    _, params, _ = fx.model("gpt2")
    rng = np.random.RandomState(seed)
    out = {}
    for stem, (dout, din) in port_adapters.gpt_stems(
            "gpt", 2, False, False, params).items():
        out[stem] = ((rng.randn(RANK, din) * 0.1).astype(np.float32),
                     (rng.randn(dout, RANK) * 0.1).astype(np.float32))
    return out


def _adapter_replica(fleet_cleanup, rid, model_id, adapters=(), **kw):
    eng = fx.fleet_engine(adapters=4, adapter_rank=RANK)
    for j, aid in enumerate(adapters):
        eng.adapter_store.register(aid, _lora(40 + j), alpha=ALPHA)
    rep = ReplicaServer(eng, replica_id=rid, model=model_id, **kw).start()
    fleet_cleanup.append(rep)
    return rep


def _ref_adapter_replica(fleet_cleanup, rid, model_id, adapters=()):
    eng = fx.ref_fleet_engine(adapters=4, adapter_rank=RANK)
    for j, aid in enumerate(adapters):
        eng.adapter_store.register(aid, _lora(40 + j), alpha=ALPHA)
    rep = ref_fleet.ReplicaServer(eng, replica_id=rid,
                                  model=model_id).start()
    fleet_cleanup.append(rep)
    return rep


def _prompt(n=10, seed=7):
    rng = np.random.RandomState(seed)
    return rng.randint(0, fx.VOCAB, (n,)).astype(np.int32)


BODY = {"prompt": _prompt().tolist(), "max_new_tokens": 4}


def _moves(registry):
    snap = registry.snapshot()
    return {(s["labels"]["action"], s["labels"]["outcome"]): s["value"]
            for s in snap.get("mxtpu_fleet_catalog_moves_total",
                              {}).get("samples", ())}


# -- planning: both packages on the same views --------------------------------
def _row(url, model, adapters, stale=False):
    return {"url": url, "replica": url[-2:], "model": model,
            "adapters": adapters, "stale": stale}


VIEWS = {
    "spread_hot_first": {
        "replicas": [_row("http://h:01", "m", ["t0", "t1"]),
                     _row("http://h:02", "m", []),
                     _row("http://h:03", "m", ["t1"])],
        "models": {"m": {"adapter_goodput": {"t0": 3, "t1": 5}}}},
    "two_models_and_stale_and_off": {
        "replicas": [_row("http://h:01", "a", ["x"]),
                     _row("http://h:02", "a", []),
                     _row("http://h:03", "a", [], stale=True),
                     _row("http://h:04", "b", None),
                     _row("http://h:05", "b", ["y"]),
                     _row("http://h:06", "b", [])],
        "models": {"a": {"adapter_goodput": {"x": 1, "z": 4}},
                   "b": {"adapter_goodput": {"y": 2}},
                   "c": {"adapter_goodput": {"w": 9}}}},
    "zero_traffic_and_idle": {
        "replicas": [_row("http://h:01", "m", ["hot", "cold", "warm"]),
                     _row("http://h:02", "m", ["cold"])],
        "models": {"m": {"adapter_goodput": {"hot": 2, "warm": 0}}}},
    "empty": {"replicas": [], "models": {}},
}


@pytest.mark.parametrize("retire_idle", [False, True],
                         ids=["spread", "retire_idle"])
@pytest.mark.parametrize("name", sorted(VIEWS))
def test_plan_matches_reference(name, retire_idle):
    view = VIEWS[name]
    got = CatalogRebalancer(None, retire_idle=retire_idle).plan(view)
    want = ref_fleet.CatalogRebalancer(None,
                                       retire_idle=retire_idle).plan(view)
    assert got == want
    if name == "spread_hot_first":
        assert [(m["adapter"], m["dst"][-2:]) for m in got][:3] == [
            ("t1", "02"), ("t0", "02"), ("t0", "03")]


# -- rebalance on port replicas -----------------------------------------------
def test_catalog_rebalancer_spread_cap_and_failures(fleet_cleanup):
    port_tel.reset()
    port_tel.enable()
    try:
        ra = _adapter_replica(fleet_cleanup, "ra", "m",
                              adapters=("t0", "t1"))
        rb = _adapter_replica(fleet_cleanup, "rb", "m")
        for i in range(3):
            http_post(ra.url, "/generate",
                      dict(BODY, adapter="t0", request_id=f"t0-{i}"))
        http_post(ra.url, "/generate",
                  dict(BODY, adapter="t1", request_id="t1-0"))
        col = FleetCollector(urls=[ra.url, rb.url], interval_s=0)
        fleet_cleanup.append(col)
        col.scrape()
        reb = CatalogRebalancer(col)
        moves = reb.plan()
        # hot-first ordering: t0 (3 completions) spreads before t1 (1)
        assert [(m["action"], m["adapter"], m["dst"]) for m in moves] == \
            [("spread", "t0", rb.url), ("spread", "t1", rb.url)]
        assert moves[0]["src"] == ra.url
        assert moves == ref_fleet.CatalogRebalancer(None).plan(
            col.fleet_view())
        capped = CatalogRebalancer(col, max_moves=1).apply(moves)
        assert len(capped) == 1 and capped[0]["ok"]
        results = reb.rebalance()
        assert all(r["ok"] for r in results)
        assert http_get(rb.url, "/healthz")["adapters"] == ["t0", "t1"]
        col.scrape()
        assert reb.plan() == []                  # converged
        _, a = http_post(ra.url, "/generate",
                         dict(BODY, adapter="t0", request_id="pa"))
        _, b = http_post(rb.url, "/generate",
                         dict(BODY, adapter="t0", request_id="pb"))
        assert a["tokens"] == b["tokens"]
        # failure isolation: a dead destination reports, never raises
        dead = [{"action": "spread", "model": "m", "adapter": "t0",
                 "src": ra.url, "dst": "http://127.0.0.1:9"},
                {"action": "spread", "model": "m", "adapter": "nope",
                 "src": ra.url, "dst": rb.url}]
        rows = CatalogRebalancer(col, timeout_s=2.0).apply(dead)
        assert [r["ok"] for r in rows] == [False, False]
        assert rows[0]["error"]
        assert rows[1]["error"] == "unknown_adapter"
        kinds = [a["kind"] for a in col.annotations()]
        assert "catalog_rebalance" in kinds
        assert _moves(port_tel.registry()) == {("spread", "ok"): 3.0,
                                               ("spread", "error"): 2.0}
    finally:
        port_tel.disable()
        port_tel.reset()


def test_retire_idle_policy_and_pinned_adapter(fleet_cleanup):
    ra = _adapter_replica(fleet_cleanup, "ra", "m", adapters=("hot", "cold"))
    http_post(ra.url, "/generate", dict(BODY, adapter="hot",
                                        request_id="h0"))
    col = FleetCollector(urls=[ra.url], interval_s=0)
    fleet_cleanup.append(col)
    col.scrape()
    assert CatalogRebalancer(col).plan() == []
    moves = CatalogRebalancer(col, retire_idle=True).plan()
    assert moves == [{"action": "retire", "model": "m", "adapter": "cold",
                      "src": ra.url, "dst": None}]
    # pinned by a running request: a 503 reported once, not retried
    store = ra.engine.adapter_store
    slot = store.acquire("cold")
    calls = []
    reb = CatalogRebalancer(col, retire_idle=True)
    real = reb._apply_one
    reb._apply_one = lambda mv: (calls.append(mv), real(mv))[1]
    rows = reb.apply(moves)
    assert len(calls) == 1
    assert rows[0]["ok"] is False and rows[0]["error"] == "adapter_pinned"
    assert http_get(ra.url, "/healthz")["adapters"] == ["cold", "hot"]
    store.release(slot)
    rows = CatalogRebalancer(col, retire_idle=True).apply(moves)
    assert rows[0]["ok"] is True
    assert http_get(ra.url, "/healthz")["adapters"] == ["hot"]


def test_supervisor_rebalance_catalog_actuator(fleet_cleanup):
    ra = _adapter_replica(fleet_cleanup, "ra", "m", adapters=("t0",))
    rb = _adapter_replica(fleet_cleanup, "rb", "m")
    http_post(ra.url, "/generate", dict(BODY, adapter="t0",
                                        request_id="s0"))
    col = FleetCollector(urls=[ra.url, rb.url], interval_s=0)
    fleet_cleanup.append(col)
    col.scrape()
    sup = Supervisor(lambda slot: None, 0, collector=col)
    assert sup.rebalance_catalog() == []         # no rebalancer: no-op
    sup = Supervisor(lambda slot: None, 0, collector=col,
                     catalog=CatalogRebalancer(col))
    results = sup.rebalance_catalog(reason="scale_up_decode")
    assert [r["adapter"] for r in results] == ["t0"]
    assert all(r["ok"] for r in results)
    assert http_get(rb.url, "/healthz")["adapters"] == ["t0"]
    notes = [a for a in col.fleet_view()["annotations"]
             if a["kind"] == "catalog_rebalance"]
    assert any(n.get("reason") == "scale_up_decode" for n in notes)


def test_scale_up_pass_plans_on_a_fresh_scrape(fleet_cleanup):
    """A replica that joined the pool after the collector's last scrape
    (an autoscaler's scale-up) gets the hot adapter in the same pass:
    the port's supervisor scrapes before it plans.  The reference's
    plans on the older view and moves nothing (ROADMAP §C13)."""
    ra = _adapter_replica(fleet_cleanup, "ra", "m", adapters=("t0",))
    http_post(ra.url, "/generate", dict(BODY, adapter="t0",
                                        request_id="s0"))
    router = mt.fleet.Router([ra.url], scrape_interval_s=0)
    fleet_cleanup.append(router)
    col = FleetCollector(router=router, interval_s=0)
    fleet_cleanup.append(col)
    col.scrape()
    rb = _adapter_replica(fleet_cleanup, "rb", "m")
    router.add_replica(rb.url)                    # spawned after it
    ref_sup = ref_fleet.Supervisor(lambda slot: None, 0, collector=col,
                                   catalog=ref_fleet.CatalogRebalancer(col))
    assert ref_sup.rebalance_catalog(reason="scale_up_both") == []
    assert http_get(rb.url, "/healthz")["adapters"] == []
    sup = Supervisor(lambda slot: None, 0, collector=col,
                     catalog=CatalogRebalancer(col))
    results = sup.rebalance_catalog(reason="scale_up_both")
    assert [(r["adapter"], r["dst"], r["ok"]) for r in results] == [
        ("t0", rb.url, True)]
    assert http_get(rb.url, "/healthz")["adapters"] == ["t0"]


class _BrokenRebalancer:
    def __init__(self, collector):
        self.collector = collector

    def rebalance(self):
        raise urllib.error.URLError("collector gone")


def test_supervisor_failing_pass_is_annotated_never_raised(fleet_cleanup):
    col = FleetCollector(urls=[], interval_s=0)
    fleet_cleanup.append(col)
    port_tel.reset()
    port_tel.enable()
    try:
        for pkg in (mt.fleet, ref_fleet):
            sup = pkg.Supervisor(lambda slot: None, 0, collector=col,
                                 catalog=_BrokenRebalancer(col))
            assert sup.rebalance_catalog(reason="scale_up_both") == []
        kinds = [a["kind"] for a in col.annotations()]
        assert kinds.count("catalog_rebalance_failed") == 2
        snap = port_tel.registry().snapshot()
        assert snap["mxtpu_fleet_supervisor_errors_total"]["samples"][0][
            "value"] == 1.0
    finally:
        port_tel.disable()
        port_tel.reset()


# -- a moved adapter against the reference ------------------------------------
def test_moved_adapter_serves_reference_tokens(fleet_cleanup):
    """float32: ``t0`` moved port -> port by the rebalancer, and moved
    from a reference replica into a port replica over the shared wire,
    serves the tokens of the reference replica holding it."""
    src = _adapter_replica(fleet_cleanup, "src", "m", adapters=("t0",))
    dst = _adapter_replica(fleet_cleanup, "dst", "m")
    dst2 = _adapter_replica(fleet_cleanup, "dst2", "m")
    ref = _ref_adapter_replica(fleet_cleanup, "ref", "m", adapters=("t0",))
    http_post(src.url, "/generate", dict(BODY, adapter="t0",
                                         request_id="warm"))
    col = FleetCollector(urls=[src.url, dst.url], interval_s=0)
    fleet_cleanup.append(col)
    col.scrape()
    rows = CatalogRebalancer(col).rebalance()
    assert [(r["adapter"], r["dst"], r["ok"]) for r in rows] == [
        ("t0", dst.url, True)]
    code, payload = http_post(ref.url, "/adapter_export", {"adapter": "t0"})
    assert code == 200
    code, out = http_post(dst2.url, "/load_adapter", payload)
    assert code == 200 and out["adapters"] == ["t0"]
    body = {"prompt": _prompt(12, seed=3).tolist(), "max_new_tokens": 8,
            "adapter": "t0"}
    toks = {}
    for rep in (src, dst, dst2, ref):
        code, out = http_post(rep.url, "/generate",
                              dict(body, request_id=f"cmp-{rep.replica_id}"))
        assert code == 200, out
        toks[rep.replica_id] = out["tokens"]
    assert toks["dst"] == toks["ref"] == toks["src"] == toks["dst2"]
    _, base = http_post(ref.url, "/generate",
                        dict(body, adapter=None, request_id="base"))
    assert base["tokens"] != toks["ref"]          # the adapter moves tokens
    assert json.dumps(payload["records"])          # the wire is JSON


def test_rebalancer_defaults_as_reference():
    port = CatalogRebalancer(None)
    ref = ref_fleet.CatalogRebalancer(None)
    for attr in ("max_moves", "retire_idle", "timeout_s"):
        assert getattr(port, attr) == getattr(ref, attr)
    assert mx.fleet.CatalogRebalancer is ref_fleet.CatalogRebalancer
