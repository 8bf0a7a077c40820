"""The PyTorch port's disaggregated prefill/decode fleet against the JAX
reference (``mxnet_tpu_torch/fleet``: the replica roles, ``/handoff``,
``/handoff_probe``, the wire records; the router's handoff
orchestration; ``serve/kv_block_manager.py`` ``export_blocks`` /
``import_blocks``).

Ports ``tests/test_fleet_disagg.py`` case by case (all but the slow
``fleet_bench --disagg`` contract) over port engines on the CPU: the
export/import units, the role surface, the fleet's token identity and
wire dedup, idempotency, the chaos matrix (dropped records, a slow wire
past the hop timeout, a decode replica killed mid-handoff and
respawned), deadlines, traces across roles and the load signal.  The
composition gate runs handoff x int8 K/V x tp=2 x shared prefixes, its
tp=2 engines on two virtual devices of the CPU.

Cross-package: ``_encode_records`` gives the reference's bytes and
digests for the same K/V (float32, bfloat16, int8 with its scales) and
each package decodes the other's records; a reference prefill replica
hands off to a port decode replica, and a port prefill replica to a
reference decode replica, with the tokens of a reference-only fleet.
"""

import base64
import json
import os
import sys
import urllib.request

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx
from torch_port_fixtures import (  # noqa: F401  (autouse / fixtures)
    InProcHandle, collect_engines_after_module, fleet_cleanup,
    fresh_telemetry_per_module, http_post)

import mxnet_tpu.fleet as ref_fleet
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.fleet import (DEAD, FaultInjector, NoReplicaAvailable,
                                   PermanentError, ReplicaServer, Router,
                                   Supervisor)
from mxnet_tpu_torch.serve import BlockManager, HostKVPool

VOCAB = fx.VOCAB
POOL = fx.FLEET_POOL


def _engine(**kw):
    return fx.fleet_engine(**kw)


def _prompts(n, seed=7, lo=10, hi=20, shared_prefix=0):
    rng = np.random.RandomState(seed)
    out = []
    prefix = rng.randint(0, VOCAB, (shared_prefix,)) if shared_prefix \
        else None
    for _ in range(n):
        p = rng.randint(0, VOCAB,
                        (rng.randint(lo, hi),)).astype(np.int32)
        if prefix is not None:
            p[:shared_prefix] = prefix
        out.append(p)
    return out


def _reference_tokens(prompts, max_new, **kw):
    return fx.fleet_tokens(prompts, max_new, **kw)


def _disagg_fleet(fleet_cleanup, n_decode=2, router_kw=None,
                  decode_kw=None, prefill_kw=None, decode_rep_kw=None,
                  pre_pkg=mt.fleet, dec_pkg=mt.fleet):
    """1 prefill + ``n_decode`` decode replicas + a scraped port router;
    ``pre_pkg`` / ``dec_pkg`` pick each side's package."""
    def engine(pkg, **kw):
        return (_engine(**kw) if pkg is mt.fleet
                else fx.ref_fleet_engine(**kw))

    pre = pre_pkg.ReplicaServer(engine(pre_pkg, **(prefill_kw or {})),
                                replica_id="pre", role="prefill").start()
    fleet_cleanup.append(pre)
    eng_kw = dict(host_kv_bytes=POOL)
    eng_kw.update(decode_kw or {})
    decs = []
    for i in range(n_decode):
        rep_kw = (decode_rep_kw or {}).get(i, {})
        rep = dec_pkg.ReplicaServer(engine(dec_pkg, **eng_kw),
                                    replica_id=f"dec{i}", role="decode",
                                    **rep_kw).start()
        fleet_cleanup.append(rep)
        decs.append(rep)
    kw = dict(scrape_interval_s=0, timeout_s=30, retries=4,
              backoff_s=0.01, backoff_max_s=0.05)
    kw.update(router_kw or {})
    router = Router([pre.url] + [d.url for d in decs], **kw)
    fleet_cleanup.append(router)
    router.scrape()
    return pre, decs, router


# -- export/import units ------------------------------------------------------
def _fake_fetch(store):
    def fetch(blk):
        return store.setdefault(
            blk, (np.full(8, float(blk), np.float32),
                  np.full(8, float(blk) + 0.5, np.float32)))
    return fetch


def test_export_import_roundtrip_and_chain_verification():
    m = BlockManager(num_blocks=9, block_size=4,
                     host_pool=HostKVPool(4096, block_tokens=4))
    m.set_offload_source(_fake_fetch({}))
    ids = list(range(30, 42))
    m.allocate("a", 12, token_ids=ids)
    m.note_tokens("a", ids)
    recs = m.export_blocks("a", ids)
    assert len(recs) == 3
    assert recs[0][1] is None
    assert recs[1][1] == recs[0][0]
    assert recs[0][2] == ids[:4]
    m.free("a", retain=True)
    assert [r[0] for r in m.export_blocks("a", ids)] == \
        [r[0] for r in recs]
    m2 = BlockManager(num_blocks=9, block_size=4,
                      host_pool=HostKVPool(4096, block_tokens=4))
    assert m2.import_blocks(recs) == (3, 0, 0)
    assert sorted(m2.has_blocks([r[0] for r in recs])) == \
        sorted(r[0] for r in recs)
    _, cached = m2.allocate("b", 13, token_ids=ids + [99])
    assert cached == 12
    assert m2.import_blocks(recs) == (0, 3, 0)


def test_import_rejects_corrupt_and_out_of_chain_records():
    m = BlockManager(num_blocks=9, block_size=4,
                     host_pool=HostKVPool(4096, block_tokens=4))
    m.set_offload_source(_fake_fetch({}))
    ids = list(range(50, 62))
    m.allocate("a", 12, token_ids=ids)
    m.note_tokens("a", ids)
    recs = m.export_blocks("a", ids)
    tgt = BlockManager(num_blocks=9, block_size=4,
                       host_pool=HostKVPool(4096, block_tokens=4))
    bad = [recs[0],
           (recs[1][0], recs[1][1], [1, 2, 3, 4], recs[1][3]),
           recs[2]]
    assert tgt.import_blocks(bad) == (1, 0, 2)
    assert len(tgt.has_blocks([r[0] for r in recs])) == 1
    tgt2 = BlockManager(num_blocks=9, block_size=4,
                        host_pool=HostKVPool(4096, block_tokens=4))
    assert tgt2.import_blocks(recs[1:]) == (0, 0, 2)
    tgt3 = BlockManager(num_blocks=9, block_size=4,
                        host_pool=HostKVPool(4096, block_tokens=4))
    skipped = [(recs[0][0], None, recs[0][2], None)] + recs[1:]
    assert skipped[0][3] is None
    assert tgt3.import_blocks(skipped) == (0, 0, 3)
    plain = BlockManager(num_blocks=9, block_size=4)
    assert plain.import_blocks(recs) == (0, 0, 3)


def test_pool_peek_leaves_entry_parked():
    p = HostKVPool(4096, block_tokens=4)
    arrs = (np.full(4, 7.0, np.float32),)
    p.put(b"k", None, arrs)
    got = p.peek(b"k")
    assert got is not None and got[0][0] == 7.0
    assert p.has(b"k") and p.restores == 0
    assert p.peek(b"missing") is None


# -- the wire records against the reference's ---------------------------------
def _records(kind):
    """Two chained export records of one K/V (numpy, the reference's
    host copies; ml_dtypes for bfloat16) and the same K/V as the
    port's CPU tensors."""
    import ml_dtypes

    rng = np.random.RandomState(4)
    shape = (2, 4, 3, 8)                  # (layers, block, kv heads, dh)
    key0, key1 = rng.bytes(20), rng.bytes(20)
    ref, port = [], []
    parent = None
    for key in (key0, key1):
        if kind == "int8":
            arrs = [rng.randint(-128, 128, shape).astype(np.int8),
                    rng.randint(-128, 128, shape).astype(np.int8),
                    rng.rand(*shape[:3]).astype(np.float32),
                    rng.rand(*shape[:3]).astype(np.float32)]
        else:
            arrs = [rng.randn(*shape).astype(np.float32) for _ in range(2)]
            if kind == "bfloat16":
                arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
        tens = [mt.serve.kv_block_manager.host_tensor(a.copy())
                for a in arrs]
        toks = rng.randint(0, VOCAB, 4).tolist()
        ref.append((key, parent, toks, tuple(arrs)))
        port.append((key, parent, toks, tuple(tens)))
        parent = key
    return ref, port


class _Spec:
    """A stand-in engine for the codecs: ``host_block_spec`` only."""

    def __init__(self, specs):
        self._specs = specs

    def host_block_spec(self):
        return self._specs


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_encode_records_equal_reference_bytes_and_digests(kind):
    import ml_dtypes

    ref_recs, port_recs = _records(kind)
    ref_wire, ref_n = ref_fleet.ReplicaServer._encode_records(
        None, ref_recs)
    port_wire, port_n = ReplicaServer._encode_records(None, port_recs)
    assert port_wire == ref_wire and port_n == ref_n
    if kind == "int8":
        assert all({"ksc", "vsc"} <= set(r) for r in port_wire)
    # each package decodes the other's records to the same K/V
    shape = (2, 4, 3, 8)
    names = {"float32": "float32", "bfloat16": "bfloat16", "int8": "int8"}
    port_spec = [(shape, names[kind])] * 2
    np_dt = {"float32": np.dtype(np.float32), "int8": np.dtype(np.int8),
             "bfloat16": np.dtype(ml_dtypes.bfloat16)}[kind]
    ref_spec = [(shape, np_dt)] * 2
    if kind == "int8":
        port_spec += [(shape[:3], "float32")] * 2
        ref_spec += [(shape[:3], np.dtype(np.float32))] * 2
    port_side = ReplicaServer.__new__(ReplicaServer)
    port_side.engine = _Spec(port_spec)
    ref_side = ref_fleet.ReplicaServer.__new__(ref_fleet.ReplicaServer)
    ref_side.engine = _Spec(ref_spec)
    parsed, n = port_side._decode_records(ref_wire)
    assert n == ref_n
    for (k, pk, t, a), (rk, rpk, rt, ra) in zip(parsed, ref_recs):
        assert (k, pk, t) == (rk, rpk, rt)
        for x, y in zip(a, ra):
            assert isinstance(x, torch.Tensor)
            assert mt.serve.kv_block_manager.dtype_name(x) == str(y.dtype)
            assert x.contiguous().view(torch.uint8).numpy().tobytes() == \
                np.ascontiguousarray(y).tobytes()
    parsed_ref, _ = ref_side._decode_records(port_wire)
    for (_, _, _, a), (_, _, _, ra) in zip(parsed_ref, ref_recs):
        for x, y in zip(a, ra):
            assert x.tobytes() == y.tobytes() and x.dtype == y.dtype


# -- role surface -------------------------------------------------------------
def test_role_validation_and_health_signal():
    with pytest.raises(ValueError, match="role"):
        ReplicaServer(_engine(), role="weird")
    eng = _engine()
    with pytest.raises(ValueError, match="host-RAM KV tier"):
        ReplicaServer(eng, role="decode")
    eng.shutdown()
    eng = _engine()
    rep = ReplicaServer(eng, replica_id="r0")
    assert rep.role == "both"
    h = rep._health()
    assert h["role"] == "both" and h["waiting_handoffs"] == 0
    s = rep._replica_state()
    assert s["role"] == "both"
    assert s["handoff"]["received"] == 0
    eng.shutdown()


def test_wrong_role_is_retriable_503(fleet_cleanup):
    pre = ReplicaServer(_engine(), replica_id="p", role="prefill").start()
    dec = ReplicaServer(_engine(host_kv_bytes=POOL), replica_id="d",
                        role="decode").start()
    fleet_cleanup.extend([pre, dec])
    prompt = _prompts(1)[0].tolist()
    code, out = http_post(dec.url, "/generate",
                          {"prompt": prompt, "max_new_tokens": 4})
    assert code == 503 and out["error"] == "wrong_role"
    assert out["retriable"] is True
    code, out = http_post(pre.url, "/handoff",
                          {"prompt": prompt, "max_new_tokens": 4,
                           "records": []})
    assert code == 503 and out["error"] == "wrong_role"
    code, out = http_post(pre.url, "/generate",
                          {"prompt": [1] * 40, "max_new_tokens": 30})
    assert code == 400 and out["error"] == "exceeds_max_len"


# -- disaggregated fleet ------------------------------------------------------
def test_disagg_fleet_token_identity_and_dedup(fleet_cleanup):
    prompts = _prompts(5, seed=11, shared_prefix=8)
    refs = _reference_tokens(prompts, 8)
    pre, decs, router = _disagg_fleet(fleet_cleanup)
    for i, p in enumerate(prompts):
        res = router.generate(p.tolist(), max_new_tokens=8,
                              request_id=f"dg-{i}")
        assert res.tokens == refs[i], f"request {i} diverged"
        assert [h.get("hop") for h in res.hops] == [None, "handoff"]
    pstate = pre._replica_state()
    assert pstate["handoff"]["exported"] == len(prompts)
    assert pstate["handoff"]["bytes_exported"] > 0
    received = imported = deduped = restored = 0
    for d in decs:
        h = d._replica_state()["handoff"]
        received += h["received"]
        imported += h["blocks_imported"]
        deduped += h["blocks_deduped"]
        restored += d.engine.stats().host_kv_restored_tokens
    assert received == len(prompts)
    assert imported > 0
    assert deduped > 0
    assert restored > 0
    # the wire bytes are whole blocks of the engine's host layout
    block = decs[0].engine.host_kv_stats()["block_bytes"]
    assert pstate["handoff"]["bytes_exported"] % block == 0


@pytest.mark.parametrize("pre,dec", [("ref", "port"), ("port", "ref")])
def test_mixed_package_handoff_matches_reference_fleet(fleet_cleanup, pre,
                                                       dec):
    """A prefill replica of one package hands off to a decode replica of
    the other: the tokens equal a reference-only fleet's, and the
    records really imported (the decode side restored them)."""
    prompts = _prompts(4, seed=47, shared_prefix=8)
    pkgs = {"ref": ref_fleet, "port": mt.fleet}
    _, _, ref_router = _disagg_fleet(fleet_cleanup, n_decode=1,
                                     pre_pkg=ref_fleet, dec_pkg=ref_fleet)
    refs = [ref_router.generate(p.tolist(), max_new_tokens=8).tokens
            for p in prompts]
    _, (d,), router = _disagg_fleet(fleet_cleanup, n_decode=1,
                                    pre_pkg=pkgs[pre], dec_pkg=pkgs[dec])
    for i, p in enumerate(prompts):
        res = router.generate(p.tolist(), max_new_tokens=8,
                              request_id=f"mx-{i}")
        assert res.tokens == refs[i], f"request {i} diverged"
    h = d._replica_state()["handoff"]
    assert h["received"] == len(prompts) and h["blocks_imported"] > 0
    assert h["blocks_rejected"] == 0
    assert d.engine.stats().host_kv_restored_tokens > 0


def test_disagg_identity_int8_kv_prefix_sharing_and_tp2_refusal(
        fleet_cleanup, monkeypatch):
    """The reference's composition gate: handoff x int8 K/V blocks x
    tp=2 x shared prefixes gives the tokens of a role='both' engine with
    the same formulation.  (tp=2 refused before tensor-parallel serving
    was ported; the handed-off records are whole blocks, every shard's
    heads gathered, and scatter back onto the decode side's shards.)"""
    from mxnet_tpu_torch.parallel import mesh

    monkeypatch.setenv(mesh.ENV_VIRTUAL, "2")
    kw = dict(kv_dtype="int8", tp=2)
    prompts = _prompts(3, seed=13, shared_prefix=8)
    refs = _reference_tokens(prompts, 6, **kw)
    pre, decs, router = _disagg_fleet(fleet_cleanup, n_decode=1,
                                      prefill_kw=kw, decode_kw=kw)
    for i, p in enumerate(prompts):
        res = router.generate(p.tolist(), max_new_tokens=6,
                              request_id=f"q-{i}")
        assert res.tokens == refs[i], f"request {i} diverged"
    h = decs[0]._replica_state()["handoff"]
    assert h["received"] == 3 and h["blocks_imported"] > 0
    # int8 wire records carry the scale slots: 2 extra arrays, each with
    # every kv head
    spec = decs[0].engine.host_block_spec()
    assert len(spec) == 4 and spec[0][0][2] == decs[0].engine._cfg.kv_heads
    assert pre.engine.tp == decs[0].engine.tp == 2


def test_handoff_idempotency_by_request_id(fleet_cleanup):
    prompts = _prompts(1, seed=17)
    [ref] = _reference_tokens(prompts, 6)
    pre, (dec,), router = _disagg_fleet(fleet_cleanup, n_decode=1)
    r1 = router.generate(prompts[0].tolist(), max_new_tokens=6,
                         request_id="same-id")
    r2 = router.generate(prompts[0].tolist(), max_new_tokens=6,
                         request_id="same-id")
    assert r1.tokens == r2.tokens == ref
    assert dec.engine.stats().completed == 1
    assert pre.engine.stats().completed == 1


# -- chaos matrix -------------------------------------------------------------
def test_handoff_drop_degrades_to_recompute(fleet_cleanup):
    prompts = _prompts(3, seed=19)
    refs = _reference_tokens(prompts, 8)
    pre, decs, router = _disagg_fleet(
        fleet_cleanup, n_decode=2,
        decode_rep_kw={0: dict(handoff_drop=100),
                       1: dict(handoff_drop=100)})
    for i, p in enumerate(prompts):
        res = router.generate(p.tolist(), max_new_tokens=8,
                              request_id=f"dr-{i}")
        assert res.tokens == refs[i], f"request {i} diverged"
    h0 = decs[0]._replica_state()["handoff"]
    h1 = decs[1]._replica_state()["handoff"]
    assert h0["blocks_imported"] + h1["blocks_imported"] == 0
    assert h0["drops"] + h1["drops"] == 3


def test_handoff_delay_times_out_and_rehandoffs_on_sibling(fleet_cleanup):
    """A slow wire (30 s, ended when the replica stops) past the
    router's 2.5 s hop timeout: the router re-sends the payload it
    holds to the sibling decode replica."""
    prompts = _prompts(2, seed=23)
    refs = _reference_tokens(prompts, 6)
    pre, decs, router = _disagg_fleet(
        fleet_cleanup, n_decode=2, router_kw=dict(timeout_s=2.5),
        decode_rep_kw={0: dict(handoff_delay_s=30.0)})
    saw_timeout = False
    for i, p in enumerate(prompts):
        res = router.generate(p.tolist(), max_new_tokens=6,
                              request_id=f"dl-{i}")
        assert res.tokens == refs[i], f"request {i} diverged"
        saw_timeout = saw_timeout or any(
            h["status"] == "timeout" and h.get("hop") == "handoff"
            for h in res.hops)
    assert saw_timeout, "no handoff ever hit the slow replica"


def test_handoff_payload_corruption_detected():
    src_eng = _engine()
    pre = ReplicaServer(src_eng, replica_id="src", role="prefill")
    prompt = _prompts(1, seed=43, lo=12, hi=13)[0]
    req = src_eng.submit(prompt, max_new_tokens=1)
    src_eng.run()
    records, nbytes = pre._encode_records(
        src_eng.blocks.export_blocks(req.rid, prompt))
    assert records and nbytes > 0
    dst_eng = _engine(host_kv_bytes=POOL)
    dst = ReplicaServer(dst_eng, replica_id="dst", role="decode")
    parsed, _ = dst._decode_records(records)
    assert parsed[0][3] is not None
    raw = bytearray(base64.b64decode(records[0]["k"]))
    raw[0] ^= 0xFF
    records[0]["k"] = base64.b64encode(bytes(raw)).decode()
    with pytest.raises(ValueError, match="digest"):
        dst._decode_records(records)
    src_eng.shutdown()
    dst_eng.shutdown()


def test_decode_kill_mid_handoff_rehandoff_and_respawn(fleet_cleanup):
    prompts = _prompts(4, seed=29)
    refs = _reference_tokens(prompts, 8)
    pre = ReplicaServer(_engine(), replica_id="pre",
                        role="prefill").start()
    fleet_cleanup.append(pre)
    router = Router([pre.url], scrape_interval_s=0, timeout_s=30,
                    retries=4, backoff_s=0.01, backoff_max_s=0.05)
    fleet_cleanup.append(router)
    spawned = []

    def spawn(slot):
        injector = (FaultInjector("kill@1")
                    if slot == 0 and not spawned else None)
        rep = ReplicaServer(
            _engine(host_kv_bytes=POOL),
            replica_id=f"dec{slot}-{len(spawned)}", role="decode",
            fault_injector=injector).start()
        fleet_cleanup.append(rep)
        spawned.append(rep)
        return InProcHandle(rep)

    sup = Supervisor(spawn, 2, router=router, restart_backoff_s=0.0)
    sup.start()
    router.scrape()
    doomed = spawned[0]
    results = [router.generate(p.tolist(), max_new_tokens=8,
                               request_id=f"k-{i}")
               for i, p in enumerate(prompts)]
    for i, res in enumerate(results):
        assert res.tokens == refs[i], f"request {i} diverged"
    assert doomed.state == DEAD, "kill fault never fired"
    assert any(len([h for h in r.hops if h.get("hop") == "handoff"]) > 1
               for r in results), "no re-handoff happened"
    assert sup.check() == [0]
    router.scrape()
    replacement = spawned[-1]
    assert replacement is not doomed
    res = router.generate(prompts[0].tolist(), max_new_tokens=8,
                          request_id="after-respawn")
    assert res.tokens == refs[0]
    sup.stop()


def test_no_decode_replica_exhausts_cleanly(fleet_cleanup):
    pre, (dec,), router = _disagg_fleet(fleet_cleanup, n_decode=1)
    dec.hard_stop()
    router.scrape()
    with pytest.raises(NoReplicaAvailable, match="handoff"):
        router.generate(_prompts(1)[0].tolist(), max_new_tokens=4,
                        request_id="nd-1")


def test_handoff_deadline_propagates_end_to_end(fleet_cleanup):
    pre, (dec,), router = _disagg_fleet(
        fleet_cleanup, n_decode=1,
        router_kw=dict(retries=10, backoff_s=0.05, backoff_max_s=0.05))
    dec.drain()
    with pytest.raises(PermanentError, match="exhausted"):
        router.generate(_prompts(1)[0].tolist(), max_new_tokens=4,
                        deadline_s=0.3, request_id="ddl-1")


# -- traces + load signal -----------------------------------------------------
def test_trace_stitches_across_roles(tmp_path, monkeypatch, fleet_cleanup):
    monkeypatch.setenv("MXTPU_REQUEST_TRACE",
                       str(tmp_path / "trace.jsonl"))
    prompts = _prompts(1, seed=31)
    pre, (dec,), router = _disagg_fleet(fleet_cleanup, n_decode=1)
    res = router.generate(prompts[0].tolist(), max_new_tokens=6,
                          request_id="tr-1", trace_id="disagg-tr-1")
    assert res.trace_id == "disagg-tr-1"
    for rep in (pre, dec):
        rep.stop()
    router.stop()
    lines = [json.loads(ln) for ln in
             (tmp_path / "trace.jsonl").read_text().splitlines()
             if ln.strip()]
    hops = [ln for ln in lines if ln.get("trace_id") == "disagg-tr-1"]
    assert len(hops) == 3
    assert all(h["status"] == "finished" for h in hops)
    router_lines = [h for h in hops if h.get("replica") == "router"]
    assert len(router_lines) == 1
    router_evs = [e["ev"] for e in router_lines[0]["events"]]
    assert "pick" in router_evs and "hop" in router_evs
    assert "handoff" in router_evs
    admits = [e for h in hops for e in h["events"]
              if e["ev"] == "admitted"]
    handoff_admits = [e for e in admits if e.get("handoff")]
    assert len(handoff_admits) == 1
    assert handoff_admits[0]["cached_tokens"] > 0
    sys.path.insert(0, os.path.join(fx.REPO, "tools"))
    import trace_report

    s = trace_report.stitch([(h, {}, h["status"], None, True)
                             for h in hops])
    assert s["requests"] == 1 and s["max_hops"] == 3
    assert s["unresolved"] == []


def test_waiting_handoffs_load_signal():
    eng = _engine(host_kv_bytes=POOL)
    rep = ReplicaServer(eng, replica_id="wh", role="decode")
    assert rep.waiting_handoffs == 0
    req = eng.submit(_prompts(1)[0], max_new_tokens=2, handoff=True)
    assert eng.scheduler.waiting_handoffs() == 1
    assert rep.waiting_handoffs == 1
    assert rep._health()["waiting_handoffs"] == 1
    eng.run()
    assert req.status == "finished"
    assert rep.waiting_handoffs == 0
    eng.shutdown()
    score_idle = Router._load_score(
        {"max_batch": 4, "queue_depth": 0, "running": 0,
         "kv_utilization": 0.0})
    score_busy = Router._load_score(
        {"max_batch": 4, "queue_depth": 0, "running": 0,
         "waiting_handoffs": 2, "kv_utilization": 0.0})
    assert score_busy > score_idle


def test_role_unset_is_inert_schema(fleet_cleanup):
    assert "MXTPU_FLEET_ROLE" not in os.environ
    rep = ReplicaServer(_engine(), replica_id="inert").start()
    fleet_cleanup.append(rep)
    router = Router([rep.url], scrape_interval_s=0, timeout_s=30,
                    retries=2)
    fleet_cleanup.append(router)
    router.scrape()
    prompts = _prompts(1, seed=37)
    [ref] = _reference_tokens(prompts, 6)
    res = router.generate(prompts[0].tolist(), max_new_tokens=6,
                          request_id="in-1")
    assert res.tokens == ref
    assert [h.get("hop") for h in res.hops] == [None]
    with urllib.request.urlopen(f"{rep.url}/healthz",
                                timeout=10) as resp:
        hz = json.loads(resp.read())
    legacy = {"status", "state", "in_flight", "queue_depth", "running",
              "host_kv_utilization"}
    assert legacy <= set(hz)
    assert set(hz) - legacy == {"role", "waiting_handoffs",
                                "kv_summary"}
    ks = hz["kv_summary"]
    assert ks["bloom"]["m"] // 8 >= len(ks["bloom"]["bits"]) * 3 // 4 - 3
    assert len(ks["top"]) <= 32
