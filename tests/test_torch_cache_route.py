"""The PyTorch port's cache-aware routing and peer pull against the JAX
reference (``mxnet_tpu_torch/serve/kv_block_manager.py``
``RadixSummary`` / ``chain_keys`` / the block manager's summary hooks;
``fleet/router.py`` affinity plan; ``fleet/replica.py``
``/chain_export`` and the hinted pull).

Ports ``tests/test_cache_route.py`` case by case over port engines on
the CPU: the summary units, the keep-alive scrape pin, affinity routing
(pinning, the byte-inert zero, stale summaries), and the pull with its
degradation matrix (false positive, corrupt records, hung peer), every
arm recomputing to the same tokens.  Cross-package: ``RadixSummary``
snapshots equal to the reference's after the same publish and evict
sequence (unit and block manager), the port's ``/healthz``
``kv_summary`` equal to a reference replica's after the same traffic,
and the port router's affinity plan over a reference replica's
advertisement.
"""

import http.server
import json
import math
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch_port_fixtures as fx
from torch_port_fixtures import (  # noqa: F401  (autouse / fixtures)
    collect_engines_after_module, fleet_cleanup,
    fresh_telemetry_per_module, http_get)

import mxnet_tpu.fleet as ref_fleet
from mxnet_tpu.serve import kv_block_manager as ref_kv
from mxnet_tpu_torch.fleet import ReplicaServer, Router
from mxnet_tpu_torch.serve import BlockManager
from mxnet_tpu_torch.serve import kv_block_manager as port_kv
from mxnet_tpu_torch.serve.kv_block_manager import (RadixSummary, _ROOT,
                                                    _block_key, chain_keys)

VOCAB = fx.VOCAB
POOL = fx.FLEET_POOL
PKGS = {"ref": ref_kv, "port": port_kv}


def _engine(**kw):
    return fx.fleet_engine(**kw)


def _reference_tokens(prompt, max_new=8):
    return fx.fleet_tokens([prompt], max_new)[0]


def _gen(url, body, timeout=60):
    req = urllib.request.Request(
        f"{url}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _pull_stats(url):
    return (http_get(url, "/statusz.json").get("replica") or {}) \
        .get("pull") or {}


def _prompt(seed, prefix=None, suffix_len=6):
    rng = np.random.RandomState(seed)
    body = rng.randint(0, VOCAB, (suffix_len,)).tolist()
    return list(prefix or []) + body


PREFIX = np.random.RandomState(11).randint(0, VOCAB, (20,)).tolist()


# -- chain_keys + RadixSummary units ------------------------------------------
def test_chain_keys_match_block_manager_hash():
    toks = list(range(1, 14))
    keys = chain_keys(toks, 4)
    assert len(keys) == 3
    parent = _ROOT
    for b, key in enumerate(keys):
        expect = _block_key(parent, np.asarray(toks[b * 4:(b + 1) * 4],
                                               np.int32))
        assert key == expect
        parent = key
    assert len(chain_keys(list(range(16)), 4)) == 3
    assert chain_keys([1, 2], 4) == []
    assert chain_keys(list(range(40)), 4, max_blocks=2) == \
        chain_keys(list(range(40)), 4)[:2]
    assert keys == ref_kv.chain_keys(toks, 4)


def test_bloom_fp_rate_below_configured_bound():
    m, k, n = 4096, 4, 256
    s = RadixSummary(block_size=4, bloom_bits=m, top_k=0)
    rng = np.random.RandomState(5)
    for _ in range(n):
        s.add(rng.bytes(20))
    snap = s.snapshot()
    probes = 4000
    fps = sum(RadixSummary.match(snap, [rng.bytes(20)])
              for _ in range(probes))
    bound = (1.0 - math.exp(-k * n / m)) ** k
    assert fps / probes <= 2.0 * bound + 1e-3
    s2 = RadixSummary(block_size=4, bloom_bits=m, top_k=0)
    keys = [rng.bytes(20) for _ in range(64)]
    for key in keys:
        s2.add(key)
    snap2 = s2.snapshot()
    assert all(RadixSummary.match(snap2, [key]) for key in keys)


def test_counting_bloom_remove_and_bounded_snapshot():
    s = RadixSummary(block_size=4, bloom_bits=1024, top_k=8)
    rng = np.random.RandomState(9)
    keys = [rng.bytes(20) for _ in range(500)]
    for key in keys:
        s.add(key)
    big = len(s.snapshot()["bloom"]["bits"])
    for key in keys:
        s.remove(key)
    snap = s.snapshot()
    assert snap["keys"] == 0
    assert snap["top"] == []
    assert not any(RadixSummary.match(snap, [key]) for key in keys)
    assert big <= (1024 // 8) * 4 // 3 + 4
    assert len(snap["top"]) <= 8
    assert RadixSummary.match(None, keys) == 0
    assert RadixSummary.match({"bloom": {"bits": "!!"}}, keys) == 0


@pytest.mark.parametrize("bloom_bits,top_k", [(4096, 32), (1024, 8),
                                              (64, 0)])
def test_summary_snapshot_equals_reference(bloom_bits, top_k):
    """The same add/remove/clear sequence, saturation included, gives
    the reference's snapshot, and either package's ``match`` scores
    either's snapshot the same."""
    sums = {k: mod.RadixSummary(4, bloom_bits=bloom_bits, top_k=top_k)
            for k, mod in PKGS.items()}
    rng = np.random.RandomState(bloom_bits + top_k)
    keys = [rng.bytes(20) for _ in range(300)]
    ops = rng.randint(0, 4, 2000)
    live = []
    for i, op in enumerate(ops):
        if op < 3 or not live:
            key = keys[rng.randint(len(keys))]
            live.append(key)
            for s in sums.values():
                s.add(key)
        else:
            key = live.pop(rng.randint(len(live)))
            for s in sums.values():
                s.remove(key)
        if i == 1500:
            for s in sums.values():
                s.clear()
            live = []
    snaps = {k: s.snapshot() for k, s in sums.items()}
    assert snaps["port"] == snaps["ref"]
    probes = [chain_keys(list(rng.randint(0, VOCAB, 20)), 4)
              for _ in range(20)] + [[key] for key in keys[:50]]
    for probe in probes:
        scores = {(a, b): PKGS[a].RadixSummary.match(snaps[b], probe)
                  for a in PKGS for b in PKGS}
        assert len(set(scores.values())) == 1


def test_resurrection_counter_split():
    m = BlockManager(num_blocks=16, block_size=4, prefix_cache=True)
    toks = np.arange(1, 14, dtype=np.int32)
    m.allocate("a", len(toks), token_ids=toks)
    m.note_tokens("a", toks)
    m.free("a")
    _, cached = m.allocate("b", len(toks), token_ids=toks)
    assert cached == 12
    st = m.prefix_stats()
    assert st["hits"] == 1 and st["resurrections"] == 1
    _, cached2 = m.allocate("c", len(toks), token_ids=toks)
    assert cached2 == 12
    st = m.prefix_stats()
    assert st["hits"] == 2 and st["resurrections"] == 1


def test_summary_tracks_publish_and_evict():
    m = BlockManager(num_blocks=16, block_size=4, prefix_cache=True)
    toks = np.arange(1, 14, dtype=np.int32)
    keys = chain_keys(toks.tolist(), 4)
    assert m.summary()["keys"] == 0
    m.allocate("a", len(toks), token_ids=toks)
    m.note_tokens("a", toks)
    snap = m.summary()
    assert snap["keys"] == 3
    assert RadixSummary.match(snap, keys) == 3
    m.free("a")
    m.reset()
    snap = m.summary()
    assert snap["keys"] == 0
    assert RadixSummary.match(snap, keys) == 0
    assert BlockManager(num_blocks=16, block_size=4,
                        prefix_cache=False).summary() is None


def _fetch(blk):
    return (np.full(8, float(blk), np.float32),
            np.full(8, float(blk) + 0.5, np.float32))


def test_block_manager_summary_equals_reference_through_both_tiers():
    """One allocate/publish/free/evict/offload/restore/reset sequence on
    both packages' block managers with a host tier: the summaries agree
    after every operation, ``can_allocate`` answers alike, and a reset
    rebuilds from the surviving host entries."""
    mgrs = {}
    for k, mod in PKGS.items():
        m = mod.BlockManager(num_blocks=9, block_size=4,
                             host_pool=mod.HostKVPool(1 << 12,
                                                      block_tokens=4))
        m.set_offload_source(_fetch)
        mgrs[k] = m
    rng = np.random.RandomState(21)
    seqs = [rng.randint(0, VOCAB, (int(n),)).astype(np.int32)
            for n in rng.randint(5, 20, 12)]
    for i, toks in enumerate(seqs):
        for m in mgrs.values():
            assert m.can_allocate(len(toks), token_ids=toks) == \
                mgrs["ref"].can_allocate(len(toks), token_ids=toks)
        outs = {}
        for k, m in mgrs.items():
            try:
                outs[k] = m.allocate(f"r{i}", len(toks), token_ids=toks)[1]
                m.note_tokens(f"r{i}", toks)
                m.take_pending_restores()
                m.free(f"r{i}")
            except Exception as e:          # NoFreeBlocks in both
                outs[k] = type(e).__name__
        assert outs["port"] == outs["ref"]
        assert mgrs["port"].summary() == mgrs["ref"].summary(), i
    assert mgrs["port"].summary()["keys"] > 0
    for m in mgrs.values():
        m.reset()
    assert mgrs["port"].summary() == mgrs["ref"].summary()
    assert mgrs["port"].summary()["keys"] == len(mgrs["port"].host)


def test_replica_kv_summary_equals_reference_replica(fleet_cleanup):
    """A port replica and a reference replica served the same prompts
    advertise the same ``kv_summary``; the port router's affinity plan
    reads the reference replica's advertisement."""
    port = ReplicaServer(_engine(), replica_id="p").start()
    ref = ref_fleet.ReplicaServer(fx.ref_fleet_engine(),
                                  replica_id="r").start()
    fleet_cleanup.extend([port, ref])
    for seed in (1, 2, 3):
        for rep in (port, ref):
            _gen(rep.url, {"prompt": _prompt(seed, PREFIX),
                           "max_new_tokens": 6})
    a = http_get(port.url, "/healthz")["kv_summary"]
    b = http_get(ref.url, "/healthz")["kv_summary"]
    assert a == b and a["keys"] > 0
    router = Router([ref.url], scrape_interval_s=0, affinity=1.0)
    fleet_cleanup.append(router)
    router.scrape()
    plan = router._affinity_plan(_prompt(9, PREFIX))
    assert plan is not None and plan["best"]["name"] == "r"
    assert plan["best"]["tokens"] >= 16


# -- keep-alive scrape --------------------------------------------------------
def test_scrape_reuses_one_connection(fleet_cleanup):
    rep = ReplicaServer(_engine(), replica_id="ka").start()
    fleet_cleanup.append(rep)
    router = Router([rep.url], scrape_interval_s=0, timeout_s=10)
    fleet_cleanup.append(router)
    for _ in range(8):
        router.scrape()
    (state,) = router.replicas()
    assert state.state == "ready"
    assert state.connects == 1
    assert state.conn is not None


# -- affinity routing ---------------------------------------------------------
def test_affinity_pins_returning_user(fleet_cleanup):
    reps = [ReplicaServer(_engine(), replica_id=f"r{i}").start()
            for i in range(2)]
    fleet_cleanup.extend(reps)
    router = Router([r.url for r in reps], scrape_interval_s=0,
                    timeout_s=30, retries=3, backoff_s=0.01,
                    backoff_max_s=0.05, affinity=1.0, pull=False)
    fleet_cleanup.append(router)
    router.scrape()
    first = router.generate(_prompt(1, PREFIX), max_new_tokens=4)
    router.scrape()
    plan = router._affinity_plan(_prompt(2, PREFIX))
    assert plan is not None
    assert plan["best"]["name"] == first.replica
    assert plan["best"]["tokens"] >= 16
    for seed in range(2, 6):
        res = router.generate(_prompt(seed, PREFIX), max_new_tokens=4)
        assert res.replica == first.replica
        router.scrape()


def test_affinity_zero_is_decision_inert(fleet_cleanup):
    reps = [ReplicaServer(_engine(), replica_id=f"z{i}").start()
            for i in range(2)]
    fleet_cleanup.extend(reps)
    router = Router([r.url for r in reps], scrape_interval_s=0,
                    timeout_s=30, retries=3, backoff_s=0.01,
                    backoff_max_s=0.05)
    fleet_cleanup.append(router)
    assert router.affinity == 0.0
    router.scrape()
    served = []
    for seed in range(4):
        res = router.generate(_prompt(seed, PREFIX), max_new_tokens=4)
        served.append(res.replica)
        router.scrape()
    assert served == ["z0", "z1", "z0", "z1"]
    for rep in reps:
        pull = _pull_stats(rep.url)
        assert pull["attempts"] == 0 and pull["chain_exports"] == 0


def test_stale_summary_scores_zero_affinity(fleet_cleanup):
    rep = ReplicaServer(_engine(), replica_id="st").start()
    fleet_cleanup.append(rep)
    router = Router([rep.url], scrape_interval_s=0, timeout_s=30,
                    retries=3, backoff_s=0.01, backoff_max_s=0.05,
                    affinity=1.0, summary_stale=3.0)
    fleet_cleanup.append(router)
    router.scrape()
    router.generate(_prompt(1, PREFIX), max_new_tokens=4)
    router.scrape()
    prompt = _prompt(2, PREFIX)
    assert router._affinity_plan(prompt) is not None
    (state,) = router.replicas()
    state.summary_t -= 3.0 * 1.0 + 0.5
    assert router._affinity_plan(prompt) is None


# -- peer-to-peer chain pull --------------------------------------------------
def test_pull_imports_chain_token_identical(fleet_cleanup):
    warm = ReplicaServer(_engine(host_kv_bytes=POOL),
                         replica_id="warm").start()
    cold = ReplicaServer(_engine(host_kv_bytes=POOL),
                         replica_id="cold").start()
    fleet_cleanup.extend([warm, cold])
    prompt = _prompt(21, PREFIX)
    ref = _reference_tokens(prompt)
    first = _gen(warm.url, {"prompt": prompt, "max_new_tokens": 8,
                            "request_id": "w1"})
    assert first["tokens"] == ref
    pulled = _gen(cold.url, {"prompt": prompt, "max_new_tokens": 8,
                             "request_id": "c1",
                             "kv_pull": {"peer": warm.url,
                                         "tokens": 16}})
    assert pulled["tokens"] == ref
    pull = _pull_stats(cold.url)
    assert pull["attempts"] == 1
    assert pull["blocks_imported"] >= 4
    assert pull["failures"] == 0 and pull["false_positives"] == 0
    assert pull["bytes_received"] > 0
    exp = _pull_stats(warm.url)
    assert exp["chain_exports"] == 1
    assert exp["chain_export_blocks"] >= 4
    # the pulled span was restored, not recomputed
    assert cold.engine.stats().host_kv_restored_tokens >= 16


def test_pull_from_reference_peer_token_identical(fleet_cleanup):
    """A port replica pulls a reference replica's chain (the
    reference's wire records) and serves the same tokens."""
    warm = ref_fleet.ReplicaServer(fx.ref_fleet_engine(host_kv_bytes=POOL),
                                   replica_id="ref-warm").start()
    cold = ReplicaServer(_engine(host_kv_bytes=POOL),
                         replica_id="port-cold").start()
    fleet_cleanup.extend([warm, cold])
    prompt = _prompt(27, PREFIX)
    ref = _reference_tokens(prompt)
    assert _gen(warm.url, {"prompt": prompt,
                           "max_new_tokens": 8})["tokens"] == ref
    pulled = _gen(cold.url, {"prompt": prompt, "max_new_tokens": 8,
                             "kv_pull": {"peer": warm.url, "tokens": 16}})
    assert pulled["tokens"] == ref
    pull = _pull_stats(cold.url)
    assert pull["blocks_imported"] >= 4 and pull["failures"] == 0


def test_pull_false_positive_degrades_to_recompute(fleet_cleanup):
    peer = ReplicaServer(_engine(host_kv_bytes=POOL),
                         replica_id="fp-peer").start()
    rep = ReplicaServer(_engine(host_kv_bytes=POOL),
                        replica_id="fp").start()
    fleet_cleanup.extend([peer, rep])
    prompt = _prompt(22, PREFIX)
    res = _gen(rep.url, {"prompt": prompt, "max_new_tokens": 8,
                         "kv_pull": {"peer": peer.url, "tokens": 16}})
    assert res["tokens"] == _reference_tokens(prompt)
    pull = _pull_stats(rep.url)
    assert pull["attempts"] == 1 and pull["false_positives"] == 1
    assert pull["failures"] == 0 and pull["blocks_imported"] == 0


def test_pull_corruption_degrades_to_recompute(fleet_cleanup):
    class _EvilPeer(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            body = json.dumps({"replica": "evil", "records": [
                {"key": "00" * 8, "parent": "11" * 8,
                 "tokens": [1, 2, 3, 4], "k": "AAAA", "v": "AAAA",
                 "digest": "feedfacefeedface"}]}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _EvilPeer)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    rep = ReplicaServer(_engine(host_kv_bytes=POOL),
                        replica_id="corrupt").start()
    fleet_cleanup.append(rep)
    try:
        prompt = _prompt(23, PREFIX)
        res = _gen(rep.url, {
            "prompt": prompt, "max_new_tokens": 8,
            "kv_pull": {"peer":
                        f"http://127.0.0.1:{srv.server_address[1]}",
                        "tokens": 16}})
        assert res["tokens"] == _reference_tokens(prompt)
        pull = _pull_stats(rep.url)
        assert pull["attempts"] == 1 and pull["failures"] == 1
        assert pull["blocks_imported"] == 0
    finally:
        srv.shutdown()
        srv.server_close()


def test_pull_timeout_degrades_to_recompute(fleet_cleanup, monkeypatch):
    """A peer that accepts and never answers costs the pull timeout (2 s
    here), then the request recomputes."""
    hole = socket.socket()
    hole.bind(("127.0.0.1", 0))
    hole.listen(4)
    monkeypatch.setenv("MXTPU_ROUTE_PULL_TIMEOUT", "2.0")
    rep = ReplicaServer(_engine(host_kv_bytes=POOL),
                        replica_id="hang").start()
    fleet_cleanup.append(rep)
    try:
        prompt = _prompt(24, PREFIX)
        res = _gen(rep.url, {
            "prompt": prompt, "max_new_tokens": 8,
            "kv_pull": {"peer":
                        f"http://127.0.0.1:{hole.getsockname()[1]}",
                        "tokens": 16}})
        assert res["tokens"] == _reference_tokens(prompt)
        pull = _pull_stats(rep.url)
        assert pull["attempts"] == 1 and pull["failures"] == 1
    finally:
        hole.close()


def test_pull_skipped_when_already_warm(fleet_cleanup):
    rep = ReplicaServer(_engine(host_kv_bytes=POOL),
                        replica_id="selfwarm").start()
    fleet_cleanup.append(rep)
    _gen(rep.url, {"prompt": _prompt(25, PREFIX), "max_new_tokens": 8})
    _gen(rep.url, {"prompt": _prompt(26, PREFIX), "max_new_tokens": 8,
                   "kv_pull": {"peer": "http://127.0.0.1:9",
                               "tokens": 16}})
    assert _pull_stats(rep.url)["attempts"] == 0


def test_chain_export_rejects_bad_prompt(fleet_cleanup):
    rep = ReplicaServer(_engine(host_kv_bytes=POOL),
                        replica_id="val").start()
    fleet_cleanup.append(rep)
    req = urllib.request.Request(
        f"{rep.url}/chain_export",
        data=json.dumps({"prompt": "nope"}).encode(),
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400


def test_router_attaches_pull_hint_end_to_end(fleet_cleanup):
    reps = [ReplicaServer(_engine(host_kv_bytes=POOL),
                          replica_id=f"p{i}").start()
            for i in range(2)]
    fleet_cleanup.extend(reps)
    router = Router([r.url for r in reps], scrape_interval_s=0,
                    timeout_s=30, retries=3, backoff_s=0.01,
                    backoff_max_s=0.05, affinity=1.0, pull=True)
    fleet_cleanup.append(router)
    router.scrape()
    first = router.generate(_prompt(31, PREFIX), max_new_tokens=4)
    router.scrape()
    warm = next(r for r in reps if r.replica_id == first.replica)
    other = next(r for r in reps if r.replica_id != first.replica)
    with router._lock:
        for state in router._replicas:
            if state.name == first.replica:
                state.load = 50.0
    ref = _reference_tokens(_prompt(32, PREFIX), max_new=4)
    res = router.generate(_prompt(32, PREFIX), max_new_tokens=4)
    assert res.replica == other.replica_id
    assert list(res.tokens) == ref
    assert _pull_stats(other.url)["attempts"] == 1
    assert _pull_stats(other.url)["blocks_imported"] >= 4
    assert _pull_stats(warm.url)["chain_exports"] == 1
