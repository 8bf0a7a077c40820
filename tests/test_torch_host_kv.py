"""The PyTorch port's host-DRAM KV tier against the JAX reference
(``mxnet_tpu_torch/serve/kv_block_manager.py`` ``HostKVPool`` and the
BlockManager's host hooks; ``serve/engine.py`` ``_restore_pending`` and
the ``restore`` program family).

Ports ``tests/test_host_kv_offload.py``: the pool and BlockManager
cases run on both packages with the reference's assertions, and the
randomized lifecycle stress runs one operation sequence through both
and compares every decision.  The engine cases hold the port's tier-on
token streams against the reference engine's cold streams (tokens
equal, float32 and int8 K/V), with real host-tier traffic checked each
time.  Added: the restore body against the reference's
``_build_restore`` bit for bit, and ``export_blocks`` against the
reference's on the same checkpoint (equal keys, equal bytes, the
reference's dtype names), with ``import_blocks`` taking either
package's records.

Left out, with their ROADMAP items: the tp=2 case (A13), and the
fleet-replica view (A14b).  The metrics-registry and ``/statusz`` views
of the tier are held against the reference's in
``tests/test_torch_observability.py``.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx
from torch_port_fixtures import \
    collect_engines_after_module  # noqa: F401  (autouse)

import mxnet_tpu as mx
from mxnet_tpu.serve import engine as ref_engine
from mxnet_tpu.serve import kv_block_manager as ref_kv
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.serve import engine as port_engine
from mxnet_tpu_torch.serve import kv_block_manager as port_kv

VOCAB = fx.VOCAB
PKGS = {"ref": ref_kv, "port": port_kv}
POOL = 1 << 24
ENGINE_KW = dict(block_size=4, num_blocks=64, max_batch=4, max_model_len=48,
                 max_prefills_per_step=2)


def _arrs(tag, nbytes=64):
    """A fake per-block host copy: one float32 array of ``nbytes``."""
    return (np.full(nbytes // 4, float(tag), np.float32),)


# -- HostKVPool units (both packages, the reference's assertions) ------------
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_pool_put_claim_budget_and_lru(pkg):
    p = PKGS[pkg].HostKVPool(256, block_tokens=4)
    assert p.put(b"a", None, _arrs(1)) and p.put(b"b", None, _arrs(2))
    assert len(p) == 2 and p.bytes_used == 128
    assert not p.put(b"huge", None, _arrs(9, nbytes=512))
    assert p.rejects == 1 and len(p) == 2
    assert p.put(b"c", None, _arrs(3)) and p.put(b"d", None, _arrs(4))
    assert p.put(b"e", None, _arrs(5))
    assert not p.has(b"a") and p.evictions >= 1
    assert p.discarded_tokens == p.evictions * 4
    assert p.bytes_used <= p.max_bytes
    got = p.claim(b"e")
    assert got is not None and got[0][0] == 5.0
    assert p.claim(b"e") is None and p.restores == 1
    p.clear()
    assert len(p) == 0 and p.bytes_used == 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_pool_leaf_discipline_protects_hosted_chains(pkg):
    p = PKGS[pkg].HostKVPool(192, block_tokens=4)
    assert p.put(b"child", b"root", _arrs(1))
    assert p.put(b"root", None, _arrs(2))
    assert p.put(b"x", None, _arrs(3))
    assert p.put(b"y", None, _arrs(4))
    assert not p.has(b"child") and p.has(b"root")
    assert p.put(b"z", None, _arrs(5))
    assert not p.has(b"root")


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_pool_insert_never_evicts_own_parent(pkg):
    p = PKGS[pkg].HostKVPool(128, block_tokens=4)
    p.put(b"A", None, _arrs(1))
    p.put(b"x", None, _arrs(2))
    assert p.put(b"B", b"A", _arrs(3))
    assert p.has(b"A") and p.has(b"B") and not p.has(b"x")
    assert p.stats()["bytes_peak"] == 128


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_pool_restore_delay_degrades_claim(pkg):
    p = PKGS[pkg].HostKVPool(1024, block_tokens=4)
    p.put(b"k", None, _arrs(7))
    p.fault_delay_s = 1.0
    p.restore_budget_s = 0.05
    assert p.claim(b"k") is None
    assert p.degraded == 1 and p.has(b"k")
    p.fault_delay_s = 0.0
    assert p.claim(b"k") is not None


def test_pool_stats_keys_match_reference():
    a, b = ref_kv.HostKVPool(512, 4), port_kv.HostKVPool(512, 4)
    for p in (a, b):
        p.put(b"k", None, _arrs(1))
    assert a.stats() == b.stats()
    with pytest.raises(ValueError, match="max_bytes"):
        port_kv.HostKVPool(0)


# -- BlockManager + pool bookkeeping -----------------------------------------
def _mgr(kv, num_blocks=16, block_size=4, pool_bytes=4096):
    pool = kv.HostKVPool(pool_bytes, block_tokens=block_size) \
        if pool_bytes else None
    m = kv.BlockManager(num_blocks, block_size, prefix_cache=True,
                        host_pool=pool)
    fetched = []
    if pool is not None:
        def fetch(blk):
            fetched.append(blk)
            return (np.full(16, float(blk), np.float32),)
        m.set_offload_source(fetch)
    return m, pool, fetched


def _parked_chain(kv, base):
    """A 2-block chain published, freed, then pushed into the host tier
    by a 17-token allocation ("b" holds it)."""
    m, pool, fetched = _mgr(kv, num_blocks=6)
    ids = list(range(base, base + 9))
    m.allocate("a", 9, token_ids=ids)
    m.note_tokens("a", ids)
    m.free("a", retain=True)
    m.allocate("b", 17)
    return m, pool, fetched, ids


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_eviction_offloads_and_host_walk_restores(pkg):
    m, pool, fetched, ids = _parked_chain(PKGS[pkg], 10)
    assert m.prefix_evictions >= 2 and len(pool) == 2
    assert fetched and m.prefix_discarded_tokens == 0
    assert m.prefix_stats()["discarded_tokens"] == 0
    m.free("b", retain=False)
    assert m.prefix_probe(ids) == (0, 8)
    t2, cached = m.allocate("c", 10, token_ids=ids)
    assert cached == 8 and m.host_hits == 1
    assert m.host_restored_tokens == 8 and len(pool) == 0
    pend = m.take_pending_restores()
    assert sorted(b for b, _ in pend) == sorted(t2[:2])
    assert [a[0][0] for _, a in pend]
    assert m.take_pending_restores() == []
    assert m.host_tokens("c") == 8
    t3, c3 = m.allocate("d", 10, token_ids=ids)
    assert c3 == 8 and t3[:2] == t2[:2]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_failed_allocate_unclaims_host_entries(pkg):
    kv = PKGS[pkg]
    m, pool, _, ids = _parked_chain(kv, 20)
    assert len(pool) == 2
    with pytest.raises(kv.NoFreeBlocks):
        m.allocate("c", 17, token_ids=ids)
    assert len(pool) == 2
    m.free("b", retain=False)
    _, cached = m.allocate("c2", 10, token_ids=ids)
    assert cached == 8


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_discarded_tokens_without_pool(pkg):
    m, _, _ = _mgr(PKGS[pkg], num_blocks=5, pool_bytes=0)
    ids = list(range(30, 39))
    m.allocate("a", 9, token_ids=ids)
    m.note_tokens("a", ids)
    m.free("a", retain=True)
    m.allocate("b", 13)
    stats = m.prefix_stats()
    assert m.prefix_evictions >= 1
    assert stats["discarded_tokens"] == m.prefix_evictions * 4
    assert stats["host_hits"] == 0 and m.host_stats() is None


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_free_before_restore_drain_reparks_host_copy(pkg):
    m, pool, _, ids = _parked_chain(PKGS[pkg], 50)
    m.free("b", retain=False)
    _, cached = m.allocate("c", 10, token_ids=ids)
    assert cached == 8 and len(m._pending_restores) == 2
    m.free("c", retain=True)
    assert m.take_pending_restores() == []
    assert len(pool) == 2
    assert m.prefix_probe(ids) == (0, 8)
    _, cached = m.allocate("d", 10, token_ids=ids)
    assert cached == 8
    assert len(m.take_pending_restores()) == 2


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_degraded_claim_truncates_restored_span(pkg):
    m, pool, _, ids = _parked_chain(PKGS[pkg], 40)
    m.free("b", retain=False)
    pool.fault_delay_s, pool.restore_budget_s = 1.0, 0.01
    _, cached = m.allocate("c", 10, token_ids=ids)
    assert cached == 0
    assert pool.degraded >= 1 and m.host_hits == 0
    assert m.take_pending_restores() == []
    assert len(pool) == 2


def test_reset_keeps_hosted_entries_and_drops_queued_restores():
    m, pool, _, ids = _parked_chain(port_kv, 60)
    m.free("b", retain=False)
    m.allocate("c", 10, token_ids=ids)
    pool.put(b"other", None, _arrs(3))
    m.reset()
    assert m.take_pending_restores() == [] and m.blocks_in_use == 0
    assert pool.has(b"other") and m.free_blocks == m.total_blocks


# -- randomized lifecycle stress: one sequence, both packages ----------------
def _check_invariants(m, pool):
    with m._lock:
        free = list(m._free)
        assert len(free) == len(set(free)) and 0 not in free
        refs = {}
        for table in m._tables.values():
            for blk in table:
                refs[blk] = refs.get(blk, 0) + 1
        assert refs == m._refs
        lru = set(m._lru.values())
        retained = [b for bs in m._retained.values() for b in bs]
        assert len(retained) == len(set(retained))
        groups = [set(free), set(refs), lru, set(retained)]
        for i in range(len(groups)):
            for j in range(i + 1, len(groups)):
                assert groups[i].isdisjoint(groups[j])
        assert set().union(*groups) == set(range(1, m.num_blocks))
        for key, blk in m._index.items():
            assert m._key_of[blk] == key
        assert set(m._lru) <= set(m._index)
        for blk, _ in m._pending_restores:
            assert m._refs.get(blk, 0) >= 1 and blk in m._key_of
    with pool._lock:
        assert pool.bytes_used <= pool.max_bytes
        assert pool.bytes_used == sum(n for _, _, n in pool._entries.values())


def _stress(kv):
    """The reference's stress sequence (seed 1234, 400 operations, a
    256-byte pool) on ``kv``; returns what each operation decided."""
    rng = np.random.RandomState(1234)
    m, pool, _ = _mgr(kv, num_blocks=12, block_size=4, pool_bytes=256)
    master = rng.randint(0, 7, 64).tolist()
    live, trail, n = [], [], 0

    def some_ids():
        take = int(rng.randint(4, 40))
        tail = rng.randint(0, 7, int(rng.randint(0, 6))).tolist()
        return master[:take] + tail

    for _ in range(400):
        op = rng.randint(0, 6)
        out = None
        if op == 0 or not live:
            rid, n = f"r{n}", n + 1
            ids = some_ids()
            try:
                out = m.allocate(rid, len(ids) + 1, token_ids=ids)
                live.append((rid, ids))
            except kv.NoFreeBlocks:
                out = "full"
        elif op == 1:
            rid, ids = live[rng.randint(len(live))]
            m.note_tokens(rid, ids)
        elif op == 2:
            rid, _ = live.pop(rng.randint(len(live)))
            m.free(rid, retain=bool(rng.randint(2)))
        elif op == 3:
            rid, ids = live[rng.randint(len(live))]
            out = m.truncate(rid, int(rng.randint(1, len(ids) + 2)))
        elif op == 4:
            rid, ids = live[rng.randint(len(live))]
            try:
                out = m.ensure_capacity(rid, m.capacity(rid) + 1)
            except kv.NoFreeBlocks:
                out = "full"
        else:
            out = [b for b, _ in m.take_pending_restores()]
        _check_invariants(m, pool)
        trail.append((op, out, m.prefix_stats(), pool.stats()))
    return trail, pool


def test_block_manager_stress_matches_reference():
    ref, _ = _stress(ref_kv)
    port, pool = _stress(port_kv)
    assert pool.offloads > 0 and pool.restores > 0 and pool.evictions > 0
    assert port == ref


# -- the restore program against the reference's -----------------------------
@pytest.mark.parametrize("kv_quant", [False, True])
def test_restore_body_matches_reference_bit_for_bit(kv_quant):
    """The port's restore body and the reference's ``_build_restore`` on
    the same seeded cache and payload (3 blocks, padded to bucket 4 with
    the null block): every block but the null one equal bit for bit."""
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    L, nb, bs, H, D, R = 2, 10, 4, 2, 8, 4
    cdt = np.int8 if kv_quant else np.float32

    def draw(shape):
        if kv_quant:
            return rng.randint(-127, 128, shape).astype(np.int8)
        return rng.randn(*shape).astype(np.float32)

    ck, cv = draw((L, nb, bs, H, D)), draw((L, nb, bs, H, D))
    hk, hv = draw((L, R, bs, H, D)), draw((L, R, bs, H, D))
    blks = np.array([7, 2, 5, 0], np.int32)
    scales = ()
    if kv_quant:
        scales = tuple(rng.rand(*s).astype(np.float32) for s in
                       ((L, nb, bs, H), (L, nb, bs, H), (L, R, bs, H),
                        (L, R, bs, H)))
    cfg = ref_engine._ModelCfg(
        name="gpt", n_layers=L, num_heads=H, head_dim=D, kv_heads=H,
        pos_table=None, swiglu=False, tied=False, rmsnorm=False, window=0,
        block_size=bs, sampling=False, sample_cap=0, numeric_watch=False,
        kv_quant=kv_quant)
    fn = ref_engine._build_restore(cfg, donate=False)
    caches = (ck, cv) + scales[:2]
    payload = (hk, hv) + scales[2:]
    want = fn(*(jnp.asarray(a) for a in caches), jnp.asarray(blks),
              *(jnp.asarray(a) for a in payload))
    fields = [("blks", (R,)), ("hk", hk.shape, torch.int8 if kv_quant
                              else torch.float32),
              ("hv", hv.shape, torch.int8 if kv_quant else torch.float32)]
    if kv_quant:
        fields += [("hks", scales[2].shape, torch.float32),
                   ("hvs", scales[3].shape, torch.float32)]
    got = [torch.from_numpy(a.copy()) for a in caches]
    body = port_engine.functools.partial(
        port_engine._restore, ck=got[0], cv=got[1],
        ksc=got[2] if kv_quant else None, vsc=got[3] if kv_quant else None)
    prog = port_engine._Program(fields, body, torch.device("cpu"))
    h = prog.stage()
    h["blks"][:] = blks
    for name, a in zip(("hk", "hv", "hks", "hvs"), payload):
        h[name][:] = a
    assert prog() is None
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy()[:, 1:].tobytes() == w[:, 1:].tobytes()
    # the padding row wrote the null block only
    for g, c in zip(got, caches):
        assert np.array_equal(g.numpy()[:, [1, 3, 4, 6, 8, 9]],
                              c[:, [1, 3, 4, 6, 8, 9]])
    assert cdt == got[0].numpy().dtype


# -- engine parity (tiny models) ---------------------------------------------
def _ref(params, heads, **kw):
    return mx.serve.Engine(params, num_heads=heads, **{**ENGINE_KW, **kw})


def _port(params, heads, **kw):
    return mt.serve.Engine(params, num_heads=heads, device="cpu",
                           **{**ENGINE_KW, **kw})


def _churn(make, params, heads, kw, max_new=8, seed=7):
    """The reference's recipe: serve a prompt, churn its chain out of a
    16-block cache with three other prompts, serve it again."""
    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, VOCAB, (24,)).astype(np.int32)
    fills = [rng.randint(0, VOCAB, (24,)).astype(np.int32)
             for _ in range(3)]
    eng = make(params, heads, **kw)
    first = eng.submit(prompt, max_new_tokens=max_new)
    eng.run()
    for f in fills:
        eng.submit(f, max_new_tokens=max_new)
        eng.run()
    again = eng.submit(prompt, max_new_tokens=max_new)
    eng.run()
    st = eng.stats()
    eng.shutdown()
    return first.tokens, again.tokens, st


def _cold(params, heads, kw, max_new=8, seed=7):
    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, VOCAB, (24,)).astype(np.int32)
    eng = _ref(params, heads, prefix_cache=False, **kw)
    req = eng.submit(prompt, max_new_tokens=max_new)
    eng.run()
    eng.shutdown()
    return req.tokens


def _host_stats(st):
    return (st.host_kv_hits, st.host_kv_restored_tokens,
            st.host_kv_offloads, st.prefix_discarded_tokens)


def test_offload_identity_gpt():
    """After the prefix LRU churns the chain out, the re-served prompt
    restores from the host and its tokens equal the reference's cold
    engine's; the port's tier decides as the reference's tier-on
    engine does."""
    _, params, heads = fx.model("gpt2")
    want = _cold(params, heads, {})
    kw = dict(num_blocks=16, host_kv_bytes=POOL)
    first, again, st = _churn(_port, params, heads, kw)
    r_first, r_again, r_st = _churn(_ref, params, heads, kw)
    assert first == again == want == r_first == r_again
    assert st.host_kv_hits > 0 and st.host_kv_restored_tokens > 0
    assert st.host_kv_offloads > 0 and st.prefix_discarded_tokens == 0
    assert _host_stats(st) == _host_stats(r_st)


def test_offload_identity_llama_gqa_int8():
    """The llama/GQA variant over int8 K/V: the int8 slots and their
    float32 scales round-trip the host tier."""
    _, params, heads = fx.model("llama")
    want = _cold(params, heads, dict(kv_dtype="int8"))
    first, again, st = _churn(_port, params, heads,
                              dict(kv_dtype="int8", num_blocks=16,
                                   host_kv_bytes=POOL))
    assert first == again == want
    assert st.host_kv_hits > 0


def test_offload_under_preemption_pressure():
    _, params, heads = fx.model("gpt2")
    rng = np.random.RandomState(17)
    prompts = [rng.randint(0, VOCAB, (16,)).astype(np.int32)
               for _ in range(6)]

    def run(make, **kw):
        eng = make(params, heads, **kw)
        reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
        eng.run()
        st = eng.stats()
        eng.shutdown()
        return [r.tokens for r in reqs], [r.status for r in reqs], st

    calm, calm_status, calm_st = run(_ref, num_blocks=64)
    tight, status, st = run(_port, num_blocks=22, host_kv_bytes=POOL)
    assert calm_st.preemptions == 0
    assert st.preemptions > 0, "no cache pressure — vacuous"
    assert st.host_kv_offloads > 0
    assert status == calm_status == ["finished"] * 6
    assert tight == calm


def test_offload_with_chunked_prefill():
    _, params, heads = fx.model("gpt2")
    rng = np.random.RandomState(23)
    prefix = rng.randint(0, VOCAB, (16,)).astype(np.int32)
    long_a = np.concatenate([prefix, rng.randint(0, VOCAB, (20,))
                             .astype(np.int32)])
    long_b = np.concatenate([prefix, rng.randint(0, VOCAB, (20,))
                             .astype(np.int32)])
    fills = [rng.randint(0, VOCAB, (24,)).astype(np.int32)
             for _ in range(3)]

    def run(make, **kw):
        eng = make(params, heads, prefill_chunk=8, **kw)
        out = []
        for p in (long_a, *fills, long_b):
            out.append(eng.submit(p, max_new_tokens=8))
            eng.run()
        st = eng.stats()
        eng.shutdown()
        return [r.tokens for r in out], st

    want, _ = run(_ref, num_blocks=64, prefix_cache=False)
    got, st = run(_port, num_blocks=16, host_kv_bytes=POOL)
    assert st.host_kv_hits > 0, "chunked run never hit the host tier"
    assert got == want


def test_offload_with_spec_decode_verify():
    """Speculative decoding over a restored prefix: the verify reads
    restored blocks and truncate's rollback composes with the
    republished chain."""
    _, params, heads = fx.model("gpt2")
    src, draft = dict(params), {k: v for k, v in params.items()
                                if not k.startswith("gpt_l1_")}
    for k, v in params.items():
        if k.startswith("gpt_l1_") and (k.endswith("proj_weight")
                                        or k.endswith("ff_down_weight")):
            src[k] = v * 0.05
    spec = dict(spec_k=2, draft_params=draft, draft_num_heads=4,
                draft_window=0)
    want = _cold(src, heads, spec)
    first, again, st = _churn(_port, src, heads,
                              dict(num_blocks=16, host_kv_bytes=POOL,
                                   **spec))
    assert first == again == want
    assert st.host_kv_hits > 0
    assert st.spec_verifies > 0, "spec never verified — vacuous"


def test_restore_delay_fault_degrades_to_recompute(monkeypatch):
    monkeypatch.setenv("MXTPU_FAULT_HOST_RESTORE_DELAY", "30")
    monkeypatch.setenv("MXTPU_SERVE_HOST_KV_RESTORE_BUDGET", "0.05")
    _, params, heads = fx.model("gpt2")
    first, again, st = _churn(_port, params, heads,
                              dict(num_blocks=16, host_kv_bytes=POOL))
    monkeypatch.delenv("MXTPU_FAULT_HOST_RESTORE_DELAY")
    monkeypatch.delenv("MXTPU_SERVE_HOST_KV_RESTORE_BUDGET")
    assert first == again == _cold(params, heads, {})
    assert st.host_kv_hits == 0
    assert st.host_kv_degraded > 0
    assert st.host_kv_offloads > 0


def test_host_kv_off_is_inert(monkeypatch):
    """``MXTPU_SERVE_HOST_KV_BYTES=0`` and unset agree: no pool, no
    restore family, the same grid and fingerprint, zeroed stats; the
    tier on adds only the restore family and keeps the fingerprint."""
    _, params, heads = fx.model("gpt2")
    monkeypatch.setenv("MXTPU_SERVE_HOST_KV_BYTES", "0")
    eng0 = _port(params, heads)
    monkeypatch.delenv("MXTPU_SERVE_HOST_KV_BYTES")
    eng_def = _port(params, heads)
    assert eng0._host_pool is None and eng_def._host_pool is None
    assert eng0._warmup_grid() == eng_def._warmup_grid()
    assert all(g["kind"] != "restore" for g in eng0._warmup_grid())
    assert eng0._fingerprint() == eng_def._fingerprint()
    assert eng0.host_kv_stats() is None
    st = eng0.stats()
    assert st.host_kv_hits == st.host_kv_offloads == 0
    assert st.host_kv_bytes_used == 0
    on = _port(params, heads, host_kv_bytes=POOL)
    off_kinds = {g["kind"] for g in eng_def._warmup_grid()}
    on_kinds = {g["kind"] for g in on._warmup_grid()}
    assert on_kinds - off_kinds == {"restore"}
    assert [g["bucket"] for g in on._warmup_grid()
            if g["kind"] == "restore"] == [1, 2, 4, 8, 12]
    assert on._fingerprint() == eng_def._fingerprint()
    for e in (eng0, eng_def, on):
        e.shutdown()


def test_warmup_from_tier_off_manifest_warms_restore():
    _, params, heads = fx.model("gpt2")
    off = _port(params, heads)
    rng = np.random.RandomState(53)
    off.submit(rng.randint(0, VOCAB, (12,)).astype(np.int32),
               max_new_tokens=4)
    off.run()
    man = off.manifest()
    assert man and all(e["kind"] != "restore" for e in man)
    off.shutdown()
    on = _port(params, heads, host_kv_bytes=POOL)
    ready = on.warmup(man)
    assert ready > len(man)
    assert {b for k, b in on._programs if k == "restore"} == {1, 2, 4, 8,
                                                               12}
    on.shutdown()


def test_env_budget_default_and_arg_wins(monkeypatch):
    _, params, heads = fx.model("gpt2")
    monkeypatch.setenv("MXTPU_SERVE_HOST_KV_BYTES", "65536")
    eng = _port(params, heads)
    assert eng._host_pool is not None and eng._host_pool.max_bytes == 65536
    eng.shutdown()
    eng = _port(params, heads, host_kv_bytes=0)
    assert eng._host_pool is None
    eng.shutdown()
    with pytest.raises(ValueError, match="host_kv_bytes"):
        _port(params, heads, host_kv_bytes=-1)


def test_shutdown_releases_pool_back_to_back_engines():
    _, params, heads = fx.model("gpt2")
    eng = _port(params, heads, num_blocks=16, host_kv_bytes=POOL)
    rng = np.random.RandomState(31)
    for _ in range(4):
        eng.submit(rng.randint(0, VOCAB, (24,)).astype(np.int32),
                   max_new_tokens=8)
        eng.run()
    pool = eng._host_pool
    assert len(pool) > 0 and eng.host_kv_stats()["entries"] > 0
    eng.shutdown()
    assert len(pool) == 0 and pool.bytes_used == 0
    assert eng._host_pool is None
    eng2 = _port(params, heads, num_blocks=16, host_kv_bytes=POOL)
    req = eng2.submit(rng.randint(0, VOCAB, (12,)).astype(np.int32),
                      max_new_tokens=4)
    eng2.run()
    assert req.status == "finished"
    assert eng2.host_kv_stats()["offloads"] == 0
    eng2.shutdown()


def test_stats_expose_host_tier():
    """ServeStats and the engine's host-tier and prefix views agree on
    the tier's counters (the reference's statusz case, its statusz
    sections read through the methods that feed them)."""
    _, params, heads = fx.model("gpt2")
    eng = _port(params, heads, num_blocks=16, host_kv_bytes=POOL)
    rng = np.random.RandomState(41)
    prompt = rng.randint(0, VOCAB, (24,)).astype(np.int32)
    eng.submit(prompt, max_new_tokens=8)
    eng.run()
    for _ in range(3):
        eng.submit(rng.randint(0, VOCAB, (24,)).astype(np.int32),
                   max_new_tokens=8)
        eng.run()
    eng.submit(prompt, max_new_tokens=8)
    eng.run()
    hk, st, pfx = eng.host_kv_stats(), eng.stats(), eng.blocks.prefix_stats()
    assert hk["max_bytes"] == POOL
    assert hk["offloads"] == st.host_kv_offloads > 0
    assert hk["bytes_used"] == st.host_kv_bytes_used
    # K + V of 2 layers x 4 slots x 4 kv heads x 8 dims, float32
    assert hk["block_bytes"] == 2 * 2 * 4 * 4 * 8 * 4
    assert pfx["host_hits"] == st.host_kv_hits > 0
    assert pfx["host_restored_tokens"] == st.host_kv_restored_tokens
    assert pfx["discarded_tokens"] == st.prefix_discarded_tokens
    eng.shutdown()


# -- prefill/decode handoff primitives ---------------------------------------
def _bits(a):
    """Raw bytes of a host copy, numpy or torch (bfloat16 as int16)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.contiguous().numpy().tobytes()
    a = np.ascontiguousarray(a)
    return (a.view(np.int16) if a.dtype.name == "bfloat16" else a).tobytes()


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_export_blocks_equal_reference(kv):
    """The same checkpoint and prompt served by both engines: the port's
    ``export_blocks`` records carry the reference's keys, parents, ids,
    dtype names and shapes, and ``host_block_spec``'s layout; the K/V
    agree to float32 rounding (int8: one quantum); on the reference's
    cache bytes (copied into the port's cache) the records are the same
    bytes.  The records import into a fresh port tier, the reference's
    (ml_dtypes numpy) and the port's alike, and restore to the same
    tokens; the reference imports the port's."""
    _, params, heads = fx.model("llama")
    kw = {} if kv == "float32" else dict(kv_dtype="int8")
    prompt = np.random.RandomState(3).randint(0, VOCAB, (21,)).astype(
        np.int32)
    ref = _ref(params, heads, **kw)
    port = _port(params, heads, **kw)
    recs = {}
    for tag, eng in (("ref", ref), ("port", port)):
        req = eng.submit(prompt, max_new_tokens=4)
        eng.run()
        recs[tag] = (req, eng.blocks.export_blocks(req.rid, prompt))
    (rreq, rrec), (preq, prec) = recs["ref"], recs["port"]
    assert preq.tokens == rreq.tokens and len(prec) == len(rrec) == 5
    spec = port.host_block_spec()
    assert spec == [(s, str(d)) for s, d in ref.host_block_spec()]
    for (k, pk, t, a), (rk, rpk, rt, ra) in zip(prec, rrec):
        assert (k, pk, t) == (rk, rpk, rt)
        assert [(tuple(x.shape), port_kv.dtype_name(x)) for x in a] == \
            [(x.shape, str(x.dtype)) for x in ra] == spec
        for x, rx in zip(a, ra):
            d = np.abs(x.numpy().astype(np.float64) - np.asarray(rx))
            assert d.max() <= (1 if x.dtype == torch.int8 else
                               1e-5 * max(1.0, np.abs(rx).max()))
    # the reference's cache bytes in the port's cache: equal records
    for name in ("_cache_k", "_cache_v", "_scale_k", "_scale_v"):
        if getattr(port, name) is not None:
            getattr(port, name).copy_(port_kv.host_tensor(
                np.asarray(getattr(ref, name))))
    same = port.blocks.export_blocks(preq.rid, prompt)
    assert [[_bits(x) for x in r[3]] for r in same] == \
        [[_bits(x) for x in r[3]] for r in rrec]
    eng2 = _port(params, heads, host_kv_bytes=POOL, **kw)
    keys = [r[0] for r in rrec]
    assert eng2.ingest_pulled_blocks(rrec) == (5, 0, 0)
    assert eng2.blocks.has_blocks(keys) == keys
    assert eng2.ingest_pulled_blocks(prec) == (0, 5, 0)
    req = eng2.submit(prompt, max_new_tokens=4)
    eng2.run()
    st = eng2.stats()
    assert st.host_kv_restored_tokens == 20
    assert st.prefill_tokens_computed == 1
    assert req.tokens == rreq.tokens
    # a corrupted record breaks the chain there
    bad = list(prec)
    bad[2] = (bad[2][0], bad[2][1], [0] * 4, bad[2][3])
    eng3 = _port(params, heads, host_kv_bytes=POOL, **kw)
    assert eng3.ingest_pulled_blocks(bad) == (2, 0, 3)
    pool = ref_kv.HostKVPool(POOL, 4)
    m = ref_kv.BlockManager(64, 4, prefix_cache=True, host_pool=pool)
    assert m.import_blocks(
        [(k, pk, t, tuple(x.numpy() for x in a)) for k, pk, t, a in prec]
    ) == (5, 0, 0)
    for e in (ref, port, eng2, eng3):
        e.shutdown()


def test_bf16_host_copies_equal_reference_bytes():
    """bfloat16 caches holding the same bits: the port's host copy of a
    block (a bfloat16 CPU tensor) and the reference's (an ml_dtypes
    array) are the same bytes; ``host_tensor`` turns the reference's
    into the port's, and ``dtype_name`` names both "bfloat16"."""
    import jax.numpy as jnp

    _, params, heads = fx.model("gpt2")
    ref = _ref(params, heads)
    port = _port(params, heads, dtype=torch.bfloat16)
    rng = np.random.RandomState(8)
    vals = [rng.randn(*port._cache_k.shape).astype(jnp.bfloat16)
            for _ in range(2)]
    ref._cache_k, ref._cache_v = (jnp.asarray(v) for v in vals)
    port._cache_k.copy_(port_kv.host_tensor(vals[0]))
    port._cache_v.copy_(port_kv.host_tensor(vals[1]))
    for blk in (1, 17, 63):
        got, want = port._host_kv_fetch(blk), ref._host_kv_fetch(blk)
        assert [port_kv.dtype_name(x) for x in got] == ["bfloat16"] * 2
        assert [str(x.dtype) for x in want] == ["bfloat16"] * 2
        assert [x.view(torch.int16).numpy().tobytes() for x in got] == \
            [x.view(np.int16).tobytes() for x in want]
        assert all(torch.equal(port_kv.host_tensor(w), g)
                   for g, w in zip(got, want))
    ref.shutdown()
    port.shutdown()
