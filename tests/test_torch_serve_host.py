"""Serving host side of the PyTorch port against the JAX reference:
content-addressed block keys, block-manager accounting and the
scheduler's decisions (all numpy-only in both packages).

Keys must be byte-identical across the packages (a later fleet port
routes between them).  Block-manager and scheduler scenarios run the
same operation sequence through both and compare what they decide.
Scheduler ``Request`` rids come from per-package counters, so
scheduling outcomes are compared by request ORDER, never by rid.
"""

import numpy as np
import pytest

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

from mxnet_tpu.serve import kv_block_manager as ref_kv
from mxnet_tpu.serve import scheduler as ref_sched
from mxnet_tpu.serve import stats as ref_stats
from mxnet_tpu_torch.serve import kv_block_manager as port_kv
from mxnet_tpu_torch.serve import scheduler as port_sched
from mxnet_tpu_torch.serve import stats as port_stats

PKGS = {"ref": (ref_kv, ref_sched), "port": (port_kv, port_sched)}


# -- keys ---------------------------------------------------------------------
@pytest.mark.parametrize("salt", [None, "", "adapter-a", "tenant/7"])
def test_roots_and_block_keys_byte_identical(salt):
    assert port_kv.salted_root(salt) == ref_kv.salted_root(salt)
    root = ref_kv.salted_root(salt)
    for toks in ([], [0], [1, 2, 3, 4], list(range(16)), [2 ** 31 - 1, -5]):
        assert port_kv._block_key(root, toks) == ref_kv._block_key(root, toks)


@pytest.mark.parametrize("n,bs,max_blocks,salt", [
    (0, 4, None, None), (3, 4, None, None), (4, 4, None, None),
    (5, 4, None, None), (17, 4, None, "a"), (64, 16, None, None),
    (65, 16, 2, "b"), (40, 1, None, None), (12, 0, None, None)])
def test_chain_keys_byte_identical(n, bs, max_blocks, salt):
    toks = np.random.RandomState(n).randint(0, 50304, (n,)).astype(np.int32)
    assert (port_kv.chain_keys(toks, bs, max_blocks, salt)
            == ref_kv.chain_keys(toks, bs, max_blocks, salt))
    assert port_kv.blocks_for(n, max(bs, 1)) == ref_kv.blocks_for(
        n, max(bs, 1))


# -- block manager --------------------------------------------------------------
def _snapshot(m, rids):
    tables = {r: m.table(r) for r in rids if r in m._tables}
    return {"tables": tables, "refs": dict(m._refs),
            "free": m.free_blocks, "in_use": m.blocks_in_use,
            "retained": m.retained_blocks, "evictions": m.evictions,
            "free_list": list(m._free), "caps": {r: m.capacity(r)
                                                  for r in tables},
            "reclaimable": {r: m.reclaimable_blocks(r) for r in tables},
            "prefix": m.prefix_stats()}


def _run_sequence(kv, prefix_cache):
    """One allocate/note/free/evict/ensure/truncate script; returns the
    accounting snapshot after every operation and each op's result."""
    m = kv.BlockManager(num_blocks=13, block_size=4,
                        prefix_cache=prefix_cache)
    rng = np.random.RandomState(0)
    shared = rng.randint(0, 97, (10,)).astype(np.int32)
    a_ids = np.concatenate([shared, rng.randint(0, 97, (3,))])
    b_ids = np.concatenate([shared, rng.randint(0, 97, (6,))])
    trail, rids = [], ["a", "b", "c", "d"]

    def op(fn, *args, **kw):
        try:
            res = fn(*args, **kw)
        except kv.NoFreeBlocks:
            res = "NoFreeBlocks"
        trail.append((fn.__name__, args[:1], res, _snapshot(m, rids)))

    op(m.allocate, "a", a_ids.size + 1, token_ids=a_ids)
    op(m.note_tokens, "a", a_ids)
    op(m.allocate, "b", b_ids.size + 1, token_ids=b_ids)   # prefix hit
    op(m.note_tokens, "b", b_ids)
    op(m.ensure_capacity, "a", 20)
    op(m.free, "a")
    op(m.allocate, "c", 24)                                # evicts
    op(m.ensure_capacity, "b", 24)
    op(m.truncate, "b", 9)
    op(m.free, "b")
    op(m.allocate, "a", a_ids.size + 1, token_ids=a_ids)   # resurrection?
    op(m.allocate, "d", 40)                                # NoFreeBlocks
    op(m.free, "c", retain=False)
    op(m.allocate, "d", 16, token_ids=b_ids)
    op(m.free, "a")
    op(m.free, "d")
    op(m.allocate, "b", 48)
    return trail


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_block_manager_sequence_matches_reference(prefix_cache):
    ref = _run_sequence(ref_kv, prefix_cache)
    port = _run_sequence(port_kv, prefix_cache)
    assert len(ref) == len(port)
    for (rn, ra, rr, rs), (pn, pa, pr, ps) in zip(ref, port):
        assert (rn, ra, rr) == (pn, pa, pr)
        assert rs == ps, (rn, ra)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_block_alloc_free_invariants(pkg):
    """tests/test_serve.py's block-manager invariants, on both."""
    kv, _ = PKGS[pkg]
    m = kv.BlockManager(num_blocks=9, block_size=4, prefix_cache=False)
    t = m.allocate("a", 10)
    assert len(t) == 3 and 0 not in t
    assert m.ensure_capacity("a", 12) == t
    assert len(m.ensure_capacity("a", 13)) == 4 and m.capacity("a") == 16
    with pytest.raises(ValueError):
        m.allocate("a", 4)
    m.free("a")
    assert m.blocks_in_use == 0 and m.free_blocks == 8
    m2 = kv.BlockManager(num_blocks=5, block_size=2, prefix_cache=False)
    m2.allocate("a", 4), m2.allocate("b", 4)
    m2.free("a"), m2.free("b")
    m2.allocate("c", 3)
    assert m2.evictions == 1 and "b" in m2._retained
    m2.allocate("d", 4)
    with pytest.raises(kv.NoFreeBlocks):
        m2.allocate("e", 1)
    assert m2.blocks_in_use == 4 and m2.free_blocks == 0


def test_port_block_manager_refuses_a_host_pool():
    with pytest.raises(NotImplementedError, match="item 8"):
        port_kv.BlockManager(9, 4, host_pool=object())
    m = port_kv.BlockManager(9, 4)
    assert m.host_stats() is None and m.host_tokens("x") == 0


# -- scheduler ----------------------------------------------------------------
def _req(sched, n_prompt, max_new=4, deadline_s=None):
    return sched.Request(np.arange(1, n_prompt + 1), max_new,
                         deadline_s=deadline_s)


def _idx(reqs, picked):
    return [reqs.index(r) for r in picked]


def _scenario_backpressure(kv, sched):
    m = kv.BlockManager(num_blocks=9, block_size=4, prefix_cache=False)
    s = sched.Scheduler(m, max_batch=2, max_queue=2, clock=lambda: 0.0,
                        prefill_chunk=0)
    s.submit(_req(sched, 4)), s.submit(_req(sched, 4))
    with pytest.raises(sched.QueueFull):
        s.submit(_req(sched, 4))
    return {"depth": s.queue_depth, "rejections": s.rejections,
            "reasons": dict(s.reject_reasons)}


def _scenario_reject(kv, sched):
    t = {"now": 0.0}
    m = kv.BlockManager(num_blocks=5, block_size=2, prefix_cache=False)
    s = sched.Scheduler(m, max_batch=2, max_queue=8, clock=lambda: t["now"],
                        prefill_chunk=0)
    giant = s.submit(sched.Request(np.arange(1, 8), 4))
    late = s.submit(_req(sched, 2, deadline_s=1.0))
    gone = s.submit(_req(sched, 2, deadline_s=0.0))
    t["now"] = 2.0
    prefills, decodes = s.schedule()
    return {"giant": (giant.status, giant.reject_reason),
            "late": (late.status, late.reject_reason),
            "gone": (gone.status, gone.reject_reason),
            "work": (len(prefills), len(decodes)),
            "rejections": s.rejections, "reasons": dict(s.reject_reasons),
            "tenants": s.tenant_stats()}


def _scenario_fifo(kv, sched):
    m = kv.BlockManager(num_blocks=6, block_size=2, prefix_cache=False)
    s = sched.Scheduler(m, max_batch=4, max_queue=8,
                        max_prefills_per_step=4, clock=lambda: 0.0,
                        prefill_chunk=0)
    reqs = [s.submit(_req(sched, 4, max_new=2)) for _ in range(4)]
    prefills, _ = s.schedule()
    return {"prefills": _idx(reqs, prefills),
            "waiting": _idx(reqs, s.waiting)}


def _scenario_preempt(kv, sched):
    m = kv.BlockManager(num_blocks=7, block_size=2, prefix_cache=False)
    s = sched.Scheduler(m, max_batch=3, max_queue=8,
                        max_prefills_per_step=3, clock=lambda: 0.0,
                        prefill_chunk=0)
    reqs = [s.submit(_req(sched, 3, 8)), s.submit(_req(sched, 3, 8))]
    out = []
    prefills, _ = s.schedule()
    out.append(_idx(reqs, prefills))
    s.running.extend(prefills)
    for cache_len in (4, 6):
        for r in reqs:
            r.cache_len = cache_len
        prefills, decodes = s.schedule()
        out.append((_idx(reqs, prefills), _idx(reqs, decodes),
                    m.free_blocks))
    out.append([(r.n_preemptions, r.cache_len, r.status) for r in reqs])
    out.append(s.preemptions)
    return out


def _scenario_tenant_share(kv, sched):
    m = kv.BlockManager(num_blocks=64, block_size=4, prefix_cache=False)
    s = sched.Scheduler(m, max_batch=2, max_queue=4, clock=lambda: 0.0,
                        tenant_share=0.5, prefill_chunk=0)
    reqs, outcomes = [], []
    for tenant in ("a", "a", "a", "b", "b", "c"):
        r = sched.Request(np.arange(1, 5), 2, tenant=tenant)
        reqs.append(r)
        try:
            s.submit(r)
        except sched.QueueFull:
            r.status = "queue_full"
        outcomes.append((r.status, r.reject_reason))
    prefills, _ = s.schedule()
    return {"outcomes": outcomes, "prefills": _idx(reqs, prefills),
            "waiting": _idx(reqs, s.waiting), "tenants": s.tenant_stats()}


@pytest.mark.parametrize("scenario", [_scenario_backpressure,
                                      _scenario_reject, _scenario_fifo,
                                      _scenario_preempt,
                                      _scenario_tenant_share])
def test_scheduler_scenarios_match_reference(scenario):
    assert scenario(*PKGS["port"]) == scenario(*PKGS["ref"])


def test_reservoir_percentiles_match_reference():
    vals = np.random.RandomState(0).rand(5000)
    a, b = ref_stats.Reservoir(capacity=256), port_stats.Reservoir(
        capacity=256)
    for v in vals:
        a.add(v), b.add(v)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert a.percentile(q) == b.percentile(q)
    assert (a.count, a.sum, a.max) == (b.count, b.sum, b.max)
    assert port_stats.Reservoir().percentile(0.5) is None
