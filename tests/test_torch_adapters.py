"""The PyTorch port's multi-tenant LoRA adapters against the JAX reference
(``mxnet_tpu_torch/serve/adapters.py``; ``serve/engine.py`` ``_lora_delta``,
``_awfc``, the ``slot``/``slots`` program inputs and the slot pins).

Ports ``tests/test_adapters.py``: adapters-off inertness, validation
and the env defaults, one program a bucket serving any adapter mix (no
new program, and on CUDA no capture, after a rotated reassignment),
merged-checkpoint parity, preemption, speculative decoding, int8 base
weights, the adapter-salted prefix chain, the store's slot discipline
and codecs, the ``adapter_slots`` rejection and the per-adapter stats.
Every engine case also holds the port's tokens against the reference's
adapters engine on the same numpy checkpoint and adapters (float32,
token for token).  The store cases run on both packages, and files and
wire payloads cross between them with equal digests.

Added: ``_lora_delta`` against the reference's at 1e-6 for each slot
shape; an adapter registered and first loaded after ``warmup()`` (its
load evicting a cold one) serving its merged engine's tokens, which a
load that rebinds the stacks would miss; a sampling-mode engine's
greedy adapter rows; an adapter row restored from the host KV tier.

``test_adapter_tp2_parity`` (sharded stacks) lives in
``tests/test_torch_serve_sharded.py``.  The ``/statusz`` adapters
section is held against the reference's in
``tests/test_torch_observability.py``.  The ``cuda`` case (a rotated mix
after ``warmup()`` captures nothing) lives in
``tests/test_torch_capture.py``, which imports no JAX and so runs on the
card.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx
from torch_port_fixtures import \
    collect_engines_after_module  # noqa: F401  (autouse)

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.serve import adapters as ref_adapters
from mxnet_tpu.serve import engine as ref_engine
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.serve import adapters as port_adapters
from mxnet_tpu_torch.serve import engine as port_engine
from mxnet_tpu_torch.serve.kv_block_manager import (BlockManager, _ROOT,
                                                    chain_keys, salted_root)

VOCAB = fx.VOCAB
ENGINE_KW = dict(block_size=4, num_blocks=64, max_batch=4, max_model_len=64,
                 max_prefills_per_step=2)
PKGS = {"ref": ref_adapters, "port": port_adapters}
ALPHA = 8.0
# |port - reference| of one projection's delta in float32: the same
# products summed in another order, a few ulps (~1e-8) on deltas of ~0.1
DELTA_TOL = 1e-6


@pytest.fixture(scope="module")
def model():
    _, params, heads = fx.model("gpt2")
    return params, heads


def _port(model, params=None, **kw):
    p, heads = model
    return mt.serve.Engine(p if params is None else params, num_heads=heads,
                           device="cpu", **{**ENGINE_KW, **kw})


def _ref(model, params=None, **kw):
    p, heads = model
    return mx.serve.Engine(p if params is None else params, num_heads=heads,
                           **{**ENGINE_KW, **kw})


def _prompts(ns=(7, 12, 5, 9), seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (n,)).astype(np.int32) for n in ns]


def _stems(params):
    return port_adapters.gpt_stems("gpt", 2, False, False, params)


def _lora(params, rank=4, seed=11, scale=0.1):
    """One adapter's ``{stem: (A, B)}``: strong enough to move greedy
    tokens, small enough to stay numerically tame."""
    rng = np.random.RandomState(seed)
    return {stem: ((rng.randn(rank, din) * scale).astype(np.float32),
                   (rng.randn(dout, rank) * scale).astype(np.float32))
            for stem, (dout, din) in _stems(params).items()}


def _merged(params, arrays, alpha=ALPHA):
    """The single-tenant checkpoint: W + (alpha/r) * B @ A."""
    rank = next(iter(arrays.values()))[0].shape[0]
    mp = dict(params)
    for stem, (a, b) in arrays.items():
        w = mp[f"{stem}_weight"]
        mp[f"{stem}_weight"] = (w.astype(np.float32)
                                + (alpha / rank) * (b @ a)).astype(w.dtype)
    return mp


def _family(params, k=3, rank=4):
    return {f"tenant-{j}": _lora(params, rank=rank, seed=20 + j)
            for j in range(k)}


def _with_family(eng, family):
    for aid, arrays in family.items():
        eng.adapter_store.register(aid, arrays, alpha=ALPHA)
    return eng


def _run(eng, prompts, max_new=8, adapter_ids=None, **kw):
    reqs = [eng.submit(p, max_new_tokens=max_new,
                       adapter_id=None if adapter_ids is None
                       else adapter_ids[i], **kw)
            for i, p in enumerate(prompts)]
    eng.run()
    assert all(r.status == "finished" for r in reqs)
    return [list(r.tokens) for r in reqs]


def _serve_once(eng, prompts, **kw):
    toks = _run(eng, prompts, **kw)
    eng.shutdown()
    return toks


def _merged_tokens(model, family, aid, prompts, **kw):
    """Tokens of an adapters-off port engine on ``aid``'s merged
    checkpoint (the base checkpoint for ``aid`` None)."""
    params = model[0] if aid is None else _merged(model[0], family[aid])
    return _serve_once(_port(model, params=params, **kw), prompts)


# -- adapters-off inertness ---------------------------------------------------
def test_adapters_off_keeps_programs_and_fingerprint(model):
    """Off (the default) keeps the fingerprint, the warm-up grid and the
    programs' inputs; on declares a different program family and adds
    the slot inputs to the target programs only."""
    a, b = _port(model), _port(model)
    assert a._adapters == 0 and a.adapter_store is None
    assert a.adapter_info() is None
    fp = a._fingerprint()
    assert "adapters" not in fp and "adapter_rank" not in fp
    assert fp == b._fingerprint() and a._spec_digest == b._spec_digest
    assert a._warmup_grid() == b._warmup_grid()
    assert list(a._program("decode", 4)._inputs) == ["toks", "pos",
                                                       "tables"]
    assert "adp" not in a._program("prefill", 8)._body.keywords
    c = _port(model, adapters=4, adapter_rank=4)
    fpc = c._fingerprint()
    assert fpc.pop("adapters") == 4 and fpc.pop("adapter_rank") == 4
    assert fpc == fp and c._spec_digest != a._spec_digest
    assert c._warmup_grid() == a._warmup_grid()
    assert list(c._program("decode", 4)._inputs) == ["toks", "pos",
                                                       "tables", "slots"]
    assert c._program("decode", 4)._inputs["slots"].shape == (4,)
    for kind in ("prefill", "chunk"):
        prog = c._program(kind, 8)
        assert prog._inputs["slot"].shape == (1,)
        assert prog._body.keywords["adp"] is c.adapter_store.device
    assert c.adapter_info()["slots"] == 4
    for e in (a, b, c):
        e.shutdown()


def test_adapters_validation(model):
    with pytest.raises(ValueError, match="adapters"):
        _port(model, adapters=1)           # slot 0 is reserved: >= 2
    with pytest.raises(ValueError, match="adapters"):
        _port(model, adapters=-2)
    with pytest.raises(ValueError, match="adapter_rank"):
        _port(model, adapters=2, adapter_rank=0)
    eng = _port(model)                     # off: adapter_id refused
    with pytest.raises(ValueError, match="adapters-mode"):
        eng.submit(_prompts()[0], adapter_id="x")
    eng.shutdown()
    eng = _port(model, adapters=4, adapter_rank=4)
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit(_prompts()[0], adapter_id="never-registered")
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit(_prompts()[0], adapter_id=3)
    eng.shutdown()


def test_adapters_env_default(model, monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_ADAPTERS", "3")
    monkeypatch.setenv("MXTPU_SERVE_ADAPTER_RANK", "2")
    monkeypatch.setenv("MXTPU_SERVE_ADAPTER_HOST_BYTES", "4096")
    eng = _port(model)
    assert eng._adapters == 3 and eng.adapter_rank == 2
    info = eng.adapter_info()
    assert info["slots"] == 3 and info["rank"] == 2
    assert info["host_bytes_budget"] == 4096
    stack = eng.adapter_store.device["gpt_l0_q_A"]
    assert stack.shape == (3, 2, 32) and stack.dtype == torch.float32
    eng.shutdown()
    monkeypatch.setenv("MXTPU_SERVE_ADAPTER_HOST_BYTES", "0")
    eng = _port(model)                     # 0 = unbounded
    assert eng.adapter_info()["host_bytes_budget"] is None
    eng.shutdown()


# -- the delta itself ---------------------------------------------------------
@pytest.mark.parametrize("shape", ["scalar", "batch", "verify"])
def test_lora_delta_matches_reference(shape):
    """``_lora_delta`` against the reference's on the same stacks: a
    scalar slot over prefill rows, (B,) slots over decode rows, (B,)
    slots broadcast over verify's (B, K+1) rows; slot 0 adds exactly
    zero."""
    rng = np.random.RandomState(5)
    S, r, din, dout, B, K1 = 4, 3, 24, 16, 5, 4
    adp = {"s_A": (rng.randn(S, r, din) * 0.1).astype(np.float32),
           "s_B": (rng.randn(S, dout, r) * 0.1).astype(np.float32),
           "scale": np.float32([0.0, 2.0, 0.5, 1.25])}
    adp["s_A"][0] = 0.0
    adp["s_B"][0] = 0.0
    if shape == "scalar":
        x, slots = rng.randn(7, din), np.int32(2)
    elif shape == "batch":
        x, slots = rng.randn(B, din), np.int32([0, 3, 1, 2, 0])
    else:
        x, slots = rng.randn(B, K1, din), np.int32([1, 0, 3, 3, 2])
    x = x.astype(np.float32)
    want = np.asarray(ref_engine._lora_delta(
        {k: jnp.asarray(v) for k, v in adp.items()}, "s", jnp.asarray(x),
        jnp.asarray(slots)))
    got = port_engine._lora_delta(
        {k: torch.from_numpy(v) for k, v in adp.items()}, "s",
        torch.from_numpy(x), torch.from_numpy(np.asarray(slots)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DELTA_TOL)
    if shape != "scalar":
        base = np.asarray(slots) == 0
        assert not got.numpy()[base].any()


# -- the tentpole: one program a bucket, any mix, merged parity --------------
def test_mixed_batch_no_new_programs_and_merged_parity(model):
    """One warmed engine serves base + 3 adapters in one batch, then
    every row on another adapter, with no new program (on CUDA: no
    capture); each row equals the reference's adapters engine and its
    tenant's merged-checkpoint engine, base rows the adapters-off
    engine."""
    params, _ = model
    family = _family(params)
    prompts = _prompts()
    ids = [None, "tenant-0", "tenant-1", "tenant-2"]
    rotated = ids[1:] + ids[:1]

    eng = _with_family(_port(model, adapters=4, adapter_rank=4), family)
    eng.warmup()
    programs, captures = set(eng._programs), eng.captures
    mux = _run(eng, prompts, adapter_ids=ids)
    assert set(eng._programs) == programs and eng.captures == captures
    mux2 = _run(eng, prompts, adapter_ids=rotated)
    assert set(eng._programs) == programs and eng.captures == captures
    assert eng.adapter_info()["slots_pinned"] == 0
    eng.shutdown()

    ref = _with_family(_ref(model, adapters=4, adapter_rank=4), family)
    assert _run(ref, prompts, adapter_ids=ids) == mux
    assert _run(ref, prompts, adapter_ids=rotated) == mux2
    ref.shutdown()

    for row, aid in enumerate(ids):
        assert mux[row] == _merged_tokens(model, family, aid,
                                          [prompts[row]])[0], (row, aid)
        assert mux2[row] == _merged_tokens(model, family, rotated[row],
                                           [prompts[row]])[0], (row, aid)
    assert any(mux[i] != mux2[i] for i in range(4)), \
        "adapter deltas never changed a token: the test is vacuous"


def test_adapter_registered_after_warmup(model):
    """An adapter registered after ``warmup()`` and loaded into a slot
    that held another adapter (evicting it cold) serves its merged
    engine's tokens and the reference's: the load writes the stacks the
    programs were built on."""
    params, _ = model
    family = _family(params)
    prompts = _prompts((10, 8, 12), seed=43)
    early = {k: family[k] for k in ("tenant-0", "tenant-1")}

    eng = _with_family(_port(model, adapters=3, adapter_rank=4), early)
    eng.warmup()
    programs = set(eng._programs)
    first = _run(eng, prompts[:2], adapter_ids=["tenant-0", "tenant-1"])
    stacks = {k: v.data_ptr() for k, v in eng.adapter_store.device.items()}
    eng.adapter_store.register("tenant-2", family["tenant-2"], alpha=ALPHA)
    late = _run(eng, prompts[2:], adapter_ids=["tenant-2"])
    info = eng.adapter_info()
    assert info["device_evictions"] == 1 and info["loads"] == 3
    assert "tenant-2" in info["loaded"]
    assert sum(a in info["loaded"] for a in early) == 1
    assert {k: v.data_ptr() for k, v
            in eng.adapter_store.device.items()} == stacks
    assert set(eng._programs) == programs
    eng.shutdown()

    ref = _with_family(_ref(model, adapters=3, adapter_rank=4), early)
    assert _run(ref, prompts[:2], adapter_ids=["tenant-0",
                                               "tenant-1"]) == first
    ref.adapter_store.register("tenant-2", family["tenant-2"], alpha=ALPHA)
    assert _run(ref, prompts[2:], adapter_ids=["tenant-2"]) == late
    ref.shutdown()
    assert late == _merged_tokens(model, family, "tenant-2", prompts[2:])
    assert late != _merged_tokens(model, family, None, prompts[2:])


def test_adapter_preemption_resume_equivalence(model):
    """A cache-starved adapters engine preempts mid-generation; every
    row still reproduces the uncontended run and the reference's: the
    pin survives preemption."""
    params, _ = model
    family = _family(params, k=2)
    prompts = _prompts((8, 14, 10, 16), seed=13)
    ids = [None, "tenant-0", "tenant-1", "tenant-0"]

    def run(make, num_blocks):
        eng = _with_family(make(model, adapters=3, adapter_rank=4,
                                num_blocks=num_blocks), family)
        toks = _run(eng, prompts, max_new=24, adapter_ids=ids)
        st = eng.stats()
        assert eng.adapter_info()["slots_pinned"] == 0
        eng.shutdown()
        return toks, st

    calm, calm_st = run(_port, 64)
    tight, tight_st = run(_port, 20)
    assert calm_st.preemptions == 0
    assert tight_st.preemptions > 0, \
        "no cache pressure: the test is vacuous"
    assert calm == tight == run(_ref, 20)[0]


def test_adapter_spec_decode_parity(model):
    """Greedy spec decoding threads the slots through the verify
    program: tokens equal plain decode and the reference's spec engine,
    the draft's programs take no slot and bind no stacks, and
    the acceptance counts equal the reference's (a draft reading the
    adapters would move them, not the tokens)."""
    params, _ = model
    draft = dict(params)
    for k, v in params.items():
        if k.startswith("gpt_l1_") and (k.endswith("proj_weight")
                                        or k.endswith("ff_down_weight")):
            draft[k] = v * 0.05
    family = _family(params, k=2)
    prompts = _prompts((9, 13), seed=17)
    ids = ["tenant-0", "tenant-1"]
    spec = dict(spec_k=3, draft_params=draft, draft_num_heads=4,
                draft_window=0)

    def run(make, **kw):
        eng = _with_family(make(model, adapters=3, adapter_rank=4, **kw),
                           family)
        toks = _run(eng, prompts, max_new=12, adapter_ids=ids)
        st = eng.stats()
        if make is _port and kw:
            for (kind, _), prog in eng._programs.items():
                slotted = "slots" in prog._inputs or "slot" in prog._inputs
                assert slotted != kind.startswith("draft"), kind
                assert ("adp" in prog._body.keywords) == slotted, kind
        eng.shutdown()
        return toks, (st.spec_verifies, st.spec_accepted_tokens)

    plain, _ = run(_port)
    got, counts = run(_port, **spec)
    want, ref_counts = run(_ref, **spec)
    assert got == plain == want
    assert counts == ref_counts and counts[0] > 0


def test_adapter_int8_base_compose(model):
    """Adapters over int8 base weights: the delta rides the dequantized
    matmul, token-identical to the int8 engine on the merged (then
    quantized) checkpoint and to the reference's int8 adapters engine."""
    params, _ = model
    family = _family(params, k=1)
    prompts = _prompts((10,), seed=19)
    ids = ["tenant-0"]
    eng = _with_family(_port(model, adapters=2, adapter_rank=4,
                             quantize="int8"), family)
    assert eng.adapter_store.device["gpt_l0_q_A"].dtype == torch.float32
    mux = _serve_once(eng, prompts, adapter_ids=ids)
    assert mux == _merged_tokens(model, family, "tenant-0", prompts,
                                 quantize="int8")
    ref = _with_family(_ref(model, adapters=2, adapter_rank=4,
                            quantize="int8"), family)
    assert _serve_once(ref, prompts, adapter_ids=ids) == mux


# -- the adapter-salted radix chain -------------------------------------------
def test_salted_root_and_chain_keys():
    """No salt IS the unsalted chain; each salt is its own key space."""
    ids = list(range(1, 13))
    assert salted_root(None) == _ROOT and salted_root("") == _ROOT
    assert chain_keys(ids, 4) == chain_keys(ids, 4, salt=None)
    a = chain_keys(ids, 4, salt="tenant-a")
    b = chain_keys(ids, 4, salt="tenant-b")
    base = chain_keys(ids, 4)
    assert len({a[0], b[0], base[0]}) == 3
    assert not set(a) & set(b) and not set(a) & set(base)


def test_block_manager_salted_reuse():
    """Same-salt resubmits hit the cached chain; cross-salt resubmits
    never can."""
    ids = np.arange(1, 13, dtype=np.int32)
    m = BlockManager(num_blocks=32, block_size=4)
    m.allocate("r0", 12, token_ids=ids, salt="a")
    m.note_tokens("r0", ids, salt="a")
    m.free("r0")
    _, hit = m.allocate("r1", 12, token_ids=ids, salt="a")
    assert hit == 8, "same-adapter resubmit missed its own chain"
    m.free("r1")
    _, hit = m.allocate("r2", 12, token_ids=ids, salt="b")
    assert hit == 0, "adapter chain leaked across salts"
    m.free("r2")
    _, hit = m.allocate("r3", 12, token_ids=ids)
    assert hit == 0, "adapter chain leaked into the base space"


def test_engine_salted_prefix_cache_token_safety(model):
    """Resubmitting a prompt under another adapter never reuses the
    first tenant's K/V: tokens match each tenant's cold engine, the
    port's and the reference's."""
    params, _ = model
    family = _family(params, k=2)
    p = _prompts((16,), seed=29)[0]
    eng = _with_family(_port(model, adapters=3, adapter_rank=4), family)
    warm = {}
    for aid in (None, "tenant-0", "tenant-1", "tenant-0", None):
        warm[aid] = _run(eng, [p], adapter_ids=[aid])[0]
    hits = eng.stats().prefix_hits
    eng.shutdown()
    assert hits > 0, "same-adapter resubmit never hit: vacuous"
    for aid in (None, "tenant-0", "tenant-1"):
        for make in (_port, _ref):
            cold = _with_family(make(model, adapters=3, adapter_rank=4,
                                     prefix_cache=False), family)
            assert warm[aid] == _serve_once(cold, [p],
                                            adapter_ids=[aid])[0], aid
    assert len({tuple(v) for v in warm.values()}) == 3


def test_adapter_row_restored_from_host_tier(model):
    """An adapter row whose salted prefix was evicted to the host KV
    tier restores it and emits the tier-off engine's tokens."""
    params, _ = model
    family = _family(params, k=1)
    rng = np.random.RandomState(7)
    prompt = rng.randint(0, VOCAB, (24,)).astype(np.int32)
    fills = [rng.randint(0, VOCAB, (24,)).astype(np.int32)
             for _ in range(3)]
    ids = ["tenant-0"]

    def churn(**kw):
        eng = _with_family(_port(model, adapters=2, adapter_rank=4,
                                 num_blocks=16, **kw), family)
        first = _run(eng, [prompt], adapter_ids=ids)
        for f in fills:
            _run(eng, [f])
        again = _run(eng, [prompt], adapter_ids=ids)
        st = eng.stats()
        eng.shutdown()
        return first, again, st

    first, again, st = churn(host_kv_bytes=1 << 24)
    off_first, off_again, off_st = churn()
    assert st.host_kv_hits > 0 and st.host_kv_restored_tokens > 0
    assert off_st.host_kv_hits == 0
    assert first == again == off_first == off_again
    assert first == _merged_tokens(model, family, "tenant-0", [prompt],
                                   num_blocks=16)


@pytest.mark.parametrize("spec", [False, True])
def test_sampling_engine_greedy_adapter_rows(model, spec):
    """A sampling-mode adapters engine, also with speculative decoding
    (rejection sampling in the verify program): its greedy rows (adapter
    and base) equal the greedy adapters engine's, port and reference,
    beside stochastic rows in the same batches."""
    params, _ = model
    family = _family(params, k=2)
    prompts = _prompts((7, 12, 5, 9, 11, 6), seed=53)
    ids = ["tenant-0", None, "tenant-1", "tenant-0", "tenant-1", None]
    stochastic = {1, 3}
    kw = (dict(spec_k=3, draft_params=params, draft_num_heads=4,
               draft_window=0) if spec else {})

    eng = _with_family(_port(model, adapters=3, adapter_rank=4,
                             sampling=True, seed=5, **kw), family)
    reqs = [eng.submit(p, max_new_tokens=8, adapter_id=ids[i],
                       temperature=0.8 if i in stochastic else 0.0)
            for i, p in enumerate(prompts)]
    eng.run()
    assert all(r.status == "finished" for r in reqs)
    if spec:
        assert eng.stats().spec_verifies > 0
    eng.shutdown()
    greedy = [i for i in range(len(prompts)) if i not in stochastic]
    want = _serve_once(_with_family(_port(model, adapters=3,
                                          adapter_rank=4), family),
                       [prompts[i] for i in greedy],
                       adapter_ids=[ids[i] for i in greedy])
    assert [reqs[i].tokens for i in greedy] == want
    ref = _with_family(_ref(model, adapters=3, adapter_rank=4), family)
    assert _serve_once(ref, [prompts[i] for i in greedy],
                       adapter_ids=[ids[i] for i in greedy]) == want


# -- slot discipline (both packages' AdapterStore) ---------------------------
def _store(pkg, params, rank=4, slots=3, **kw):
    return PKGS[pkg].AdapterStore(_stems(params), rank, slots, **kw)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_store_register_validation(model, pkg):
    params, _ = model
    s = _store(pkg, params)
    la = _lora(params, rank=4)
    with pytest.raises(ValueError, match="non-empty"):
        s.register("", la)
    with pytest.raises(ValueError, match="unknown projection"):
        s.register("x", {"gpt_l9_q": la["gpt_l0_q"]})
    with pytest.raises(ValueError, match="no projection"):
        s.register("x", {})
    a, b = la["gpt_l0_q"]
    with pytest.raises(ValueError, match="want A"):
        s.register("x", dict(la, gpt_l0_q=(a[:, :-1], b)))
    with pytest.raises(ValueError, match="want A"):
        s.register("x", dict(la, gpt_l0_q=(np.zeros((9, a.shape[1]),
                                                     np.float32), b)))
    with pytest.raises(ValueError, match="mixed per-stem ranks"):
        s.register("x", dict(la, gpt_l0_q=(a[:2], b[:, :2])))
    with pytest.raises(ValueError, match="slots"):
        _store(pkg, params, slots=1)
    with pytest.raises(ValueError, match="rank"):
        _store(pkg, params, rank=0)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_store_dedup_refcount_and_eviction(model, pkg):
    params, _ = model
    s = _store(pkg, params, slots=3)          # 2 usable slots
    la, lb, lc = (_lora(params, rank=4, seed=s_) for s_ in (1, 2, 3))
    d1 = s.register("a", la)
    assert s.register("a-alias", la) == d1    # content-addressed
    s.register("b", lb)
    s.register("c", lc)
    assert s.known("a") and s.ids() == ["a", "a-alias", "b", "c"]
    sa = s.acquire("a")
    assert s.acquire("a-alias") == sa         # one slot, refcount 2
    sb = s.acquire("b")
    assert s.stats()["slots_pinned"] == 2
    with pytest.raises(PKGS[pkg].NoAdapterSlots):
        s.acquire("c")
    with pytest.raises(KeyError):
        s.acquire("never")
    s.release(sb)                             # b cold now
    sc = s.acquire("c")                       # evicts cold b
    assert sc == sb and s.device_evictions == 1
    assert "b" not in s.loaded() and "c" in s.loaded()
    s.release(sa)
    s.release(sa)
    s.release(sc)
    assert s.stats()["slots_pinned"] == 0
    s.release(sc)                             # idempotent, bounds-safe
    s.release(0)
    s.release(99)
    assert s.stats()["slots_pinned"] == 0 and s.loads == 3


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_store_unload_and_forget(model, pkg):
    params, _ = model
    s = _store(pkg, params, slots=3)
    s.register("a", _lora(params, rank=4, seed=1))
    slot = s.acquire("a")
    with pytest.raises(RuntimeError, match="pinned"):
        s.unload("a")
    with pytest.raises(RuntimeError, match="pinned"):
        s.forget("a")
    s.release(slot)
    assert s.unload("a") is True              # cold: off the device
    assert s.unload("a") is False             # already off
    assert s.known("a")                       # registration stays
    s.register("a2", _lora(params, rank=4, seed=1))    # same content
    assert s.forget("a") is True and s.known("a2")     # alias keeps it
    assert s.forget("a2") is True
    assert not s.known("a") and s.forget("a") is False
    assert s.stats()["host_bytes_used"] == 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_store_host_tier_budget(model, pkg):
    params, _ = model
    la = _lora(params, rank=4, seed=1)
    nbytes = sum(a.nbytes + b.nbytes for a, b in la.values())
    s = _store(pkg, params, slots=3, host_bytes=int(nbytes * 2.5))
    s.register("a", la)
    s.register("b", _lora(params, rank=4, seed=2))
    s.register("c", _lora(params, rank=4, seed=3))   # evicts LRU "a"
    assert s.host_evictions == 1 and not s.known("a")
    assert s.known("b") and s.known("c")
    with pytest.raises(ValueError, match="exceeds the host tier"):
        _store(pkg, params, host_bytes=nbytes // 2).register("big", la)
    slot = s.acquire("b")          # device-resident entries stay
    s.register("d", _lora(params, rank=4, seed=4))   # evicts "c" not "b"
    assert s.known("b") and not s.known("c")
    s.release(slot)


def test_store_device_stacks_match_reference(model):
    """After the same acquires, the port's stacks hold the reference's
    rows bit for bit (a rank-3 adapter zero-padded to 4, a stem left
    out staying zero, the scale alpha / r in float32), in place."""
    params, _ = model
    la = _lora(params, rank=3, seed=1)
    del la["gpt_l1_v"]
    lb = _lora(params, rank=4, seed=2)
    stores = {pkg: _store(pkg, params, slots=3) for pkg in PKGS}
    ptrs = {k: v.data_ptr() for k, v in stores["port"].device.items()}
    for s in stores.values():
        s.register("a", la, alpha=6.0)
        s.register("b", lb)
        assert (s.acquire("a"), s.acquire("b")) == (2, 1)
    ref = stores["ref"].device
    for key, t in stores["port"].device.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref[key]))
        assert t.data_ptr() == ptrs[key]
    assert stores["port"].device["scale"].tolist() == [0.0, 1.0, 2.0]
    assert not stores["port"].device["gpt_l1_v_A"][2].any()


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref"),
                                           ("port", "port")])
def test_store_disk_and_wire_roundtrip(model, tmp_path, writer, reader):
    """A file and a wire payload written by either package register in
    the other with the same digest; corrupt or half payloads fail."""
    params, _ = model
    s = _store(writer, params)
    la = _lora(params, rank=3)                 # rank < ceiling: padded
    d = s.register("a", la, alpha=6.0)
    assert _store(reader, params).register("x", la, alpha=6.0) == d
    path = str(tmp_path / "a.npz")
    s.save_file("a", path)
    assert _store(reader, params).load_file("a2", path) == d
    payload = s.export_records("a")
    assert payload["digest"] == d and payload["rank"] == 3
    assert _store(reader, params).import_records("a3", payload) == d
    corrupt = dict(payload)
    corrupt["records"] = [dict(r) for r in payload["records"]]
    corrupt["records"][0]["data"] = \
        corrupt["records"][0]["data"][:-4] + "AAA="
    with pytest.raises(ValueError, match="sha1"):
        _store(reader, params).import_records("bad", corrupt)
    with pytest.raises(ValueError, match="A/B half"):
        _store(reader, params).import_records(
            "half", {"alpha": 6.0, "records": payload["records"][:1]})


# -- the engine's pins --------------------------------------------------------
def test_engine_adapter_slots_transient_rejection(model):
    """All slots pinned is capacity pressure: the retriable
    ``adapter_slots`` rejection, for each row of an n > 1 group too; the
    request succeeds once a pin drops."""
    params, _ = model
    family = _family(params, k=2)
    eng = _with_family(_port(model, adapters=2, adapter_rank=4), family)
    p = _prompts((8,), seed=31)[0]
    r1 = eng.submit(p, max_new_tokens=4, adapter_id="tenant-0")
    r2 = eng.submit(p, max_new_tokens=4, adapter_id="tenant-1")
    assert r2.status == "rejected" and r2.reject_reason == "adapter_slots"
    assert eng.stats().reject_reasons == {"adapter_slots": 1}
    eng.run()
    assert r1.status == "finished"
    assert eng.adapter_info()["slots_pinned"] == 0
    r3 = eng.submit(p, max_new_tokens=4, adapter_id="tenant-1")
    assert r3.status != "rejected"            # pin dropped at terminal
    eng.run()
    assert r3.status == "finished"
    eng.shutdown()


def test_pins_drop_once_on_every_terminal_path(model):
    """Finished, rejected (deadline in the queue, queue full) and
    cancelled (running, mid-prefill, waiting, n > 1 siblings held
    back) each drop their row's pin exactly once; preemption keeps it."""
    params, _ = model
    family = _family(params, k=1)
    clock = [0.0]
    eng = _with_family(_port(model, adapters=3, adapter_rank=4,
                             max_queue=3, max_batch=2, prefill_chunk=8,
                             clock=lambda: clock[0]), family)
    store = eng.adapter_store
    ps = _prompts((9, 30, 7, 6), seed=61)
    kw = dict(max_new_tokens=6, adapter_id="tenant-0")

    def pins():
        return store._slot_ref[store._loaded[store._alias["tenant-0"]]]

    done = eng.submit(ps[0], **kw)
    eng.run()
    assert done.status == "finished" and pins() == 0
    late = eng.submit(ps[2], deadline_s=1.0, **kw)
    clock[0] = 5.0
    eng.step()
    assert late.reject_reason == "deadline" and pins() == 0
    group = eng.submit(ps[3], n=3, **kw)          # 3 pins, 2 held back
    assert pins() == 3
    chunked = eng.submit(ps[1], **kw)             # prefills in chunks
    waiting = eng.submit(ps[2], **kw)
    with pytest.raises(mt.serve.QueueFull):
        eng.submit(ps[0], n=2, **kw)              # both rows rejected
    assert pins() == 5
    eng.step()
    eng.shutdown()
    reqs = group.samples + [chunked, waiting]
    assert all(r.status == "cancelled" and r.adapter_slot == 0
               for r in reqs)
    assert pins() == 0 and store.stats()["slots_pinned"] == 0


def test_adapter_stats_and_info(model):
    """Per-adapter completion and token counters ride the stats
    snapshot; ``adapter_info`` reports the store."""
    params, _ = model
    family = _family(params, k=2)
    eng = _with_family(_port(model, adapters=3, adapter_rank=4), family)
    _run(eng, _prompts((8, 10, 12), seed=37), max_new=4,
         adapter_ids=["tenant-0", "tenant-1", "tenant-0"])
    assert eng.stats().adapters == {
        "tenant-0": {"completed": 2, "tokens": 8},
        "tenant-1": {"completed": 1, "tokens": 4}}
    info = eng.adapter_info()
    assert info["slots_used"] == 2 and info["loads"] == 2
    assert info["ids"] == ["tenant-0", "tenant-1"]
    assert info["slots_pinned"] == 0
    eng.shutdown()
