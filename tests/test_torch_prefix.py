"""The port's prefix cache and chunked prefill against the JAX reference.

The reference's engine cases of ``tests/test_prefix_cache.py`` (cached vs
cold, chunked vs whole, both together, eviction pressure, preemption with
sharing, a long prompt beside running decodes, the ``stats()`` prefix
section, the disabled cache), each run through
``mxnet_tpu_torch.serve.Engine(device="cpu")`` and the reference
``mxnet_tpu.serve.Engine`` on the same seeded checkpoint
(``torch_port_fixtures``), at the reference's defaults (prefix cache on,
``prefill_chunk`` as each case sets it).  Every case requires identical
token streams; a flip is reported with its logit margin
(``test_torch_engine._margin``), never absorbed by a tolerance.

``test_chunk_program_matches_reference`` holds the port's chunk body
against the reference's ``_build_chunk`` program on the same inputs.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx
from torch_port_fixtures import \
    collect_engines_after_module  # noqa: F401  (autouse)
from test_torch_engine import ENGINE_KW, _assert_same_streams

import mxnet_tpu as mx
from mxnet_tpu.serve import engine as ref_engine_mod
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.serve import engine as port_engine

VOCAB = fx.VOCAB
# float32 chunk logits and written K/V, port vs reference: the same
# float32 math in another summation order through 2 small layers
CHUNK_TOL = 1e-5


@pytest.fixture(scope="module", params=["gpt2", "llama"])
def model(request):
    return fx.model(request.param)


@pytest.fixture(scope="module")
def gpt2():
    return fx.model("gpt2")


def _ref(model, **kw):
    net, params, _ = model
    return mx.serve.Engine(params, symbol=net, **{**ENGINE_KW, **kw})


def _port(model, **kw):
    _, params, heads = model
    return mt.serve.Engine(params, num_heads=heads, window=0, device="cpu",
                           **{**ENGINE_KW, **kw})


def _both(model, **kw):
    return {"ref": _ref(model, **kw), "port": _port(model, **kw)}


def _shared_prompts(n_prefixes=2, n_cont=4, prefix_len=20, cont_len=5,
                    seed=7):
    """n_prefixes distinct system prompts x n_cont continuations."""
    rng = np.random.RandomState(seed)
    prefixes = [rng.randint(0, VOCAB, (prefix_len,)).astype(np.int32)
                for _ in range(n_prefixes)]
    return [np.concatenate([p, rng.randint(0, VOCAB,
                                           (cont_len,)).astype(np.int32)])
            for _ in range(n_cont) for p in prefixes]


def _serve_sequential(eng, prompts, max_new=8):
    """Submit one at a time, draining between submits, so every prompt
    after the first sees the published blocks of its predecessors."""
    reqs = []
    for p in prompts:
        reqs.append(eng.submit(p, max_new_tokens=max_new))
        eng.run()
    return reqs


PREFIX_FIELDS = ("prefix_hits", "prefix_misses", "prefix_hit_rate",
                 "prefix_tokens_saved", "prefix_evictions",
                 "prefix_resurrections", "prefix_discarded_tokens",
                 "prefill_tokens_computed", "preemptions", "completed",
                 "tokens_generated")


def _same_stats(ref_eng, port_eng):
    r, p = ref_eng.stats(), port_eng.stats()
    for f in PREFIX_FIELDS:
        assert getattr(p, f) == getattr(r, f), f
    assert port_eng.blocks.prefix_stats() == ref_eng.blocks.prefix_stats()
    return p


def test_cached_vs_cold_identity(model):
    """Cache on vs off: identical tokens, with a real prefill-compute
    reduction, in both packages alike (gpt2: learned positions, MHA;
    llama: rope positions through the chunk program, GQA)."""
    prompts = _shared_prompts()
    cold = _port(model, prefix_cache=False)
    cold_reqs = _serve_sequential(cold, prompts)
    assert cold.stats().prefix_hits == 0
    engs = _both(model)
    reqs = {k: _serve_sequential(e, prompts) for k, e in engs.items()}
    st = _same_stats(engs["ref"], engs["port"])
    assert st.prefix_hits > 0, "no prefix hits — test is vacuous"
    assert st.prefix_tokens_saved > 0
    assert st.prefill_tokens_computed < cold.stats().prefill_tokens_computed
    assert st.prefix_hit_rate > 0.5
    assert all(r.status == "finished" for r in reqs["port"])
    _assert_same_streams(model, 0, prompts, reqs["ref"], reqs["port"])
    _assert_same_streams(model, 0, prompts, cold_reqs, reqs["port"])


def test_chunked_vs_whole_prefill_identity(model):
    """A long prompt prefilled in chunks emits exactly the tokens of a
    whole-prompt prefill, and takes as many iterations as the
    reference's."""
    rng = np.random.RandomState(11)
    long_prompt = rng.randint(0, VOCAB, (50,)).astype(np.int32)
    whole = _port(model, prefix_cache=False, prefill_chunk=0)
    ref_whole = whole.submit(long_prompt, max_new_tokens=8)
    whole.run()
    got = {}
    for k, eng in _both(model, prefix_cache=False, prefill_chunk=8).items():
        req = eng.submit(long_prompt, max_new_tokens=8)
        chunk_steps = 0
        while eng.scheduler.has_work():
            before = req.cache_len
            eng.step()
            if not req.done and req.cache_len > before and not req.tokens:
                chunk_steps += 1
        got[k] = (req, chunk_steps)
    assert got["port"][1] >= 3, "prompt never actually chunked"
    assert got["port"][1] == got["ref"][1]
    _assert_same_streams(model, 0, [long_prompt], [got["ref"][0]],
                         [got["port"][0]])
    _assert_same_streams(model, 0, [long_prompt], [ref_whole],
                         [got["port"][0]])


def test_chunked_and_cached_compose(gpt2):
    """A prefix-cache hit on a long prompt chunks only the SUFFIX."""
    rng = np.random.RandomState(13)
    prefix = rng.randint(0, VOCAB, (16,)).astype(np.int32)
    longs = [np.concatenate([prefix, rng.randint(0, VOCAB, (30,))
                             .astype(np.int32)]) for _ in range(2)]
    cold = _port(gpt2, prefix_cache=False, prefill_chunk=0)
    cold_reqs = _serve_sequential(cold, longs)
    engs = _both(gpt2, prefill_chunk=8)
    reqs = {k: _serve_sequential(e, longs) for k, e in engs.items()}
    st = _same_stats(engs["ref"], engs["port"])
    assert st.prefix_hits >= 1
    _assert_same_streams(gpt2, 0, longs, reqs["ref"], reqs["port"])
    _assert_same_streams(gpt2, 0, longs, cold_reqs, reqs["port"])


def test_eviction_pressure_then_reprefill_identity(gpt2):
    """Cached blocks evicted under pressure must not poison a later
    identical prompt: the re-prefill recomputes and still matches."""
    prompt = _shared_prompts(n_prefixes=1, n_cont=1)[0]
    cold = _port(gpt2, prefix_cache=False)
    ref = cold.submit(prompt, max_new_tokens=8)
    cold.run()
    out = {}
    # 15 allocatable blocks: each ~8-block request forces the previous
    # one's parked chain out of the radix LRU
    for k, eng in _both(gpt2, num_blocks=16, max_model_len=48).items():
        rng = np.random.RandomState(29)
        # churn between the two: evict the cached chain
        seq = ([prompt] + [rng.randint(0, VOCAB, (24,)).astype(np.int32)
                           for _ in range(3)] + [prompt])
        out[k] = (eng, _serve_sequential(eng, seq))
    st = _same_stats(out["ref"][0], out["port"][0])
    assert st.prefix_evictions > 0, "no eviction pressure — vacuous"
    port_reqs = out["port"][1]
    _assert_same_streams(gpt2, 0, seq, out["ref"][1], port_reqs)
    _assert_same_streams(gpt2, 0, [prompt] * 2, [ref, ref],
                         [port_reqs[0], port_reqs[-1]])


def test_preemption_with_sharing_identity(gpt2):
    """Preempting a request whose blocks are shared must neither corrupt
    the survivor nor the resumed request (free is a decref), and the
    port preempts exactly as the reference does."""
    prompts = _shared_prompts(n_prefixes=2, n_cont=3, prefix_len=12,
                              cont_len=4, seed=17)

    def run(make, num_blocks):
        eng = make(gpt2, num_blocks=num_blocks)
        reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
        eng.run()
        return eng, reqs

    calm, calm_reqs = run(_port, 64)
    tight, tight_reqs = run(_port, 22)
    ref, ref_reqs = run(_ref, 22)
    assert calm.stats().preemptions == 0
    assert tight.stats().preemptions > 0, "no cache pressure — vacuous"
    _same_stats(ref, tight)
    assert ([r.n_preemptions for r in tight_reqs]
            == [r.n_preemptions for r in ref_reqs])
    _assert_same_streams(gpt2, 0, prompts, ref_reqs, tight_reqs)
    _assert_same_streams(gpt2, 0, prompts, calm_reqs, tight_reqs)


def test_long_prompt_no_longer_starves_decodes(gpt2):
    """While a long prompt chunk-prefills, a running request receives a
    token EVERY iteration and no iteration computes more prefill tokens
    than the chunk budget; the port's iterations are the reference's."""
    chunk = 8
    trace = {}
    for k, eng in _both(gpt2, prefill_chunk=chunk, max_model_len=64,
                        num_blocks=64).items():
        rng = np.random.RandomState(19)
        short = eng.submit(rng.randint(0, VOCAB, (6,)).astype(np.int32),
                           max_new_tokens=24)
        eng.step()                         # short admitted + decoding
        long_req = eng.submit(rng.randint(0, VOCAB, (50,)).astype(np.int32),
                              max_new_tokens=4)
        steps, max_advance = [], 0
        while not long_req.tokens and eng.scheduler.has_work():
            sh, lg = len(short.tokens), long_req.cache_len
            eng.step()
            steps.append((len(short.tokens), long_req.cache_len))
            if long_req.cache_len > lg:    # a chunk ran this iteration
                max_advance = max(max_advance, long_req.cache_len - lg)
                if not short.done:         # ... and decode still moved
                    assert len(short.tokens) == sh + 1
        eng.run()
        assert 0 < max_advance <= chunk
        assert short.status == long_req.status == "finished"
        trace[k] = (steps, [short.tokens, long_req.tokens])
    assert trace["port"][0] == trace["ref"][0]
    assert trace["port"][1] == trace["ref"][1]


def test_stats_expose_prefix_cache_as_reference(gpt2):
    engs = _both(gpt2)
    for eng in engs.values():
        _serve_sequential(eng, _shared_prompts(n_prefixes=1, n_cont=2))
    st = _same_stats(engs["ref"], engs["port"])
    pfx = engs["port"].blocks.prefix_stats()
    assert pfx["enabled"] is True
    assert pfx["hits"] >= 1 and pfx["tokens_saved"] > 0
    assert st.prefix_hits == pfx["hits"]
    assert st.prefix_tokens_saved == pfx["tokens_saved"]
    assert (st.as_dict()["prefix_hit_rate"] == pfx["hit_rate"]
            == engs["ref"].stats().as_dict()["prefix_hit_rate"])


def test_prefix_cache_disabled_is_inert(gpt2):
    prompts = _shared_prompts(n_prefixes=1, n_cont=3)
    engs = _both(gpt2, prefix_cache=False)
    reqs = {k: _serve_sequential(e, prompts) for k, e in engs.items()}
    port = engs["port"]
    st = _same_stats(engs["ref"], port)
    pfx = port.blocks.prefix_stats()
    assert all(r.status == "finished" for r in reqs["port"])
    assert st.prefix_hits == st.prefix_misses == 0
    assert pfx["enabled"] is False and pfx["cached_blocks"] == 0
    assert all(kind != "chunk" for kind, _ in port._programs)
    _assert_same_streams(gpt2, 0, prompts, reqs["ref"], reqs["port"])


def test_prefix_knobs_take_the_reference_defaults(gpt2, monkeypatch):
    eng = _port(gpt2)
    assert eng.blocks.prefix_cache is True
    assert eng.scheduler.prefill_chunk == 512
    monkeypatch.setenv("MXTPU_SERVE_PREFIX_CACHE", "0")
    monkeypatch.setenv("MXTPU_SERVE_PREFILL_CHUNK", "24")
    eng = _port(gpt2)
    ref = _ref(gpt2)
    assert eng.blocks.prefix_cache is ref.blocks.prefix_cache is False
    assert eng.scheduler.prefill_chunk == ref.scheduler.prefill_chunk == 24
    assert eng._chunk_cap() == ref._chunk_cap() == 32


# -- the chunk program itself -------------------------------------------------
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("start,n_valid,W", [(10, 5, 16), (90, 3, 24)])
def test_chunk_program_matches_reference(model, monkeypatch, window, start,
                                         n_valid, W):
    """The port's chunk body against the reference's ``_build_chunk``
    (jnp on the CPU) at bucket 8: rows past ``n_valid`` padded, ``start``
    past the first blocks; at start 90 the gpt2 checkpoint's padded rows
    pass its 96-entry position table (clamped).  The reference program's
    greedy sampler is swapped for the identity so it returns its
    logits.  Held: the (1, V) logits and the written K/V caches, float32,
    max |port - reference| <= CHUNK_TOL."""
    import jax.numpy as jnp

    C = 8
    ref_eng = _ref(model, prefix_cache=False, prefill_chunk=0)
    port_eng = _port(model, prefix_cache=False, prefill_chunk=0)
    rng = np.random.RandomState(start + window)
    L, nb = port_eng._cfg.n_layers, 64
    shape = (L, nb, 4, port_eng._cfg.kv_heads, port_eng._cfg.head_dim)
    ck = (rng.randn(*shape) * 0.5).astype(np.float32)
    cv = (rng.randn(*shape) * 0.5).astype(np.float32)
    used = -(-(start + n_valid) // 4)
    table = np.zeros(W, np.int32)
    table[:used] = rng.permutation(np.arange(1, nb))[:used]
    toks = np.zeros(C, np.int32)
    toks[:n_valid] = rng.randint(0, VOCAB, n_valid)
    blk = np.zeros(C, np.int32)
    blk[:n_valid] = table[(start + np.arange(n_valid)) // 4]
    off = ((start + np.arange(C)) % 4).astype(np.int32)

    monkeypatch.setattr(ref_engine_mod, "_sample",
                        lambda cfg, logits, key: logits)
    fn = ref_engine_mod._build_chunk(ref_eng._cfg._replace(window=window),
                                     C, donate=False)
    r_logits, r_ck, r_cv = fn(
        ref_eng.params, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(toks),
        jnp.asarray(start, jnp.int32), jnp.asarray(n_valid, jnp.int32),
        jnp.asarray(table), jnp.asarray(blk), jnp.asarray(off),
        jnp.zeros((2,), jnp.uint32))
    p_ck, p_cv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    t = {k: torch.from_numpy(v) for k, v in
         dict(toks=toks, table=table, blk=blk, off=off).items()}
    with torch.no_grad():
        p_logits = port_engine._chunk_logits(
            port_eng._cfg._replace(window=window), C, port_eng.params, p_ck,
            p_cv, t["toks"], torch.tensor([start], dtype=torch.int32),
            torch.tensor([n_valid], dtype=torch.int32), t["table"],
            t["blk"], t["off"])
    assert p_logits.shape == (1, VOCAB)
    err = float(np.abs(p_logits[0].numpy() - np.asarray(r_logits)).max())
    assert err <= CHUNK_TOL, err
    for got, want in ((p_ck, r_ck), (p_cv, r_cv)):
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) \
            <= CHUNK_TOL
    # the written rows really moved the cache (not a vacuous compare)
    assert not np.allclose(p_ck.numpy(), ck)
