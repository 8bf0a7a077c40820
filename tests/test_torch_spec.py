"""The PyTorch port's greedy speculative decoding against the JAX
reference (``mxnet_tpu_torch/serve/spec.py``, ``serve/engine.py``).

Token identity: the port's spec-on streams equal the reference
``mx.serve.Engine(spec_k=..., draft_params=...)`` streams and the port's
spec-off streams, on the gpt2 and llama fixtures (``torch_port_fixtures``),
under preemption, with the prefix cache under eviction, and at the
``max_model_len`` boundary.  The draft is the target's first layer, as
``tests/test_spec_decode.py`` builds it (on the llama case the target's
layer-1 residual projections are damped by 0.05, the reference's
distilled-family recipe, so drafts are accepted).  The draft and verify
bodies are held against the reference's ``_build_draft`` /
``_build_verify`` on the same seeded inputs: equal tokens and the
written float32 K/V within BODY_TOL.  The rest ports the reference's
engine cases (inertness at spec_k=0, validation, stats, the ledger, the
warm-up grid, warm restarts, the fingerprint) and the acceptance rule.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx
from torch_port_fixtures import \
    collect_engines_after_module  # noqa: F401  (autouse)

import mxnet_tpu as mx
from mxnet_tpu.serve import spec as ref_spec
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.telemetry import flight
from mxnet_tpu_torch.serve import spec as port_spec

VOCAB = fx.VOCAB
ENGINE_KW = dict(block_size=4, num_blocks=64, max_batch=4, max_model_len=64,
                 max_prefills_per_step=2)
# float32 K/V written by the port's and the reference's draft/verify
# bodies, the same math in another summation order: max |port - ref| <=
# BODY_TOL * max(1, max |ref|).  The fixtures' K/V reach |7| (0.35-scale
# weights), where one float32 ulp is ~5e-7; layer 1's rows carry layer
# 0's attention over up to 63 cached positions, ~20 ulps apart at most.
BODY_TOL = 1e-5


def _draft_of(params, damp=None):
    """(target, draft): the draft is the target's first layer; with
    ``damp`` the target's layer-1 proj and ff_down weights are scaled
    first (the reference's distilled-family trick)."""
    src = dict(params)
    if damp is not None:
        for k, v in params.items():
            if k.startswith("gpt_l1_") and (k.endswith("proj_weight")
                                            or k.endswith("ff_down_weight")):
                src[k] = v * damp
    return src, {k: v for k, v in src.items()
                 if not k.startswith("gpt_l1_")}


def _spec_kw(draft, k=3, heads=4):
    return dict(spec_k=k, draft_params=draft, draft_num_heads=heads,
                draft_window=0)


def _port(params, heads, **kw):
    return mt.serve.Engine(params, num_heads=heads, device="cpu",
                           **{**ENGINE_KW, **kw})


def _ref(params, heads, **kw):
    return mx.serve.Engine(params, num_heads=heads, **{**ENGINE_KW, **kw})


def _prompts(ns=(7, 12, 5, 9), seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (n,)).astype(np.int32) for n in ns]


def _serve(eng, prompts, max_new=12, sequential=False):
    reqs = []
    for p in prompts:
        reqs.append(eng.submit(p, max_new_tokens=max_new))
        if sequential:
            eng.run()
    eng.run()
    st = eng.stats()
    eng.shutdown()
    return [r.tokens for r in reqs], [r.status for r in reqs], st


# -- token identity: port spec-on == reference spec-on == port spec-off -------
def _prefix_workload():
    rng = np.random.RandomState(31)
    prefix = rng.randint(0, VOCAB, (12,)).astype(np.int32)
    shared = [np.concatenate([prefix, rng.randint(0, VOCAB, (5,))
                              .astype(np.int32)]) for _ in range(3)]
    churn = [rng.randint(0, VOCAB, (24,)).astype(np.int32)
             for _ in range(2)]
    return [shared[0], churn[0], shared[1], churn[1], shared[2]]


# case -> (variant, damp, k, engine kw, prompts, max_new, sequential)
IDENTITY_CASES = {
    "gpt2_plain": ("gpt2", None, 3, {}, _prompts(), 12, False),
    "llama_gqa": ("llama", 0.05, 4, {}, _prompts(), 12, False),
    "preemption": ("llama", 0.05, 4, dict(num_blocks=22),
                   _prompts((12, 9, 14, 7, 11, 8), seed=21), 16, False),
    "prefix_eviction": ("gpt2", None, 3,
                        dict(num_blocks=16, max_model_len=48),
                        _prefix_workload(), 8, True),
    "model_len_boundary": ("gpt2", None, 4, dict(max_model_len=32),
                           [np.random.RandomState(41).randint(
                               0, VOCAB, (20,)).astype(np.int32)
                            for _ in range(3)], 12, False),
}


@pytest.mark.parametrize("case", sorted(IDENTITY_CASES))
def test_spec_streams_equal_reference_and_spec_off(case):
    variant, damp, k, kw, prompts, max_new, seq = IDENTITY_CASES[case]
    _, params, heads = fx.model(variant)
    target, draft = _draft_of(params, damp)
    spec = _spec_kw(draft, k)
    ref, ref_status, ref_st = _serve(_ref(target, heads, **kw, **spec),
                                     prompts, max_new, seq)
    got, status, st = _serve(_port(target, heads, **kw, **spec), prompts,
                             max_new, seq)
    # the spec-off stream, on an uncontended cache-off engine
    plain, _, _ = _serve(_port(target, heads, prefix_cache=False),
                         prompts, max_new, seq)
    assert st.spec_verifies > 0, "no verify pass — vacuous"
    assert status == ref_status == ["finished"] * len(prompts)
    assert got == ref
    assert got == plain
    assert all(len(t) == max_new for t in got)
    assert (st.spec_verifies, st.spec_drafted_tokens,
            st.spec_accepted_tokens) == (ref_st.spec_verifies,
                                         ref_st.spec_drafted_tokens,
                                         ref_st.spec_accepted_tokens)
    if case == "gpt2_plain":
        assert st.spec_rejected_tokens > 0     # rollback exercised
    if case == "llama_gqa":
        assert st.accepted_per_verify > 1.0    # the draft earns
    if case == "preemption":
        assert st.preemptions > 0, "no cache pressure — vacuous"
    if case == "prefix_eviction":
        assert st.prefix_hits > 0 and st.prefix_evictions > 0


# -- the program bodies against the reference's -------------------------------
def _body_inputs(port_eng, rng, B=3, k=3, W=16, nb=64):
    """Seeded caches (the target's geometry), tables and positions: row
    0 at a block boundary, row 1 mid-block, row 2 a padding row (pos 0,
    all-null table); row 1 runs past the table so its last candidates
    route to the null block."""
    cfg = port_eng._cfg
    shape = (cfg.n_layers, nb, cfg.block_size, cfg.kv_heads, cfg.head_dim)
    ck = (rng.randn(*shape) * 0.5).astype(np.float32)
    cv = (rng.randn(*shape) * 0.5).astype(np.float32)
    pos = np.array([8, W * cfg.block_size - 2, 0], np.int32)[:B]
    tables = np.zeros((B, W), np.int32)
    free = rng.permutation(np.arange(1, nb))
    used = 0
    for b in range(B - 1):
        n = min(W, -(-(int(pos[b]) + k + 1) // cfg.block_size))
        tables[b, :n] = free[used:used + n]
        used += n
    rows = rng.randint(0, VOCAB, (B, k + 1)).astype(np.int32)
    return ck, cv, pos, tables, rows


def _assert_close(got, want):
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= BODY_TOL * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("variant", ["gpt2", "llama"])
def test_verify_body_matches_reference(variant):
    import jax.numpy as jnp

    _, params, heads = fx.model(variant)
    k = 3
    ref_eng, port_eng = _ref(params, heads), _port(params, heads)
    rng = np.random.RandomState(11)
    ck, cv, pos, tables, rows = _body_inputs(port_eng, rng, k=k)
    fn = ref_spec._build_verify(ref_eng._cfg, k, donate=False)
    r_tok, r_ck, r_cv = fn(ref_eng.params, jnp.asarray(ck), jnp.asarray(cv),
                           jnp.asarray(rows), jnp.asarray(pos),
                           jnp.asarray(tables), jnp.zeros((2,), jnp.uint32))
    p_ck, p_cv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with torch.no_grad():
        p_tok = port_spec._verify(
            port_eng._cfg, k, torch.from_numpy(rows), torch.from_numpy(pos),
            torch.from_numpy(tables), params=port_eng.params, ck=p_ck,
            cv=p_cv)
    assert p_tok.dtype == torch.int32 and p_tok.shape == (3, k + 1)
    assert p_tok.tolist() == np.asarray(r_tok).tolist()
    _assert_close(p_ck, r_ck)
    _assert_close(p_cv, r_cv)
    assert not np.allclose(p_ck.numpy(), ck)   # the rows were written


@pytest.mark.parametrize("variant", ["gpt2", "llama"])
def test_draft_body_matches_reference(variant):
    """Held where the draft is defined: every step of row 0, and row 1's
    steps before it passes the table, plus the K/V outside the null
    block.  Past the table the two differ by design and harmlessly: the
    port zeroes the table row and writes into the null block, while the
    reference's gather fills an out-of-range index and its scatter drops
    the write.  Such a step is a beyond-quota draft, and the padding row
    2 reads the null block, so neither is compared."""
    import jax.numpy as jnp

    _, params, heads = fx.model(variant)
    k = 3
    _, draft = _draft_of(params)
    ref_eng = _ref(params, heads, **_spec_kw(draft, k))
    port_eng = _port(params, heads, **_spec_kw(draft, k))
    rng = np.random.RandomState(13)
    ck, cv, pos, tables, rows = _body_inputs(port_eng, rng, k=k)
    ck, cv = ck[:1].copy(), cv[:1].copy()          # the draft's one layer
    toks = rows[:, 0].copy()
    fn = ref_spec._build_draft(ref_eng._spec.cfg, k, donate=False)
    r_tok, r_ck, r_cv = fn(ref_eng._spec.params, jnp.asarray(ck),
                           jnp.asarray(cv), jnp.asarray(toks),
                           jnp.asarray(pos), jnp.asarray(tables),
                           jnp.zeros((2,), jnp.uint32))
    sw = port_eng._spec
    p_ck, p_cv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with torch.no_grad():
        p_tok = port_spec._draft(
            sw.cfg, k, torch.from_numpy(toks), torch.from_numpy(pos),
            torch.from_numpy(tables), params=sw.params, ck=p_ck, cv=p_cv)
    assert p_tok.dtype == torch.int32 and p_tok.shape == (3, k)
    S = tables.shape[1] * sw.cfg.block_size
    in_table = int(S - pos[1])                     # row 1's steps 0..1
    assert in_table == 2
    assert p_tok[0].tolist() == np.asarray(r_tok)[0].tolist()
    assert (p_tok[1, :in_table].tolist()
            == np.asarray(r_tok)[1, :in_table].tolist())
    _assert_close(p_ck[:, 1:], np.asarray(r_ck)[:, 1:])
    _assert_close(p_cv[:, 1:], np.asarray(r_cv)[:, 1:])
    assert not np.allclose(p_ck[:, 1:].numpy(), ck[:, 1:])


# -- the reference's engine cases ---------------------------------------------
def test_spec_k0_is_inert():
    _, params, heads = fx.model("gpt2")
    plain, off = _port(params, heads), _port(params, heads, spec_k=0)
    assert off._spec is None and off.verify_buckets() == []
    assert off._warmup_grid() == plain._warmup_grid()
    assert off._fingerprint() == plain._fingerprint()
    assert off._spec_digest == plain._spec_digest
    got, _, st = _serve(off, _prompts())
    assert got == _serve(plain, _prompts())[0]
    assert st.spec_verifies == 0 and st.spec_accept_rate is None
    assert sorted(k for k, _ in off._programs) == sorted(
        k for k, _ in plain._programs)


def test_spec_argument_validation():
    _, params, heads = fx.model("gpt2")
    _, draft = _draft_of(params)
    with pytest.raises(ValueError, match="draft_params"):
        _port(params, heads, spec_k=3)
    with pytest.raises(ValueError, match="spec_k"):
        _port(params, heads, spec_k=-1)
    with pytest.raises(ValueError, match="num_heads"):
        _port(params, heads, spec_k=3, draft_params=draft)
    net2 = mx.models.gpt(31, fx.SEQ, num_layers=1, d_model=32, num_heads=4)
    with pytest.raises(ValueError, match="vocab"):
        _port(params, heads, **_spec_kw(fx.ref_params(net2, seed=5)))
    short = {**draft, "gpt_pos_embed_weight":
             draft["gpt_pos_embed_weight"][:, :32]}
    with pytest.raises(ValueError, match="positional table"):
        _port(params, heads, **_spec_kw(short))


def test_spec_env_default(monkeypatch):
    _, params, heads = fx.model("gpt2")
    _, draft = _draft_of(params)
    monkeypatch.setenv("MXTPU_SERVE_SPEC", "2")
    eng = _port(params, heads, draft_params=draft, draft_num_heads=4)
    assert eng.spec_k == 2 and eng._spec is not None
    assert eng.scheduler.spec_slots == 2
    eng = _port(params, heads, spec_k=0)            # the argument wins
    assert eng.spec_k == 0 and eng._spec is None


def test_spec_stats_agree():
    """One feed: drafted = accepted + rejected, the derived means are
    the counters' quotients, the worker's window agrees with the stats,
    and tokens_generated counts emitted tokens (steps < tokens)."""
    _, params, heads = fx.model("llama")
    target, draft = _draft_of(params, damp=0.05)
    eng = _port(target, heads, **_spec_kw(draft, k=4))
    reqs = [eng.submit(p, max_new_tokens=16) for p in _prompts()]
    eng.run()
    st = eng.stats()
    assert st.spec_verifies > 0
    assert st.spec_drafted_tokens == (st.spec_accepted_tokens
                                      + st.spec_rejected_tokens)
    assert st.spec_drafted_tokens == 4 * st.spec_verifies
    assert st.accepted_per_verify == round(
        st.spec_accepted_tokens / st.spec_verifies, 4)
    assert st.spec_accept_rate == round(
        st.spec_accepted_tokens / st.spec_drafted_tokens, 4)
    assert eng._spec.accept_rate_window() == st.spec_accept_rate
    assert st.tokens_generated == sum(len(r.tokens) for r in reqs)
    assert st.spec_accepted_tokens > 0 and st.steps < st.tokens_generated


def test_quota_capped_verify_does_not_inflate_acceptance():
    _, params, heads = fx.model("llama")
    target, draft = _draft_of(params, damp=0.05)
    toks, _, st = _serve(_port(target, heads, **_spec_kw(draft, k=4)),
                         _prompts(), max_new=2)
    # the prefill emits token 1; one verify a request, capped to 1 token
    assert st.spec_verifies == 4
    assert all(len(t) == 2 for t in toks)
    assert st.spec_accepted_tokens <= st.spec_verifies


def test_draft_ledger_pruned_for_departed_requests():
    _, params, heads = fx.model("gpt2")
    _, draft = _draft_of(params)
    eng = _port(params, heads, **_spec_kw(draft))
    for p in _prompts():
        eng.submit(p, max_new_tokens=12)
    eng.run()
    assert len(eng._spec._valid) == 0         # the forget path
    ghost = type("R", (), {"rid": "ghost", "n_preemptions": 0})()
    eng._spec.note_ingested(ghost, 4)                # a leaked entry
    assert len(eng._spec._valid) == 1
    eng.submit(_prompts((5,))[0], max_new_tokens=2)
    eng.run()
    assert len(eng._spec._valid) == 0


def test_low_acceptance_dump(monkeypatch, tmp_path):
    """The low-acceptance dump goes to the flight recorder, as the
    reference's does: one file under MXTPU_FLIGHT_DIR once the window is
    full, rate-limited per reason."""
    monkeypatch.setenv("MXTPU_SPEC_MIN_ACCEPT", "0.9")
    monkeypatch.setenv("MXTPU_FLIGHT_DIR", str(tmp_path))
    flight.recorder().clear()
    _, params, heads = fx.model("gpt2")
    _, draft = _draft_of(params)
    sw = _port(params, heads, **_spec_kw(draft))._spec
    assert sw.min_accept == 0.9
    for _ in range(port_spec.MIN_WINDOW - 1):
        sw.on_verify(3, 0)
    assert os.listdir(tmp_path) == []                # window not full
    sw.on_verify(3, 0)
    sw.on_verify(3, 0)                               # rate-limited
    got = sorted(os.listdir(tmp_path))
    assert len(got) == 1 and got[0].endswith("spec_low_acceptance.json")
    with open(tmp_path / got[0]) as f:
        payload = json.load(f)
    assert payload["reason"] == "spec_low_acceptance"
    assert payload["extra"] == {"accept_rate": 0.0, "threshold": 0.9,
                                "window": port_spec.MIN_WINDOW}
    flight.recorder().clear()


def test_verify_buckets_join_the_warmup_grid():
    _, params, heads = fx.model("gpt2")
    _, draft = _draft_of(params)
    kw = dict(max_batch=2, max_model_len=16)
    plain = _port(params, heads, **kw)
    assert len(plain._warmup_grid()) == 12
    eng = _port(params, heads, **kw, **_spec_kw(draft))
    ref = _ref(params, heads, **kw, **_spec_kw(draft))
    grid = eng._warmup_grid()
    assert grid == ref._warmup_grid()
    kinds = {}
    for e in grid:
        kinds.setdefault(e["kind"], []).append(e["bucket"])
    assert kinds["verify"] == kinds["draft"] == [1, 2]
    assert kinds["draft_chunk"] == [1, 2, 4, 8, 16]
    assert eng.verify_buckets() == ref.verify_buckets() == [1, 2]
    assert eng.warmup() == 21 == len(eng._programs)
    assert eng.captures == 0                         # CPU: no graphs


def test_spec_warm_restart_builds_nothing():
    """A spec engine's manifest replayed into a new engine builds every
    program it lists (the verify, draft and draft_chunk families too);
    serving the same prompts then builds none, with the same tokens."""
    _, params, heads = fx.model("gpt2")
    _, draft = _draft_of(params)
    kw = dict(max_batch=2, max_model_len=32, **_spec_kw(draft))
    prompts = _prompts((7, 12, 5))
    cold = _port(params, heads, **kw)
    reqs = [cold.submit(p, max_new_tokens=12) for p in prompts]
    cold.run()
    manifest = cold.manifest()
    assert {e["kind"] for e in manifest} >= {"verify", "draft",
                                             "draft_chunk"}
    warm = _port(params, heads, **kw)
    assert warm.warmup(manifest) == len(manifest) == len(warm._programs)
    built = set(warm._programs)
    again = [warm.submit(p, max_new_tokens=12) for p in prompts]
    warm.run()
    assert set(warm._programs) == built
    assert [r.tokens for r in again] == [r.tokens for r in reqs]


def test_spec_fingerprint_keys_k_and_draft():
    _, params, heads = fx.model("gpt2")
    _, draft = _draft_of(params)
    a = _port(params, heads, **_spec_kw(draft, k=2))
    b = _port(params, heads, **_spec_kw(draft, k=3))
    c = _port(params, heads, **{**_spec_kw(draft, k=2), "draft_window": 3})
    assert a._fingerprint()["spec_k"] == 2
    assert a._fingerprint()["draft"]["n_layers"] == 1
    assert "kv_quant" not in a._fingerprint()["draft"]
    assert len({a._spec_digest, b._spec_digest, c._spec_digest,
                _port(params, heads)._spec_digest}) == 4


# -- the acceptance rule ------------------------------------------------------
@pytest.mark.parametrize("drafted,target,want", [
    ([5, 6, 7], [5, 6, 7, 8], (3, [5, 6, 7, 8])),     # all agree + bonus
    ([5, 6, 7], [5, 9, 7, 8], (1, [5, 9])),           # first miss at 1
    ([5, 6, 7], [4, 6, 7, 8], (0, [4])),              # first miss at 0
    ([5, 6, 7], [5, 6, 1, 8], (2, [5, 6, 1])),        # last draft misses
    ([], [3], (0, [3])),                              # k = 0
])
def test_accept_greedy(drafted, target, want):
    k = len(drafted)
    got = port_spec.accept_greedy(drafted, target, k)
    assert got == want == ref_spec.accept_greedy(drafted, target, k)
    assert got == port_spec.accept_greedy(np.array(drafted, np.int32),
                                          np.array(target, np.int32), k)
