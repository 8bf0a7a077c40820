"""The PyTorch port's per-request sampling against the JAX reference
(``mxnet_tpu_torch/serve/engine.py`` sampling mode, ``serve/spec.py``
rejection sampling, ``models/generate.py`` ``gpt_generate``).

Ports ``tests/test_sampling.py``.  The two packages draw from different
generators (the reference's jax keys, the port's counter hash of a seed
input), so sampled tokens are held by distributions, not streams: the
warped distribution ``_filtered_probs_full`` against the reference's at
1e-6, the port's draws against it by TV distance, spec-on against
spec-off by the reference's pooled two-sample chi-square.  Greedy rows
are held token for token: a sampling engine's greedy rows equal the
greedy engine's, which equals the reference engine's.  The rest ports
the reference's engine cases: validation, the env knobs, the
only-when-on fingerprint, zero new programs for mixed configs, ``n >
1`` copy-on-write samples, logprobs, the admit trace fields and
preemption.

Left out, with their ROADMAP items: replica/router sampling (A14b).
The ``/statusz`` sampling section is held against the reference's in
``tests/test_torch_observability.py``; the registry's stochastic half
of the spec acceptance split is not compared (the two packages draw
from different generators, so their sampled counts differ).
"""

import collections

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx
from torch_port_fixtures import \
    collect_engines_after_module  # noqa: F401  (autouse)

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.serve import engine as ref_engine
from mxnet_tpu.serve import scheduler as ref_sched
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import aot
from mxnet_tpu_torch.serve import engine as port_engine

VOCAB = fx.VOCAB
ENGINE_KW = dict(block_size=4, num_blocks=64, max_batch=4, max_model_len=64,
                 max_prefills_per_step=2)
# the sampler's draws against the exact warped distribution: M draws of
# at most 13 categories sit ~0.5 * sum sqrt(2 p / (pi M)) <= 0.02 from it
# on average at M = 4000; 0.05 is the reference's pin
TV_BOUND = 0.05


def _port(params=None, **kw):
    _, p, heads = fx.model("gpt2")
    return mt.serve.Engine(p if params is None else params, num_heads=heads,
                           device="cpu", **{**ENGINE_KW, **kw})


def _ref(params=None, **kw):
    _, p, heads = fx.model("gpt2")
    return mx.serve.Engine(p if params is None else params, num_heads=heads,
                           **{**ENGINE_KW, **kw})


def _prompts(ns=(7, 12, 5, 9), seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (n,)).astype(np.int32) for n in ns]


def _draft_of(params, damp=0.05):
    src = dict(params)
    for k, v in params.items():
        if k.startswith("gpt_l1_") and (k.endswith("proj_weight")
                                        or k.endswith("ff_down_weight")):
            src[k] = v * damp
    return src, {k: v for k, v in src.items()
                 if not k.startswith("gpt_l1_")}


def _cfgs(cap=64):
    port = port_engine._ModelCfg(
        name="gpt", n_layers=2, num_heads=4, head_dim=8, kv_heads=4,
        pos_table=96, swiglu=False, tied=False, rmsnorm=False, window=0,
        block_size=4, kv_quant=False, paged_impl="torch", sampling=True,
        sample_cap=cap)
    ref = ref_engine._ModelCfg(
        name="gpt", n_layers=2, num_heads=4, head_dim=8, kv_heads=4,
        pos_table=96, swiglu=False, tied=False, rmsnorm=False, window=0,
        block_size=4, sampling=True, sample_cap=cap, numeric_watch=False,
        kv_quant=False)
    return port, ref


# -- submit-time validation ---------------------------------------------------
def test_submit_param_validation():
    eng = _port(sampling=True)
    p = _prompts()[0]
    for kw, what in ((dict(temperature=-0.5), "temperature"),
                     (dict(temperature=float("nan")), "temperature"),
                     (dict(top_p=0.0), "top_p"), (dict(top_p=1.5), "top_p"),
                     (dict(top_k=-3), "top_k"), (dict(logprobs=99),
                                                 "logprobs"),
                     (dict(n=0), "n must"), (dict(n=65), "n must")):
        with pytest.raises(ValueError, match=what):
            eng.submit(p, **kw)
    eng.shutdown()
    eng = _port()
    assert not eng._sampling and eng.sampling_info() is None
    for kw in (dict(temperature=0.7), dict(logprobs=2), dict(top_p=0.5)):
        with pytest.raises(ValueError, match="sampling"):
            eng.submit(p, **kw)
    eng.shutdown()
    with pytest.raises(ValueError, match="sampling"):
        _port(temperature=0.5, sampling=False)
    with pytest.raises(ValueError, match="sample_cap"):
        _port(sampling=True, sample_cap=0)
    # stochastic defaults turn sampling mode on by themselves
    eng = _port(temperature=0.5, top_k=8)
    assert eng._sampling and eng.sampling_info()["defaults"] == {
        "temperature": 0.5, "top_p": 1.0, "top_k": 8}
    eng.shutdown()


def test_sampling_env_default(monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_SAMPLING", "1")
    monkeypatch.setenv("MXTPU_SERVE_SAMPLE_CAP", "32")
    eng = _port()
    assert eng._sampling and eng.sample_cap == 32
    assert eng.sampling_info()["sample_cap"] == 32
    assert eng._cfg.sample_cap == 32
    eng.shutdown()
    monkeypatch.delenv("MXTPU_SERVE_SAMPLING")
    eng = _port()
    assert not eng._sampling and eng.sampling_info() is None
    assert eng._cfg.sample_cap == 0
    eng.shutdown()


# -- greedy (sampling-off) inertness ------------------------------------------
def test_greedy_engine_keeps_its_fingerprint_grid_and_tokens():
    """Sampling off (and the host tier off): the fingerprint is the one
    the engine had before either existed (its fields rebuilt here from
    the config alone), the grid is the greedy grid, and the tokens
    equal the reference engine's.  A sampling engine is another digest
    with the same grid."""
    a, b = _port(), _port()
    cfg = a._cfg
    old = dict(name=cfg.name, n_layers=cfg.n_layers,
               num_heads=cfg.num_heads, head_dim=cfg.head_dim,
               kv_heads=cfg.kv_heads, pos_table=cfg.pos_table,
               swiglu=cfg.swiglu, tied=cfg.tied, rmsnorm=cfg.rmsnorm,
               window=cfg.window, block_size=cfg.block_size,
               paged_impl=cfg.paged_impl)
    want = aot.fingerprint(device=a.device, cfg=old,
                           num_blocks=a.num_blocks,
                           table_width=a.table_width,
                           cache_dtype=str(a._cache_k.dtype))
    assert a._fingerprint() == b._fingerprint() == want
    assert a._spec_digest == aot.digest(want)[:16]
    assert "sampling" not in want["cfg"] and "sample_cap" not in want["cfg"]
    grid = [(g["kind"], g["bucket"]) for g in a._warmup_grid()]
    assert grid == ([("decode", b) for b in (1, 2, 4)]
                    + [("prefill", b) for b in (1, 2, 4, 8, 16, 32, 64)]
                    + [("chunk", b) for b in (1, 2, 4, 8, 16, 32, 64)])
    c = _port(sampling=True)
    fpc = c._fingerprint()
    assert fpc["cfg"]["sampling"] is True and fpc["cfg"]["sample_cap"] == 64
    assert c._spec_digest != a._spec_digest
    assert c._warmup_grid() == a._warmup_grid()
    prompts = _prompts()
    got = [a.submit(p, max_new_tokens=8) for p in prompts]
    a.run()
    ref = _ref()
    want_t = [ref.submit(p, max_new_tokens=8) for p in prompts]
    ref.run()
    assert [r.tokens for r in got] == [r.tokens for r in want_t]
    for e in (a, b, c, ref):
        e.shutdown()


# -- one program per (kind, bucket) for any mix -------------------------------
def test_mixed_configs_build_no_new_programs():
    """After warmup, a batch mixing greedy rows with distinct
    temperature/top-p/top-k asks, then every request's params flipped,
    builds no program: the params are inputs, never a key."""
    eng = _port(sampling=True)
    ready = eng.warmup()
    programs = sorted(eng._programs)
    assert ready == len(programs)
    cfgs = [{}, {"temperature": 0.8}, {"temperature": 1.1, "top_k": 7},
            {"temperature": 0.6, "top_p": 0.7, "logprobs": 2}]
    flip = [{"temperature": 1.3}, {}, {"temperature": 0.2, "top_k": 3},
            {"top_p": 0.5, "temperature": 0.9}]
    for batch in (cfgs, flip):
        reqs = [eng.submit(p, max_new_tokens=6, **c)
                for p, c in zip(_prompts(), batch)]
        eng.run()
        assert all(r.status == "finished" for r in reqs)
        assert sorted(eng._programs) == programs
    assert eng._programs[("decode", 4)].calls > 0
    eng.shutdown()


def test_greedy_rows_identical_across_modes():
    """Temp-0 rows co-scheduled with stochastic peers emit exactly the
    greedy engine's tokens (and the reference's)."""
    prompts = _prompts(ns=(9, 11, 6, 8), seed=23)
    greedy = _port()
    want = [greedy.submit(p, max_new_tokens=10) for p in prompts]
    greedy.run()
    ref = _ref()
    rwant = [ref.submit(p, max_new_tokens=10) for p in prompts]
    ref.run()
    eng = _port(sampling=True)
    got = [eng.submit(prompts[0], max_new_tokens=10),
           eng.submit(prompts[1], max_new_tokens=10, temperature=1.0),
           eng.submit(prompts[2], max_new_tokens=10),
           eng.submit(prompts[3], max_new_tokens=10, top_k=4,
                      temperature=0.8)]
    eng.run()
    for i in (0, 2):
        assert got[i].tokens == want[i].tokens == rwant[i].tokens
    for e in (greedy, ref, eng):
        e.shutdown()


# -- the sampler ----------------------------------------------------------------
def test_topk_warp_matches_sort_reference():
    cfg, _ = _cfgs(cap=64)
    rng = np.random.RandomState(5)
    logits = torch.from_numpy(rng.randn(16, VOCAB).astype(np.float32))
    temp = torch.full((16,), 0.7)
    topp = torch.ones(16)
    for kk in (1, 3, 10, VOCAB):
        topk = torch.full((16,), kk, dtype=torch.int32)
        got = port_engine._filtered_probs_full(cfg, logits, temp, topp,
                                               topk).numpy()
        lg = logits.numpy() / 0.7
        kth = np.sort(lg, axis=-1)[:, -kk][:, None]
        masked = np.where(lg >= kth, lg, -np.inf)
        want = np.exp(masked - masked.max(-1, keepdims=True))
        want = want / want.sum(-1, keepdims=True)
        assert np.allclose(got, want, atol=1e-6), f"top_k={kk}"


@pytest.mark.parametrize("cap", [64, 16])
def test_filtered_probs_match_reference(cap):
    """The warp itself, row by row over mixed configs (greedy rows,
    temperature, top-k past and under the cap, nuclei, both at once),
    against the reference's ``_filtered_probs_full`` at 1e-6."""
    cfg, rcfg = _cfgs(cap=cap)
    rng = np.random.RandomState(9)
    n = 12
    logits = (rng.randn(n, VOCAB) * 2).astype(np.float32)
    temp = np.array([0, 0.8, 1.3, 0.5, 1.0, 0.7, 2.0, 0, 0.9, 1.1, 0.3,
                     0.6], np.float32)
    topp = np.array([1, 1, 1, 0.75, 0.9, 0.5, 1, 0.3, 0.95, 1, 1, 0.6],
                    np.float32)
    topk = np.array([0, 0, 4, 0, 6, 0, 80, 3, 10, 1, 0, 20], np.int32)
    got = port_engine._filtered_probs_full(
        cfg, *(torch.from_numpy(a) for a in (logits, temp, topp, topk)))
    want = np.asarray(ref_engine._filtered_probs_full(
        rcfg, *(jnp.asarray(a) for a in (logits, temp, topp, topk))))
    assert np.abs(got.numpy() - want).max() <= 1e-6
    # the candidate view too: the same ids and warped logits where both
    # keep a candidate; a nucleus edge decided by cumsum rounding (top_p
    # 1.0 reached at ~1 - 1e-7) differs only on candidates of mass under
    # 1e-6
    m, idx = port_engine._filter_logits(
        cfg, *(torch.from_numpy(a) for a in (logits, temp, topp, topk)))
    rm, ridx = ref_engine._filter_logits(
        rcfg, *(jnp.asarray(a) for a in (logits, temp, topp, topk)))
    kept, rkept = np.isfinite(m.numpy()), np.isfinite(np.asarray(rm))
    both = kept & rkept
    assert np.array_equal(idx.numpy()[both], np.asarray(ridx)[both])
    assert np.abs(m.numpy()[both] - np.asarray(rm)[both]).max() <= 1e-6
    rp = np.asarray(jax.nn.softmax(rm, axis=-1))
    assert (rp[kept != rkept] < 1e-6).all()


def test_sampler_distribution_pins():
    """The port's draws against the analytic warped distribution on a
    tiny vocab (the reference's four configs), within TV_BOUND, never
    outside the filtered set; greedy rows exact argmax."""
    V, M = 13, 4000
    cfg, _ = _cfgs(cap=64)
    rng = np.random.RandomState(11)
    row = rng.randn(V).astype(np.float32)
    logits = torch.from_numpy(np.tile(row, (M, 1)))

    def draws(temp, top_p, top_k, seed=0):
        toks = port_engine._sample_ops(
            cfg, logits, torch.full((M,), temp), torch.full((M,), top_p),
            torch.full((M,), top_k, dtype=torch.int32),
            torch.tensor([seed], dtype=torch.int32))
        return collections.Counter(toks.tolist())

    def analytic(temp, top_p, top_k):
        lg = row / temp
        order = np.argsort(-lg)
        keep = np.zeros(V, bool)
        keep[order[:top_k or V]] = True
        p = np.where(keep, np.exp(lg - lg.max()), 0.0)
        p = p / p.sum()
        csum = np.cumsum(p[order])
        keep[order[(csum - p[order]) >= top_p]] = False
        p = np.where(keep, p, 0.0)
        return {i: v / p.sum() for i, v in enumerate(p) if v > 0}

    for temp, top_p, top_k in ((0.8, 1.0, 0), (1.3, 1.0, 4),
                               (0.6, 0.75, 0), (1.0, 0.9, 6)):
        got = draws(temp, top_p, top_k)
        want = analytic(temp, top_p, top_k)
        tv = 0.5 * sum(abs(got.get(c, 0) / M - want.get(c, 0.0))
                       for c in set(got) | set(want))
        assert tv < TV_BOUND, (temp, top_p, top_k, tv)
        assert set(got) <= set(want), "sampled outside the filtered set"
        # the planted fault: temperature ignored is outside the bound
        if temp != 1.0:
            bad = analytic(1.0, top_p, top_k)
            tv_bad = 0.5 * sum(abs(got.get(c, 0) / M - bad.get(c, 0.0))
                               for c in set(got) | set(bad))
            assert tv_bad > TV_BOUND, (temp, tv_bad)
    toks = port_engine._sample_ops(
        cfg, logits[:8], torch.zeros(8), torch.ones(8),
        torch.zeros(8, dtype=torch.int32), torch.tensor([3]))
    assert toks.tolist() == [int(np.argmax(row))] * 8


def test_greedy_row_takes_the_first_maximum():
    """A greedy row with tied maxima picks the first, as argmax does
    (``topk`` promises no order among ties)."""
    cfg, _ = _cfgs(cap=8)
    logits = torch.zeros(3, 20)
    logits[:, [4, 9, 15]] = 2.0
    toks = port_engine._sample_ops(cfg, logits, torch.zeros(3),
                                   torch.ones(3),
                                   torch.zeros(3, dtype=torch.int32),
                                   torch.tensor([1]))
    assert toks.tolist() == [4, 4, 4]


def test_uniforms_are_seeded_counter_draws():
    """The counter hash: the same (seed, purpose) gives the same bits,
    another seed or purpose other draws, all in (0, 1) and close to
    uniform."""
    from mxnet_tpu_torch.models.generate import _uniform

    u = _uniform(7, 1, (64, 64), "cpu")
    assert torch.equal(u, _uniform(torch.tensor([7], dtype=torch.int32), 1,
                                   (64, 64), "cpu"))
    assert not torch.equal(u, _uniform(8, 1, (64, 64), "cpu"))
    assert not torch.equal(u, _uniform(7, 2, (64, 64), "cpu"))
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    hist = torch.histc(u, bins=8, min=0.0, max=1.0) / u.numel()
    assert float((hist - 0.125).abs().max()) < 0.01


def test_two_seeds_draw_differently_and_one_seed_repeats():
    """Same inputs, different seeds: different draws; two engines with
    the same seed: the same stream."""
    p = _prompts(ns=(10,), seed=3)[0]

    def stream(seed):
        eng = _port(sampling=True, seed=seed)
        reqs = [eng.submit(p, max_new_tokens=8, temperature=1.5)
                for _ in range(4)]
        eng.run()
        eng.shutdown()
        return [r.tokens for r in reqs]

    a, b, c = stream(0), stream(0), stream(1)
    assert a == b and a != c
    assert len({tuple(t) for t in a}) > 1     # rows draw apart too


# -- speculative decoding with rejection sampling -------------------------------
def _pair_counts(params, ekw, prompt, m, temp, seeds):
    out = collections.Counter()
    per = m // len(seeds)
    for seed in seeds:
        eng = _port(params=params, seed=seed, num_blocks=128, max_batch=8,
                    max_queue=per + 1, **ekw)
        reqs = [eng.submit(prompt, max_new_tokens=2, temperature=temp)
                for _ in range(per)]
        eng.run()
        eng.shutdown()
        out.update((r.tokens[0], r.tokens[1]) for r in reqs
                   if len(r.tokens) == 2)
    return out


def test_spec_sampling_distribution_identity():
    """Rejection-sampled speculative decoding at temperature 0.8 emits
    plain sampling's distribution: the reference's pooled two-sample
    chi-square over (token0, token1) pairs, spec-on vs spec-off, |z| <
    5 (360 generations an arm over 3 seeds)."""
    target, draft = _draft_of(fx.model("gpt2")[1])
    prompt = _prompts(ns=(9,), seed=41)[0]
    spec_kw = dict(spec_k=3, draft_params=draft, draft_num_heads=4,
                   draft_window=0, sampling=True)
    a = _pair_counts(target, dict(sampling=True), prompt, 360, 0.8,
                     seeds=(0, 1, 2))
    b = _pair_counts(target, spec_kw, prompt, 360, 0.8, seeds=(3, 4, 5))
    na, nb = sum(a.values()), sum(b.values())
    assert na > 300 and nb > 300
    cats = [c for c in set(a) | set(b) if a.get(c, 0) + b.get(c, 0) >= 10]
    rows = [(a.get(c, 0), b.get(c, 0)) for c in cats]
    rows.append((sum(v for c, v in a.items() if c not in cats),
                 sum(v for c, v in b.items() if c not in cats)))
    stat = 0.0
    for xa, xb in rows:
        tot = xa + xb
        ea, eb = tot * na / (na + nb), tot * nb / (na + nb)
        stat += ((xa - ea) ** 2 / ea if ea else 0.0)
        stat += ((xb - eb) ** 2 / eb if eb else 0.0)
    df = max(1, len(rows) - 1)
    z = (stat - df) / (2 * df) ** 0.5
    assert abs(z) < 5, (z, rows)


def test_spec_sampling_runs_and_splits_stats():
    target, draft = _draft_of(fx.model("gpt2")[1])
    eng = _port(params=target, sampling=True, spec_k=3, draft_params=draft,
                draft_num_heads=4, draft_window=0)
    reqs = [eng.submit(p, max_new_tokens=10, temperature=t, logprobs=2)
            for p, t in zip(_prompts(), (0.0, 0.7, 0.0, 0.9))]
    eng.run()
    st = eng.stats()
    eng.shutdown()
    assert all(r.status == "finished" and len(r.tokens) == 10
               for r in reqs)
    assert all(len(r.token_logprobs) == len(r.top_logprobs) == 10
               for r in reqs)
    assert st.spec_verifies > 0
    assert st.spec_drafted_tokens_stochastic > 0
    assert st.spec_drafted_tokens > st.spec_drafted_tokens_stochastic
    assert st.spec_accept_rate_stochastic is not None
    assert st.spec_accept_rate_greedy is not None


def test_spec_sampling_greedy_rows_identical():
    """A sampling engine with spec: temp-0 requests (one-hot p and q)
    emit the greedy engine's tokens, and the reference's."""
    target, draft = _draft_of(fx.model("gpt2")[1])
    prompts = _prompts(ns=(8, 13, 6), seed=33)
    ref = _ref(params=target)
    want = [ref.submit(p, max_new_tokens=12) for p in prompts]
    ref.run()
    eng = _port(params=target, sampling=True, spec_k=3, draft_params=draft,
                draft_num_heads=4, draft_window=0)
    got = [eng.submit(p, max_new_tokens=12) for p in prompts]
    eng.run()
    st = eng.stats()
    assert st.spec_verifies > 0
    for a, b in zip(want, got):
        assert a.status == b.status == "finished"
        assert a.tokens == b.tokens
    for e in (ref, eng):
        e.shutdown()


def test_verify_acceptance_against_explicit_rule():
    """The verify body's acceptance, residual and bonus on hand-made
    distributions: a draft the target gives zero mass is rejected and
    replaced from the residual; a draft the target likes more than q is
    always accepted; the bonus comes from the last row's p."""
    from mxnet_tpu_torch.serve import spec as port_spec

    cfg, _ = _cfgs(cap=4)
    k, V = 2, 6
    logits = torch.full((1, k + 1, V), -30.0)
    logits[0, 0, [1, 2]] = torch.tensor([2.0, 1.0])   # p0 on {1, 2}
    logits[0, 1, 3] = 5.0                             # p1 on {3}
    logits[0, 2, 4] = 5.0                             # bonus row: {4}
    drafted = torch.tensor([[1, 5]], dtype=torch.int32)
    q_at = torch.tensor([[0.5, 1.0]])
    q_vals = torch.zeros(1, k, 4)
    q_vals[0, 0, 0], q_vals[0, 1, 0] = 1.0, 1.0
    q_idx = torch.zeros(1, k, 4, dtype=torch.int32)
    q_idx[0, 0, 0], q_idx[0, 1, 0] = 1, 5
    orig = port_spec._verify_logits
    port_spec._verify_logits = lambda *a, **kw: logits
    try:
        outs = [port_spec._verify_rs(
            cfg, k, torch.tensor([0], dtype=torch.int32), drafted, q_at,
            q_vals, q_idx, torch.zeros(1, dtype=torch.int32), None,
            torch.ones(1), torch.ones(1), torch.zeros(1, dtype=torch.int32),
            torch.tensor([s], dtype=torch.int32), params=None, ck=None,
            cv=None) for s in range(40)]
    finally:
        port_spec._verify_logits = orig
    # draft 1 has p = e^2 / (e^2 + e) > q = 0.5: always accepted; draft
    # 5 has p = 0: always rejected, replaced by 3 (the residual's only
    # mass)
    for emit, acc, lp, tv, ti in outs:
        assert acc.tolist() == [1]
        assert emit.tolist() == [[1, 3, 3]]
        assert lp.shape == (1, 3) and ti.shape == (1, 3, 5)


# -- n > 1 copy-on-write samples -----------------------------------------------
def test_n_samples_share_prefix_cow():
    eng = _port(sampling=True)
    rng = np.random.RandomState(51)
    prompt = rng.randint(0, VOCAB, (17,)).astype(np.int32)
    req = eng.submit(prompt, max_new_tokens=6, temperature=0.9, n=3)
    assert req.samples is not None and len(req.samples) == 3
    assert [s.sample_index for s in req.samples] == [0, 1, 2]
    assert all(s.group == req.rid for s in req.samples)
    eng.step()
    eng.step()
    tables = {s.rid: list(eng.blocks.table(s.rid))
              for s in req.samples if s.rid in eng.blocks._tables}
    prim = set(tables.get(req.rid, []))
    shared = [set(t) & prim for rid, t in tables.items() if rid != req.rid]
    assert shared and all(len(s) >= 17 // 4 - 1 for s in shared)
    eng.run()
    st = eng.stats()
    eng.shutdown()
    assert all(s.status == "finished" for s in req.samples)
    assert st.prefix_hits == 2
    assert st.prefix_tokens_saved == 2 * 16
    assert st.prefill_tokens_computed == 17 + 2 * 1


def test_n_samples_greedy_are_identical_and_validated():
    eng = _port()
    prompt = _prompts(ns=(9,), seed=61)[0]
    req = eng.submit(prompt, max_new_tokens=5, n=2)
    eng.run()
    assert [s.status for s in req.samples] == ["finished"] * 2
    assert req.samples[0].tokens == req.samples[1].tokens
    assert not eng.has_work()
    eng.shutdown()
    eng = _port(prefix_cache=False)
    with pytest.raises(ValueError, match="prefix cache"):
        eng.submit(prompt, n=2)
    eng.shutdown()


def test_n_samples_primary_done_in_one_step_releases_siblings():
    """A primary that finishes in its first step (one new token) still
    releases its siblings: ``has_work`` counts the pending fan-out."""
    eng = _port(sampling=True)
    req = eng.submit([2, 4, 6, 8], max_new_tokens=1, temperature=0.8, n=3)
    eng.run()
    assert [len(s.tokens) for s in req.samples] == [1, 1, 1]
    assert all(s.status == "finished" for s in req.samples)
    eng.shutdown()


# -- logprobs ------------------------------------------------------------------
def test_logprob_outputs():
    eng = _port(sampling=True)
    p = _prompts(ns=(10,), seed=71)[0]
    greedy = eng.submit(p, max_new_tokens=6, logprobs=3)
    stoch = eng.submit(p, max_new_tokens=6, temperature=0.9, logprobs=5)
    plain = eng.submit(p, max_new_tokens=6)
    eng.run()
    eng.shutdown()
    for r, want in ((greedy, 3), (stoch, 5)):
        assert len(r.token_logprobs) == len(r.top_logprobs) == len(r.tokens)
        for row, lp in zip(r.top_logprobs, r.token_logprobs):
            assert len(row) == want
            vals = [v for _, v in row]
            assert vals == sorted(vals, reverse=True)
            assert all(v <= 0.0 for v in vals)
            assert lp <= vals[0] + 1e-6
    for tok, lp, row in zip(greedy.tokens, greedy.token_logprobs,
                            greedy.top_logprobs):
        assert row[0][0] == tok and abs(row[0][1] - lp) < 1e-6
    assert len(plain.token_logprobs) == len(plain.tokens)
    assert plain.top_logprobs == []


def test_greedy_logprobs_equal_reference():
    """A greedy request's logprob outputs are the model's raw
    log-softmax: the reference's numbers to float32 rounding."""
    p = _prompts(ns=(10,), seed=72)[0]
    got = []
    for make in (_port, _ref):
        eng = make(sampling=True)
        r = eng.submit(p, max_new_tokens=5, logprobs=5)
        eng.run()
        eng.shutdown()
        got.append(r)
    port, ref = got
    assert port.tokens == ref.tokens
    assert np.allclose(port.token_logprobs, ref.token_logprobs, atol=1e-5)
    assert [[t for t, _ in row] for row in port.top_logprobs] == \
        [[t for t, _ in row] for row in ref.top_logprobs]


# -- request traces -------------------------------------------------------------
def test_admit_trace_carries_sampling_params():
    """The admit event carries the reference's sampling fields, and a
    plain greedy request none."""
    events = []

    class Rec:
        enabled = True

        def submitted(self, req):
            pass

        def event(self, req, name, **args):
            events.append((req.rid, name, args))

        def terminal(self, req, name, **args):
            pass

    eng = _port(sampling=True)
    eng.scheduler.trace = Rec()
    plain = eng.submit(_prompts()[0], max_new_tokens=3)
    stoch = eng.submit(_prompts()[1], max_new_tokens=3, temperature=0.8,
                       top_k=5, logprobs=2)
    eng.run()
    eng.shutdown()

    def admit(rid):
        return next(a for r, n, a in events
                    if r == rid and n in ("admitted", "resumed"))

    assert "sampling" not in admit(plain.rid)
    want = ref_sched.Request([1, 2], 3, temperature=0.8, top_p=1.0,
                             top_k=5, logprobs=2).trace_sampling()
    assert admit(stoch.rid)["sampling"] == want["sampling"]


# -- preemption composes --------------------------------------------------------
def test_stochastic_requests_survive_preemption():
    eng = _port(sampling=True, num_blocks=18, max_model_len=48)
    prompts = _prompts(ns=(12, 9, 14, 7, 11), seed=81)
    reqs = [eng.submit(p, max_new_tokens=12, temperature=0.8)
            for p in prompts]
    eng.run()
    st = eng.stats()
    eng.shutdown()
    assert st.preemptions > 0, "no cache pressure — vacuous"
    assert all(r.status == "finished" and len(r.tokens) == 12
               and len(r.token_logprobs) == 12 for r in reqs)


# -- gpt_generate sampling -------------------------------------------------------
def test_gpt_generate_sampling():
    """``gpt_generate(temperature=, top_k=)``: the first sampled token of
    4000 rows against softmax(logits / T) over the top k (the
    reference's own logits, from its greedy oracle's step), within
    TV_BOUND; top_k=1 is greedy; a seed repeats, another differs."""
    net, params, heads = fx.model("gpt2")
    prompt = _prompts(ns=(6,), seed=91)[0]
    M, T, K = 4000, 0.7, 5
    out = mt.models.gpt_generate(params, np.tile(prompt, (M, 1)), 1,
                                 num_heads=heads, temperature=T, top_k=K,
                                 window=0, device="cpu", seed=3)
    got = collections.Counter(out[:, -1].tolist())
    # the reference's next-token logits at the prompt's end
    from mxnet_tpu.models import generate as ref_gen
    ref = ref_gen.gpt_generate(params, prompt[None], 1, num_heads=heads,
                               window=0)
    eng = _ref(sampling=True)
    r = eng.submit(prompt, max_new_tokens=1, logprobs=5)
    eng.run()
    eng.shutdown()
    assert r.tokens[0] == int(ref[0, -1])
    lp = dict((t, v) for t, v in r.top_logprobs[0])
    top = sorted(lp, key=lambda t: -lp[t])[:K]
    w = np.exp(np.array([lp[t] for t in top]) / T)
    want = dict(zip(top, w / w.sum()))
    tv = 0.5 * sum(abs(got.get(c, 0) / M - want.get(c, 0.0))
                   for c in set(got) | set(want))
    assert set(got) <= set(want) and tv < TV_BOUND, tv
    greedy = mt.models.gpt_generate(params, prompt[None], 6,
                                    num_heads=heads, window=0, device="cpu")
    one = mt.models.gpt_generate(params, prompt[None], 6, num_heads=heads,
                                 temperature=0.9, top_k=1, window=0,
                                 device="cpu")
    assert np.array_equal(greedy, one)
    a, b, c = (mt.models.gpt_generate(params, np.tile(prompt, (8, 1)), 6,
                                      num_heads=heads, temperature=1.2,
                                      window=0, device="cpu", seed=s)
               for s in (1, 1, 2))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
