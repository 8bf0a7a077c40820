"""The PyTorch port's serving engine against the JAX reference engine.

``mxnet_tpu_torch.serve.Engine(device="cpu")`` and the reference
``mxnet_tpu.serve.Engine``, both with ``prefix_cache=False,
prefill_chunk=0`` (``test_torch_prefix.py`` holds the two on), serve the
same numpy checkpoint (``torch_port_fixtures``); greedy token
streams must be identical, including under preemption-resume.  A
mismatch is reported with the logit margin of the first flipped token
after the shared prefix (a near-tie is a finding, never hidden by a
tolerance).
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx
from torch_port_fixtures import \
    collect_engines_after_module  # noqa: F401  (autouse)

import mxnet_tpu as mx
from mxnet_tpu.serve import QueueFull as RefQueueFull
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.serve import QueueFull
from mxnet_tpu_torch.serve import engine as port_engine

ENGINE_KW = dict(block_size=4, num_blocks=64, max_batch=4, max_model_len=64,
                 max_prefills_per_step=2)


@pytest.fixture(scope="module", params=["gpt2", "llama"])
def model(request):
    return fx.model(request.param)


def _ref_engine(model, window=0, **kw):
    net, params, heads = model
    kw = {**ENGINE_KW, **kw}
    if window:
        return mx.serve.Engine(params, num_heads=heads, window=window,
                               prefix_cache=False, prefill_chunk=0, **kw)
    return mx.serve.Engine(params, symbol=net, prefix_cache=False,
                           prefill_chunk=0, **kw)


def _port_engine(model, window=0, **kw):
    _, params, heads = model
    kw = {**ENGINE_KW, **kw}
    return mt.serve.Engine(params, num_heads=heads, window=window,
                           device="cpu", prefix_cache=False, prefill_chunk=0,
                           **kw)


def _margin(model, window, seq):
    """Top-1 minus top-2 logit after ``seq`` (the port's prefill program
    on a scratch cache) — how close a flipped token was to a tie."""
    eng = _port_engine(model, window=window)
    n = len(seq)
    blk = torch.tensor([1 + i // eng.block_size for i in range(n)])
    off = torch.tensor([i % eng.block_size for i in range(n)])
    logits = port_engine._prefill_logits(
        eng._cfg, n, eng.params, eng._cache_k, eng._cache_v,
        torch.tensor(seq), n, blk, off)[0]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def _assert_same_streams(model, window, prompts, ref_reqs, port_reqs):
    for p, r, q in zip(prompts, ref_reqs, port_reqs):
        assert r.status == q.status
        if r.tokens == q.tokens:
            continue
        i = next(i for i, (a, b) in enumerate(zip(r.tokens, q.tokens))
                 if a != b)
        seq = list(p) + r.tokens[:i]
        pytest.fail(f"token {i} flipped: reference {r.tokens[i]} vs port "
                    f"{q.tokens[i]}; port logit margin after the shared "
                    f"prefix {_margin(model, window, seq):.3g}")


def _serve(eng, prompts, max_new):
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run()
    return reqs, eng.stats()


@pytest.mark.parametrize("window", [0, 3])
def test_concurrent_streams_identical_to_reference(model, window):
    prompts = fx.prompts(6, 31)
    ref_reqs, ref_st = _serve(_ref_engine(model, window), prompts, 12)
    port_reqs, port_st = _serve(_port_engine(model, window), prompts, 12)
    _assert_same_streams(model, window, prompts, ref_reqs, port_reqs)
    assert all(r.status == "finished" for r in port_reqs)
    for f in ("steps", "completed", "rejected", "preemptions", "evictions",
              "tokens_generated", "prompt_tokens", "blocks_in_use",
              "blocks_total", "peak_block_utilization",
              "prefill_tokens_computed"):
        assert getattr(port_st, f) == getattr(ref_st, f), f


def test_preemption_resume_identical_to_reference(model):
    """The test_serve.py pattern: a cache-starved engine preempts
    mid-generation and every request still produces exactly the tokens
    of an uncontended run — in both packages, identically."""
    prompts = fx.prompts(4, 11, 8, 24)
    calm, calm_st = _serve(_port_engine(model), prompts, 24)
    tight, tight_st = _serve(_port_engine(model, num_blocks=20), prompts, 24)
    ref, ref_st = _serve(_ref_engine(model, num_blocks=20), prompts, 24)
    assert calm_st.preemptions == 0
    assert tight_st.preemptions > 0, \
        "workload did not create cache pressure — test is vacuous"
    assert tight_st.preemptions == ref_st.preemptions
    assert ([r.n_preemptions for r in tight]
            == [r.n_preemptions for r in ref])
    _assert_same_streams(model, 0, prompts, ref, tight)
    for c, t in zip(calm, tight):
        assert c.status == t.status == "finished"
        assert c.tokens == t.tokens


def test_margin_report_is_the_oracle_logit_gap(model):
    """The flip reporter's margin comes from the same logits the engine
    takes its argmax of: positive, and its top token is the engine's."""
    p = fx.prompts(1)[0]
    reqs, _ = _serve(_port_engine(model), [p], 1)
    assert _margin(model, 0, list(p)) > 0.0
    eng = _port_engine(model)
    n = p.size
    logits = port_engine._prefill_logits(
        eng._cfg, n, eng.params, eng._cache_k, eng._cache_v,
        torch.tensor(p), n, torch.arange(n) // 4 + 1, torch.arange(n) % 4)
    assert int(logits.argmax()) == reqs[0].tokens[0]


def test_engine_equals_single_request_oracle(model):
    _, params, heads = model
    prompts = fx.prompts(3)
    reqs, _ = _serve(_port_engine(model), prompts, 16)
    for p, r in zip(prompts, reqs):
        oracle = mt.models.gpt_generate(params, p[None], 16,
                                        num_heads=heads, window=0,
                                        device="cpu")
        assert r.tokens == oracle[0, p.size:].tolist()


def test_backpressure_and_no_silent_drops(model):
    prompts = fx.prompts(8, 5)
    outcome = {}
    for name, make, qfull in (("ref", _ref_engine, RefQueueFull),
                              ("port", _port_engine, QueueFull)):
        eng = make(model, max_queue=3, max_batch=2)
        accepted, overflow = [], 0
        for p in prompts:
            try:
                accepted.append(eng.submit(p, max_new_tokens=4))
            except qfull:
                overflow += 1
        too_long = eng.submit(np.zeros(60, np.int32), max_new_tokens=16)
        eng.run()
        st = eng.stats()
        outcome[name] = (overflow, len(accepted),
                         (too_long.status, too_long.reject_reason),
                         [r.status for r in accepted], [r.tokens
                                                       for r in accepted],
                         st.rejected, st.reject_reasons)
    assert outcome["port"][0] > 0, "queue bound never hit — vacuous"
    assert outcome["port"][2] == ("rejected", "exceeds_max_len")
    assert outcome["port"] == outcome["ref"]


def test_deadline_rejection_with_fake_clock(model):
    outcome = {}
    for name, make in (("ref", _ref_engine), ("port", _port_engine)):
        t = {"now": 0.0}
        eng = make(model, max_batch=1, clock=lambda: t["now"])
        first = eng.submit(fx.prompts(1)[0], max_new_tokens=3)
        late = eng.submit(fx.prompts(1, 9)[0], max_new_tokens=3,
                          deadline_s=0.5)
        gone = eng.submit(fx.prompts(1, 10)[0], max_new_tokens=3,
                          deadline_s=0.0)
        eng.step()                    # admits `first` only (max_batch 1)
        t["now"] = 1.0                # `late` expires while queued
        eng.run()
        outcome[name] = [(r.status, r.reject_reason, r.tokens)
                         for r in (first, late, gone)]
    assert outcome["port"][1][:2] == ("rejected", "deadline")
    assert outcome["port"][2][:2] == ("rejected", "deadline_at_submit")
    assert outcome["port"] == outcome["ref"]


def test_stream_and_stats(model):
    prompts = fx.prompts(3, 21)
    streams = {}
    for name, make in (("ref", _ref_engine), ("port", _port_engine)):
        eng = make(model)
        reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        streams[name] = [list(eng.stream(r)) for r in reqs]
        st = eng.stats()
        assert st.completed == 3 and st.tokens_generated == 30
        assert st.queue_depth == 0 and st.running == 0
        assert st.ttft_ms_p50 is not None and st.tpot_ms_p50 is not None
        eng.shutdown()
        with pytest.raises(RuntimeError, match="shut down"):
            eng.submit(prompts[0])
    assert streams["port"] == streams["ref"]
    assert all(len(s) == 10 for s in streams["port"])


def test_shutdown_cancels_in_flight(model):
    eng = _port_engine(model)
    reqs = [eng.submit(p, max_new_tokens=8) for p in fx.prompts(3)]
    eng.step()
    eng.shutdown()
    assert all(r.status == "cancelled" for r in reqs)
    with pytest.raises(RuntimeError, match="shut down"):
        eng.step()


@pytest.mark.parametrize("kw,item", [
    (dict(adapters=1), "reserved base slot 0"),
    (dict(symbol="plain"), "__gpt_num_heads__"),
    (dict(spec_k=2, draft_symbol="plain"), "__gpt_num_heads__")])
def test_unported_options_raise_with_their_roadmap_item(kw, item):
    """Every option is served: adapters (item 11) refuse one slot, the one
    invalid count; ``symbol=`` and ``draft_symbol=`` (item 15, ported)
    refuse a Symbol that carries no gpt decode config
    (test_torch_engine_symbol.py serves gpt symbols)."""
    _, params, heads = fx.model("gpt2")
    with mt.sym.NameManager():
        plain = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4)
    kw = {k: (plain if v == "plain" else v) for k, v in kw.items()}
    if "draft_symbol" in kw:
        kw["draft_params"] = params
    with pytest.raises(ValueError, match=item):
        mt.serve.Engine(params, num_heads=heads, device="cpu", **kw)


def test_timeseries_env_serves_with_a_statusz_section(monkeypatch):
    """``MXTPU_TIMESERIES=64`` (the reference's process-global ring): the
    engine serves the reference's tokens, and ``/statusz`` carries the
    ring's ``timeseries`` section once the ring is first asked for."""
    from mxnet_tpu_torch.telemetry import timeseries

    monkeypatch.setenv("MXTPU_TIMESERIES", "64")
    monkeypatch.setattr(timeseries, "_global_checked", False)
    model = fx.model("gpt2")
    prompts = fx.prompts(3, seed=9)
    ref = _ref_engine(model)
    want = [list(r.tokens) for r in _serve(ref, prompts, 6)[0]]
    ref.shutdown()
    eng = _port_engine(model)
    try:
        assert [list(r.tokens) for r in _serve(eng, prompts, 6)[0]] == want
        ring = timeseries.ring()
        assert ring is not None and ring.capacity == 64
        assert timeseries.sample() is True
        sec = mt.telemetry.statusz.snapshot()["timeseries"]
        assert sec["capacity"] == 64 and sec["samples"] == 1
    finally:
        timeseries.configure(0)
        eng.shutdown()


def test_greedy_engine_refuses_per_request_sampling():
    _, params, heads = fx.model("gpt2")
    eng = mt.serve.Engine(params, num_heads=heads, device="cpu",
                          **ENGINE_KW)
    p = fx.prompts(1)[0]
    for kw in (dict(temperature=0.5), dict(top_k=3), dict(logprobs=2)):
        with pytest.raises(ValueError, match="sampling-mode engine"):
            eng.submit(p, **kw)
    with pytest.raises(ValueError, match="adapters"):
        eng.submit(p, adapter_id="x")
    assert eng.paged_impl == "torch"
    cold = mt.serve.Engine(params, num_heads=heads, device="cpu",
                           prefix_cache=False, **ENGINE_KW)
    with pytest.raises(ValueError, match="prefix cache"):
        cold.submit(p, n=2)

