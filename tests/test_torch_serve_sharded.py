"""The port's tensor-parallel serving (``Engine(tp=N)``,
``parallel/mesh.py``, ``parallel/partition.py``) against the JAX
reference's (``tests/test_serve_sharded.py`` case by case).

The reference shards over the 8 forced host devices of
``tests/conftest.py``; the port holds its ``{'tp': N}`` mesh on the one
CPU through ``MXTPU_TORCH_VIRTUAL_DEVICES``, each shard its own tensors.
The guarantees: the partitioner's specs and digests are the reference's;
tp=N serves the tp=1 engine's tokens and the reference tp=N engine's
(sharding is layout, never math), under preemption, with custom rules,
int8 weights and K/V, adapters and the host tier; per-device K/V bytes
drop by tp while the block accounting stays; sharded programs restart
from the export store with no fresh trace, their fingerprints keyed by
tp and the rules digest; shutdown frees every shard.  CPU, tiny models.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx
from torch_port_fixtures import \
    collect_engines_after_module  # noqa: F401  (autouse)

import mxnet_tpu as mx
from mxnet_tpu.parallel import partition as ref_partition
from mxnet_tpu.parallel.mesh import PartitionSpec as RP
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.aot import export_store
from mxnet_tpu_torch.models.generate import normalize_gpt_params
from mxnet_tpu_torch.parallel import mesh as port_mesh
from mxnet_tpu_torch.parallel import partition as port_partition
from mxnet_tpu_torch.parallel.mesh import PartitionSpec as P
from mxnet_tpu_torch.serve import engine as port_engine

ENGINE_KW = dict(block_size=4, num_blocks=64, max_batch=4, max_model_len=64,
                 max_prefills_per_step=2)


@pytest.fixture(autouse=True)
def virtual_devices(monkeypatch):
    monkeypatch.setenv(port_mesh.ENV_VIRTUAL, "4")


@pytest.fixture(scope="module")
def gpt2():
    return fx.model("gpt2")


@pytest.fixture(scope="module")
def llama():
    return fx.model("llama")


def _port(model, **kw):
    _, params, heads = model
    return mt.serve.Engine(params, num_heads=heads, device="cpu",
                           **{**ENGINE_KW, **kw})


def _ref(model, **kw):
    net, params, _ = model
    return mx.serve.Engine(params, symbol=net, **{**ENGINE_KW, **kw})


def _serve(eng, prompts, max_new=12, shutdown=True, **sub):
    reqs = [eng.submit(p, max_new_tokens=max_new, **sub) for p in prompts]
    eng.run()
    assert all(r.status == "finished" for r in reqs)
    if shutdown:
        eng.shutdown()
    return [list(r.tokens) for r in reqs]


def _tokens_at(model, tp, prompts, max_new=12, **kw):
    return _serve(_port(model, tp=tp, **kw), prompts, max_new)


# -- the partitioner, against the reference's -------------------------------
def _both(fn):
    """``fn(partition module, PartitionSpec)`` on both packages, specs as
    plain tuples."""
    out = []
    for mod, spec in ((ref_partition, RP), (port_partition, P)):
        got = fn(mod, spec)
        out.append({k: tuple(v) for k, v in got.items()}
                   if isinstance(got, dict) else got)
    return out


def test_match_partition_rules_first_match_wins_and_scalars_replicate():
    params = {"a_q_weight": np.zeros((8, 4)), "a_q_bias": np.zeros((8,)),
              "a_scale": np.zeros(()), "a_other": np.zeros((4, 4))}
    ref, port = _both(lambda m, S: m.match_partition_rules(
        [(r"_q_weight$", S("tp", None)), (r"_q_", S("tp"))], params))
    assert port == ref == {"a_q_weight": ("tp", None), "a_q_bias": ("tp",),
                           "a_scale": (), "a_other": ()}


def test_match_partition_rules_default_raise_and_full_mode():
    params = {"w": np.zeros((4, 4))}
    ref, port = _both(lambda m, S: m.match_partition_rules(
        [], params, default=lambda name, shape: S(None, "x")))
    assert port == ref == {"w": (None, "x")}
    with pytest.raises(ValueError, match="no partition rule"):
        port_partition.match_partition_rules([], params, default="raise")
    ref, port = _both(lambda m, S: m.match_partition_rules(
        [(r"w", S("tp", None))], {"w": (4, 4)}))
    assert port == ref == {"w": ("tp", None)}
    two = {"fc1_weight": np.zeros((8, 4)),
           "fc1_weight_extra": np.zeros((8, 4))}
    for mode in ("full", "search"):
        ref, port = _both(lambda m, S: m.match_partition_rules(
            [("fc1_weight", S("tp", None))], two, mode=mode))
        assert port == ref
    assert port["fc1_weight_extra"] == ("tp", None)


@pytest.mark.parametrize("text", [
    r".*_(q|k|v)_weight$=tp,-; .*_proj_weight$=-,tp ; .*=",
    r".*_(q|k|v)_weight$=tp,-;.*_(q|k|v)_bias$=tp;.*_proj_weight$=-,tp;.*=",
    r"gpt_l\d+_ff_(up|gate)_weight$=tp,-;.*=", ""])
def test_parse_rules_and_digest_equal_the_reference(text):
    port = port_partition.parse_rules(text)
    ref = ref_partition.parse_rules(text)
    assert [(p, tuple(s)) for p, s in port] == \
        [(p, tuple(s)) for p, s in ref]
    assert port_partition.rules_digest(port) == \
        ref_partition.rules_digest(ref)


def test_parse_rules_errors_and_default_digest():
    with pytest.raises(ValueError):
        port_partition.parse_rules("no-equals-sign")
    with pytest.raises(ValueError, match="empty entry"):
        port_partition.parse_rules(".*_w$=tp,,hidden")
    assert port_partition.parse_rules(None) == []
    for name in ("gpt", "draft"):
        assert port_partition.rules_digest(
            port_partition.gpt_partition_rules(name)) == \
            ref_partition.rules_digest(
                ref_partition.gpt_partition_rules(name))


@pytest.mark.parametrize("variant", ["gpt2", "llama"])
def test_gpt_rules_cover_every_param_as_the_reference(variant):
    _, params, _ = fx.model(variant)
    params = normalize_gpt_params(params, "gpt")
    ref, port = _both(lambda m, S: m.match_partition_rules(
        m.gpt_partition_rules(), params, default="raise"))
    assert port == ref
    assert port["gpt_l0_q_weight"] == ("tp", None)
    assert port["gpt_l0_proj_weight"] == (None, "tp")
    assert port["gpt_l0_proj_bias"] == () == port["gpt_tok_embed_weight"]


# -- tp correctness ----------------------------------------------------------
@pytest.mark.parametrize("variant", ["gpt2", "llama"])
def test_tp2_token_identical_to_tp1_and_the_reference(variant):
    model = fx.model(variant)
    prompts = fx.prompts(4)
    e2 = _port(model, tp=2)
    assert e2.tp == 2 and e2.mesh.shape == {"tp": 2}
    assert e2._cfg.tp == 2 and dict(e2._cfg.split)
    t2 = _serve(e2, prompts)
    e1 = _port(model)
    assert e1.tp == 1 and e1.mesh is None and e1._cfg.split == ()
    assert _serve(e1, prompts) == t2
    assert _serve(_ref(model, tp=2), prompts) == t2


def test_tp4_token_identical_to_tp1(gpt2):
    prompts = fx.prompts(3, seed=4)
    assert _tokens_at(gpt2, 4, prompts) == _tokens_at(gpt2, 1, prompts)


def test_tp2_token_identical_gqa_variant_under_preemption(llama):
    """The llama variant with cache pressure: preemption and resume
    through sharded programs stay token-exact."""
    prompts = fx.prompts(4, seed=11, lo=8, hi=24)
    calm = _tokens_at(llama, 1, prompts, max_new=24)
    tight = _port(llama, tp=2, num_blocks=20)
    got = _serve(tight, prompts, max_new=24, shutdown=False)
    assert tight.stats().preemptions > 0, "no cache pressure: vacuous"
    tight.shutdown()
    assert got == calm


def test_tp2_spec_decode_keeps_the_draft_replicated(gpt2):
    """Speculative decoding under tp: the draft stays whole (its
    parameters and cache unsharded), the verify program sharded, the
    greedy stream the tp=1 spec engine's."""
    _, params, _ = gpt2
    draft = {k: v for k, v in params.items() if not k.startswith("gpt_l1_")}
    kw = dict(spec_k=2, draft_params=draft, draft_num_heads=4)
    prompts = fx.prompts(3, seed=19)
    e2 = _port(gpt2, tp=2, **kw)
    assert not any(isinstance(v, list) for v in e2._spec.params.values())
    assert torch.is_tensor(e2._spec.cache_k)
    assert _serve(e2, prompts) == _tokens_at(gpt2, 1, prompts, **kw)


def test_tp_validation_errors(gpt2):
    with pytest.raises(ValueError, match="must divide"):
        _port(gpt2, tp=3)                       # 4 heads % 3
    with pytest.raises(ValueError, match="exceeds"):
        _port(gpt2, tp=8)                       # 4 virtual devices
    with pytest.raises(ValueError, match="tp must be"):
        _port(gpt2, tp=0)
    with pytest.raises(ValueError, match="P\\(None, 'tp'\\)"):
        _port(gpt2, tp=2, partition_rules=r".*_q_bias$=-,tp;.*=")
    with pytest.raises(ValueError, match="not the mesh axis"):
        _port(gpt2, tp=2, partition_rules=r".*_q_weight$=dp,-;.*=")
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(NotImplementedError, match="multi-card"):
        port_mesh.make_mesh({"tp": 2}, devices=cards)


def test_visible_devices_count_the_virtual_knob(monkeypatch):
    assert port_mesh.visible_devices("cpu") == [torch.device("cpu")] * 4
    monkeypatch.setenv(port_mesh.ENV_VIRTUAL, "1")
    assert port_mesh.visible_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        port_mesh.make_mesh({"tp": 2}, devices=[torch.device("cpu")])
    mesh = port_mesh.make_mesh({"tp": -1},
                               devices=[torch.device("cpu")] * 3)
    assert mesh.shape == {"tp": 3} and mesh.device_ids == [0, 1, 2]


def test_tp_env_default(gpt2, monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_TP", "2")
    eng = _port(gpt2)
    assert eng.tp == 2 and eng.mesh is not None
    eng.shutdown()


@pytest.mark.parametrize("rules", [
    # the reference test's override: q/k/v head-sharded with biases
    r".*_(q|k|v)_weight$=tp,-;.*_(q|k|v)_bias$=tp;.*_proj_weight$=-,tp;.*=",
    # q/k/v replicated: computed whole, sliced to each shard's heads
    r".*_proj_weight$=-,tp;.*_ff_up_weight$=tp,-;.*_ff_up_bias$=tp;.*=",
    # out-sharded proj and down, row-sharded q and a sharded embedding
    r".*_proj_weight$=tp,-;.*_ff_down_weight$=tp,-;.*_q_weight$=-,tp;"
    r".*_tok_embed_weight$=-,tp;.*="])
def test_custom_partition_rules_string(gpt2, monkeypatch, rules):
    """An operator rule override (the env syntax) keys another digest
    and fingerprint and serves the same tokens (layout, not math)."""
    prompts = fx.prompts(4)
    dflt = _port(gpt2, tp=2)
    monkeypatch.setenv("MXTPU_SERVE_PARTITION_RULES", rules)
    eng = _port(gpt2, tp=2)
    assert eng._rules_digest == ref_partition.rules_digest(
        ref_partition.parse_rules(rules))
    assert eng._rules_digest != dflt._rules_digest
    assert export_store.digest(eng._fingerprint()) != \
        export_store.digest(dflt._fingerprint())
    assert _serve(eng, prompts) == _serve(dflt, prompts)


# -- capacity ----------------------------------------------------------------
def test_kv_capacity_scales_with_tp(llama):
    e1, e2 = _port(llama), _port(llama, tp=2)
    kv1, kv2 = e1.kv_cache_stats(), e2.kv_cache_stats()
    # the same block accounting at every tp...
    assert e1.blocks.total_blocks == e2.blocks.total_blocks
    assert kv1["bytes_total"] == kv2["bytes_total"]
    # ...but a device's bytes drop by tp, as its shard tensors hold
    assert kv1["bytes_per_device"] == 2 * kv2["bytes_per_device"]
    for s in range(2):
        assert (e2._cache_k[s].nbytes + e2._cache_v[s].nbytes
                == kv2["bytes_per_device"])
        assert e2._cache_k[s].shape[3] == 1          # 2 kv heads / tp
    e1.shutdown()
    e2.shutdown()


def test_int8_kv_scales_shard_with_the_cache(gpt2):
    eng = _port(gpt2, tp=2, kv_dtype="int8")
    kv = eng.kv_cache_stats()
    assert kv["scale_bytes_per_device"] * 2 == kv["scale_bytes_total"]
    assert [tuple(t.shape) for t in eng._scale_k] == [(2, 64, 4, 2)] * 2
    eng.shutdown()


def test_statusz_reports_mesh_and_per_device_occupancy(gpt2):
    eng = _port(gpt2, tp=2)
    req = eng.submit(fx.prompts(1)[0], max_new_tokens=4)
    eng.step()
    s = eng.statusz()
    sh = s["sharding"]
    assert sh["tp"] == 2 and sh["mesh"]["axes"] == {"tp": 2}
    assert sh["mesh"]["devices"] == [0, 1]
    assert sh["rules_digest"] and sh["spec_digest"]
    per = sh["params_bytes_per_device"]
    assert len(per) == 2 and per[0] == per[1]
    full = sum(int(np.asarray(v).nbytes) for v in gpt2[1].values())
    assert full / 2 < per[0] < full
    assert s["kv_blocks"]["in_use"] > 0
    assert s["kv_cache"]["bytes_in_use_per_device"] == \
        s["kv_blocks"]["in_use"] * s["kv_cache"]["bytes_per_block_per_device"]
    assert s["kv_cache"]["bytes_per_device"] * 2 == \
        s["kv_cache"]["bytes_total"]
    eng.run()
    assert req.status == "finished"
    eng.shutdown()


# -- AOT / fingerprints ------------------------------------------------------
def test_fingerprint_differs_when_tp_differs(gpt2):
    engines = [_port(gpt2, tp=tp) for tp in (1, 2, 4)]
    fps = [e._fingerprint() for e in engines]
    assert len({export_store.digest(fp) for fp in fps}) == 3
    assert "tp" not in fps[0] and "partition_rules" not in fps[0]
    assert fps[1]["tp"] == 2 and fps[1]["mesh_shape"] == {"tp": 2}
    assert fps[1]["partition_rules"] == ref_partition.rules_digest(
        ref_partition.gpt_partition_rules())
    assert len({e._spec_digest for e in engines}) == 3
    for e in engines:
        e.shutdown()


def test_sharded_aot_warm_restart_zero_fresh_traces(gpt2, tmp_path,
                                                    monkeypatch):
    """A restarted tp=2 engine loads every sharded bucket program from
    the export store (no fresh trace: its bodies raise if traced) and
    serves the cold engine's tokens."""
    telemetry.reset()
    telemetry.enable()
    try:
        def count(source):
            snap = telemetry.registry().snapshot().get(
                "mxtpu_aot_programs_total", {"samples": []})
            return sum(s["value"] for s in snap["samples"]
                       if s["labels"].get("source") == source)

        prompts = fx.prompts(2, seed=5)
        kw = dict(tp=2, aot_dir=str(tmp_path), max_batch=2,
                  max_model_len=32, prefix_cache=False, prefill_chunk=0)
        cold = _port(gpt2, **kw)
        toks = _serve(cold, prompts, max_new=6, shutdown=False)
        manifest = cold.manifest()
        cold.shutdown()
        assert count("trace") == len(manifest) >= 3
        assert len(cold._aot.entries()) == len(manifest)

        def boom(*a, **k):
            raise AssertionError("a program body was traced")

        monkeypatch.setattr(port_engine, "_token_layers", boom)
        monkeypatch.setattr(port_engine, "_dense_logits", boom)
        before = count("trace")
        warm = _port(gpt2, **kw)
        assert warm.warmup(manifest) == len(manifest)
        assert count("trace") == before
        assert count("artifact") == len(manifest)
        assert _serve(warm, prompts, max_new=6) == toks
        # a tp=1 engine on the same store loads none of them
        monkeypatch.undo()
        monkeypatch.setenv(port_mesh.ENV_VIRTUAL, "4")
        one = _port(gpt2, **{**kw, "tp": 1})
        one.warmup(manifest)
        assert count("artifact") == len(manifest)
        one.shutdown()
    finally:
        telemetry.disable()
        telemetry.reset()


# -- buffer release ----------------------------------------------------------
def test_shutdown_releases_shards_back_to_back(gpt2):
    """Two tp=4 engines back to back: the first shutdown drops every
    shard of its parameters and K/V (nothing keeps them alive), the
    caller's numpy checkpoint is untouched, and the same checkpoint
    serves again with the same tokens."""
    _, params, _ = gpt2
    before = {k: v.copy() for k, v in params.items()}
    prompts = fx.prompts(2)
    eng = _port(gpt2, tp=4)
    t1 = _serve(eng, prompts, shutdown=False)
    shards = [t for v in eng.params.values() if isinstance(v, list)
              for t in v] + list(eng._cache_k) + list(eng._cache_v)
    assert len(shards) > 8
    refs = [weakref.ref(t) for t in shards]
    del shards
    eng.shutdown()
    assert eng.params is None and eng._cache_k is None
    gc.collect()
    assert [r for r in refs if r() is not None] == []
    assert all(np.array_equal(before[k], params[k]) for k in params)
    assert _tokens_at(gpt2, 4, prompts) == t1


# -- tp composed with the other features --------------------------------------
def test_quant_tp2_token_identity(gpt2):
    """tests/test_quant_serve.py's gate: int8 weights shard like their
    floating-point parents (their scale vectors follow the rules), the
    K/V scales head-shard with the cache: tokens identical to tp=1, and
    to the reference's tp=2 engine."""
    prompts = fx.prompts(2, seed=23)
    kw = dict(quantize="int8", kv_dtype="int8")
    e2 = _port(gpt2, tp=2, **kw)
    q = e2.params["gpt_l0_q_weight"]
    assert [t.dtype for t in q] == [torch.int8] * 2
    assert torch.is_tensor(e2.params["gpt_l0_q_wscale"])     # replicated
    t2 = _serve(e2, prompts)
    assert _tokens_at(gpt2, 1, prompts, **kw) == t2
    assert _serve(_ref(gpt2, tp=2, **kw), prompts) == t2


def _lora_family(eng, k=2, rank=4):
    out = {}
    for j in range(k):
        rng = np.random.RandomState(20 + j)
        out[f"tenant-{j}"] = {
            stem: ((rng.randn(rank, din) * 0.1).astype(np.float32),
                   (rng.randn(dout, rank) * 0.1).astype(np.float32))
            for stem, (dout, din) in eng.adapter_store.stems.items()}
    return out


def test_adapter_tp2_parity(gpt2):
    """tests/test_adapters.py's gate: sharded stacks (B on d_out under an
    out-sharded parent, A on d_in under an in-sharded one, their partial
    sums joining the layer's reduction) serve the tp=1 tokens."""
    prompts = fx.prompts(3, seed=23)
    ids = [None, "tenant-0", "tenant-1"]

    def run(tp):
        eng = _port(gpt2, adapters=3, adapter_rank=4, tp=tp)
        for aid, arrays in _lora_family(eng).items():
            eng.adapter_store.register(aid, arrays, alpha=8.0)
        if tp > 1:
            dev = eng.adapter_store.device
            assert len(dev["gpt_l0_q_B"]) == 2
            assert torch.is_tensor(dev["gpt_l0_q_A"])
            assert len(dev["gpt_l0_proj_A"]) == 2
            assert torch.is_tensor(dev["gpt_l0_proj_B"])
        reqs = [eng.submit(p, max_new_tokens=8, adapter_id=a)
                for p, a in zip(prompts, ids)]
        eng.run()
        eng.shutdown()
        return [list(r.tokens) for r in reqs]

    base = run(1)
    assert run(2) == base
    assert base[1] != base[0] or base[2] != base[0]


def _churn(model, **kw):
    """tests/test_host_kv_offload.py's recipe: serve a prompt, churn its
    chain out of a tiny cache into the host tier, serve it again."""
    rng = np.random.RandomState(7)
    prompt = rng.randint(0, fx.VOCAB, (24,)).astype(np.int32)
    fills = [rng.randint(0, fx.VOCAB, (24,)).astype(np.int32)
             for _ in range(3)]
    eng = _port(model, num_blocks=16, host_kv_bytes=1 << 22, **kw)
    first = _serve(eng, [prompt], 8, shutdown=False)
    for f in fills:
        _serve(eng, [f], 8, shutdown=False)
    again = _serve(eng, [prompt], 8, shutdown=False)
    st = eng.stats()
    return eng, first, again, st


def test_offload_identity_tp2(gpt2):
    """Head-sharded blocks round-trip the host tier: the fetch gathers
    every shard's heads into one full host block, the restore scatters
    it back; the re-served prompt keeps its tokens."""
    eng, first, again, st = _churn(gpt2, tp=2)
    assert first == again
    assert st.host_kv_hits > 0 and st.host_kv_restored_tokens > 0
    eng.shutdown()
    one, f1, a1, _ = _churn(gpt2)
    assert f1 == first and a1 == again
    one.shutdown()


def test_host_block_round_trip_is_bit_exact(llama):
    """A fetched block equals the shards joined on the head axis, and
    a restore into another block writes every shard's bytes back."""
    eng = _port(llama, tp=2, host_kv_bytes=1 << 22, kv_dtype="int8")
    _serve(eng, fx.prompts(1), 4, shutdown=False)
    parts = eng._host_kv_fetch(1)
    assert parts[0].shape[2] == eng._cfg.kv_heads
    for got, bufs in zip(parts, (eng._cache_k, eng._cache_v, eng._scale_k,
                                 eng._scale_v)):
        assert torch.equal(got, torch.cat([b[:, 1] for b in bufs], dim=2))
    prog = eng._program("restore", 1)
    h = prog.stage()
    h["blks"][0] = 9
    for name, a in zip(("hk", "hv", "hks", "hvs"), parts):
        torch.as_tensor(h[name][:, 0]).copy_(a)
    prog()
    back = eng._host_kv_fetch(9)
    assert all(torch.equal(a, b) for a, b in zip(parts, back))
    eng.shutdown()
