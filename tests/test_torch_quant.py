"""The PyTorch port's quantized serving against the JAX reference:
weight-only int8 (``quantize="int8"``) and int8 K/V blocks
(``kv_dtype="int8"``) in ``mxnet_tpu_torch/serve/engine.py``.

The helpers are held bit for bit: ``quantize_weight`` against
``mxnet_tpu.contrib.quantization.quantize_weight`` and
``_kv_quant_vals``/``_kv_dequant`` against the reference engine's, on
seeded arrays with zero vectors and exact halves.  The engine's streams
equal the reference engine's, token for token, on the gpt2 and llama
fixtures (``torch_port_fixtures``) under each mode, and int8 K/V keeps
the reference's stability properties (``tests/test_quant_serve.py``):
preemption and resume, chunked against whole prefill, prefix-cache
shared blocks, and speculative decoding give the same tokens.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx
from torch_port_fixtures import \
    collect_engines_after_module  # noqa: F401  (autouse)

import mxnet_tpu as mx
from mxnet_tpu.contrib.quantization import quantize_weight as ref_qw
from mxnet_tpu.serve import engine as ref_engine_mod
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.serve import engine as port_engine

VOCAB = fx.VOCAB
ENGINE_KW = dict(block_size=4, num_blocks=80, max_batch=4, max_model_len=96)
MODES = {"weights": dict(quantize="int8"), "kv": dict(kv_dtype="int8"),
         "both": dict(quantize="int8", kv_dtype="int8")}


def _port(model, **kw):
    _, params, heads = model
    return mt.serve.Engine(params, num_heads=heads, device="cpu",
                           **{**ENGINE_KW, **kw})


def _ref(model, **kw):
    _, params, heads = model
    return mx.serve.Engine(params, num_heads=heads, **{**ENGINE_KW, **kw})


def _run(eng, prompts, max_new=12):
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run()
    assert all(r.status == "finished" for r in reqs)
    return [r.tokens for r in reqs]


@pytest.fixture(scope="module", params=["gpt2", "llama"])
def model(request):
    return fx.model(request.param)


@pytest.fixture(scope="module")
def llama():
    return fx.model("llama")


# -- the helpers, bit for bit --------------------------------------------------
def _seeded(shape, seed, zero_rows=(1,)):
    rng = np.random.RandomState(seed)
    a = (rng.randn(*shape) * 0.3).astype(np.float32)
    for r in zero_rows:
        a[r] = 0.0
    return a


@pytest.mark.parametrize("shape", [(8, 16), (5, 3, 4), (64, 32), (1, 7)])
def test_quantize_weight_bit_for_bit(shape):
    w = _seeded(shape, sum(shape), zero_rows=(0,) if shape[0] > 1 else ())
    want_q, want_s = ref_qw(w)
    got_q, got_s = port_engine.quantize_weight(torch.from_numpy(w))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert np.array_equal(got_q.numpy(), want_q)
    assert np.array_equal(got_s.numpy().view(np.uint32),
                          want_s.view(np.uint32))
    if shape[0] > 1:
        assert got_s[0] == 1.0 and not got_q[0].any()   # a zero channel


def _halves():
    """Rows whose quantized values land exactly on .5: amax 127 gives
    scale 1.0, so 2.5 and -0.5 must round to even (2 and -0)."""
    v = np.zeros((2, 3, 8), np.float32)
    v[0, 0, :4] = [127.0, 2.5, -0.5, 3.5]
    v[1, 2, :3] = [-127.0, 1.5, -2.5]
    return v


@pytest.mark.parametrize("case", ["seeded", "halves", "bf16_rows"])
def test_kv_quant_helpers_bit_for_bit(case):
    import jax.numpy as jnp

    if case == "halves":
        vals = _halves()
    else:
        vals = _seeded((6, 4, 3, 8), 3, zero_rows=(2,))
        vals[4, 1, 2] = 0.0                       # one zero head vector
    tv = torch.from_numpy(vals)
    jv = jnp.asarray(vals)
    if case == "bf16_rows":
        tv, jv = tv.to(torch.bfloat16), jv.astype(jnp.bfloat16)
    want_q, want_s = ref_engine_mod._kv_quant_vals(jv)
    got_q, got_s = port_engine._kv_quant_vals(tv)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert np.array_equal(got_q.numpy(), np.asarray(want_q))
    assert np.array_equal(got_s.numpy().view(np.uint32),
                          np.asarray(want_s).view(np.uint32))
    assert (got_s[got_s.new_tensor(np.abs(vals).max(-1) == 0,
                                   dtype=torch.bool)] == 1.0).all()
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(ref_engine_mod._kv_dequant(want_q, want_s, jdt)
                          .astype(jnp.float32))
        got = port_engine._kv_dequant(got_q, got_s, dt).float().numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    if case == "halves":
        assert got_q[0, 0, :4].tolist() == [127, 2, 0, 4]
        assert got_q[1, 2, :3].tolist() == [-127, 2, -2]


# -- token identity with the reference engine ----------------------------------
@pytest.mark.parametrize("mode", sorted(MODES))
def test_streams_equal_reference(model, mode):
    prompts = fx.prompts(4)
    want = _run(_ref(model, **MODES[mode]), prompts, max_new=16)
    got = _run(_port(model, **MODES[mode]), prompts, max_new=16)
    assert got == want


def test_quantized_params_and_cache_dtypes(llama):
    """Weights quantize after normalisation: every projection int8 with
    a float32 scale, the embeddings (the tied head) floating point; a
    bfloat16 engine casts what stays floating point and leaves the int8
    weights and scales alone."""
    eng = _port(llama, quantize="int8", kv_dtype="int8",
                dtype=torch.bfloat16)
    scales = [k for k in eng.params if k.endswith("_wscale")]
    assert len(scales) == 2 * 7       # 2 layers x (q,k,v,proj,gate,up,down)
    for k in scales:
        assert eng.params[k].dtype == torch.float32
        assert eng.params[k[:-len("_wscale")] + "_weight"].dtype == \
            torch.int8
    assert eng.params["gpt_tok_embed_weight"].dtype == torch.bfloat16
    assert eng.params["gpt_l0_q_bias"].dtype == torch.bfloat16
    assert eng._cache_k.dtype == torch.int8
    assert eng._scale_k.dtype == torch.float32
    assert eng._scale_k.shape == eng._cache_k.shape[:-1]
    ref = _ref(llama, quantize="int8")
    for k in scales:
        want = np.asarray(ref.params[k])
        assert np.array_equal(eng.params[k].numpy(), want), k
    assert _run(eng, fx.prompts(2), max_new=4)


def test_quant_env_defaults_and_validation(llama, monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_QUANT", "int8")
    monkeypatch.setenv("MXTPU_SERVE_KV_DTYPE", "int8")
    eng = _port(llama)
    assert eng.quantize == "int8" and eng._cache_k.dtype == torch.int8
    monkeypatch.setenv("MXTPU_SERVE_QUANT", "")
    monkeypatch.setenv("MXTPU_SERVE_KV_DTYPE", "")
    eng = _port(llama)
    assert eng.quantize is None and not eng._kv_quant
    with pytest.raises(ValueError, match="quantize"):
        _port(llama, quantize="fp8")
    with pytest.raises(ValueError, match="kv_dtype"):
        _port(llama, kv_dtype="int4")


# -- int8 K/V stability ----------------------------------------------------------
def test_kv_int8_preemption_resume_token_stable(llama):
    prompts = fx.prompts(2, seed=11, lo=18, hi=26)
    want = _run(_port(llama, kv_dtype="int8"), prompts, max_new=24)
    eng = _port(llama, kv_dtype="int8", num_blocks=18, max_batch=2)
    got = _run(eng, prompts, max_new=24)
    assert eng.scheduler.preemptions > 0, "no preemption — vacuous"
    assert got == want
    assert got == _run(_ref(llama, kv_dtype="int8", num_blocks=18,
                            max_batch=2), prompts, max_new=24)


def test_kv_int8_chunked_prefill_equals_whole(llama):
    long_p = np.random.RandomState(13).randint(0, VOCAB, (60,)).astype(
        np.int32)
    whole = _run(_port(llama, kv_dtype="int8", prefill_chunk=0,
                       prefix_cache=False), [long_p], max_new=16)
    eng = _port(llama, kv_dtype="int8", prefill_chunk=16,
                prefix_cache=False)
    chunked = _run(eng, [long_p], max_new=16)
    assert eng._programs[("chunk", 16)].calls > 0, "never chunked"
    assert chunked == whole


def test_kv_int8_prefix_cache_shared_blocks(llama):
    """A prefix-cache hit (the second prompt resurrects the first's
    parked int8 blocks, scales included) serves the cold path's
    tokens, as in the reference."""
    rng = np.random.RandomState(17)
    prefix = rng.randint(0, VOCAB, (40,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.randint(0, VOCAB, (6,))
                               .astype(np.int32)]) for _ in range(2)]
    cold = _port(llama, kv_dtype="int8", prefix_cache=False)
    want = [_run(cold, [p], max_new=12)[0] for p in prompts]
    eng = _port(llama, kv_dtype="int8", prefix_cache=True)
    got = [_run(eng, [p], max_new=12)[0] for p in prompts]
    assert eng.stats().prefix_hits > 0, "no prefix hit — vacuous"
    assert got == want
    ref = _ref(llama, kv_dtype="int8", prefix_cache=True)
    assert [_run(ref, [p], max_new=12)[0] for p in prompts] == got


def test_kv_int8_spec_decode_token_identity(llama):
    """The verify program quantizes and dequantizes through the same
    tables as plain decode: spec-on equals spec-off under int8 K/V, and
    the reference's spec engine."""
    _, params, _ = llama
    draft = {k: v for k, v in params.items() if not k.startswith("gpt_l1_")}
    spec = dict(kv_dtype="int8", spec_k=3, draft_params=draft,
                draft_num_heads=4, draft_window=0)
    prompts = fx.prompts(3, seed=19)
    plain = _run(_port(llama, kv_dtype="int8"), prompts, max_new=16)
    eng = _port(llama, **spec)
    got = _run(eng, prompts, max_new=16)
    assert eng.stats().spec_verifies > 0
    assert eng._spec.cache_k.dtype == torch.float32   # the draft stays fp
    assert got == plain
    assert got == _run(_ref(llama, **spec), prompts, max_new=16)


# -- inertness, agreement, bytes ---------------------------------------------------
def test_quant_off_is_inert(model):
    plain = _port(model)
    off = _port(model, quantize=None, kv_dtype=None)
    assert off._fingerprint() == plain._fingerprint()
    assert "kv_quant" not in off._fingerprint()["cfg"]
    assert "quantize" not in off._fingerprint()
    assert off._warmup_grid() == plain._warmup_grid()
    assert _run(off, fx.prompts(3)) == _run(plain, fx.prompts(3))


def test_quant_modes_key_the_fingerprint(llama):
    digests = {m: _port(llama, **kw)._spec_digest for m, kw in MODES.items()}
    digests["off"] = _port(llama)._spec_digest
    assert len(set(digests.values())) == 4
    fp = _port(llama, **MODES["both"])._fingerprint()
    assert fp["quantize"] == "int8" and fp["cfg"]["kv_quant"] is True
    assert fp["cache_dtype"] == "torch.int8"


def test_weight_only_agreement_with_fp(llama):
    """Weight-only int8 is lossy but close: the reference's floor of 0.7
    position agreement on this tiny near-tie model."""
    fp = _run(_port(llama), fx.prompts(4), max_new=16)
    q8 = _run(_port(llama, quantize="int8"), fx.prompts(4), max_new=16)
    total = sum(len(t) for t in fp)
    agree = sum(a == b for t1, t2 in zip(fp, q8) for a, b in zip(t1, t2))
    assert agree / total >= 0.7, (agree, total)


def test_kv_int8_bytes_drop(llama):
    fp, q8 = _port(llama), _port(llama, kv_dtype="int8")
    fp_bytes = 2 * fp._cache_k.nbytes
    q8_bytes = 2 * q8._cache_k.nbytes + 2 * q8._scale_k.nbytes
    assert q8._scale_k.nbytes == q8._scale_v.nbytes
    assert fp_bytes / q8_bytes >= 1.9, fp_bytes / q8_bytes
