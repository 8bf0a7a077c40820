"""GPT numerics of the PyTorch port against the JAX reference.

Same numpy inputs through ``mxnet_tpu.models.generate`` (and the
reference engine's ``_rope``) and their ports, on the CPU.  Elementwise
numerics agree to float32 rounding (stated per test); greedy decoding
agrees token for token on the seeded fixtures of ``torch_port_fixtures``.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.models import generate as ref_gen
from mxnet_tpu.serve import engine as ref_engine
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import generate as port_gen
from mxnet_tpu_torch.serve import engine as port_engine

# float32 elementwise ops in a different library: ulp-level differences
# (rsqrt/erf/cos/sin implementations), well inside 1e-6 at these scales
TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(a):
    return np.asarray(a, np.float32)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("rms", [False, True])
def test_ln_matches_reference(rms):
    x, g, b = _rand(5, 32), _rand(32, seed=1) + 1.0, _rand(32, seed=2)
    ref = ref_gen._ln(jnp.asarray(x), jnp.asarray(g),
                      None if rms else jnp.asarray(b))
    out = port_gen._ln(_t(x), _t(g), None if rms else _t(b))
    assert np.abs(_np(ref) - out.numpy()).max() < TOL


def test_fc_and_gelu_match_reference():
    x, w, b = _rand(5, 32), _rand(48, 32, seed=1), _rand(48, seed=2)
    ref = ref_gen._fc(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    out = port_gen._fc(_t(x), _t(w), _t(b))
    # a 32-term f32 dot product summed in another order
    assert np.abs(_np(ref) - out.numpy()).max() < 1e-5
    ref = ref_gen._gelu(jnp.asarray(x))
    assert np.abs(_np(ref) - port_gen._gelu(_t(x)).numpy()).max() < TOL


def test_rope_matches_reference():
    u = _rand(6, 4, 8)
    pos = np.array([0, 1, 5, 17, 63, 95], np.int32)
    ref = ref_engine._rope(jnp.asarray(u), jnp.asarray(pos))
    out = port_engine._rope(_t(u), _t(pos))
    # angles up to 95 rad: cos/sin of an f32 argument, |u| ~ 3
    assert np.abs(_np(ref) - out.numpy()).max() < 2e-5
    # the scalar-position decoder rotation equals the per-row one
    rot = port_gen._rot(_t(u), 17)
    per_row = port_engine._rope(_t(u), torch.full((6,), 17))
    assert torch.equal(rot, per_row)


def _quantized(params, stems):
    out = dict(params)
    for stem in stems:
        w = params[f"{stem}_weight"]
        sc = np.abs(w).max(axis=1) / 127.0
        out[f"{stem}_weight"] = np.round(w / sc[:, None]).astype(np.int8)
        out[f"{stem}_wscale"] = sc.astype(np.float32)
    return out


@pytest.mark.parametrize("variant", ["gpt2", "llama"])
def test_normalize_fused_qkv_and_wscale(variant):
    net = fx.ref_net(variant, fused_qkv=True)
    params = _quantized(fx.ref_params(net), ["gpt_l0_qkv", "gpt_l1_ff_up"])
    ref = ref_gen.normalize_gpt_params(params)
    port = port_gen.normalize_gpt_params(params)
    assert sorted(ref) == sorted(port)
    for k in ref:
        assert np.asarray(ref[k]).dtype == np.asarray(port[k]).dtype, k
        assert np.array_equal(np.asarray(ref[k]), np.asarray(port[k])), k
    # torch-tensor inputs normalize to the same values
    tport = port_gen.normalize_gpt_params({k: _t(v)
                                           for k, v in params.items()})
    for k in ref:
        assert np.array_equal(np.asarray(ref[k]), tport[k].numpy()), k
    assert (port_gen.detect_gpt_variant(port, 4)
            == ref_gen.detect_gpt_variant(ref, 4))
    unchanged = fx.ref_params(fx.ref_net(variant))
    assert port_gen.normalize_gpt_params(unchanged) is unchanged


@pytest.mark.parametrize("variant", ["gpt2", "llama"])
def test_detect_gpt_variant_matches_reference(variant):
    _, params, heads = fx.model(variant)
    assert (port_gen.detect_gpt_variant(params, heads)
            == ref_gen.detect_gpt_variant(params, heads))
    with pytest.raises(ValueError, match="num_heads must divide"):
        port_gen.detect_gpt_variant(params, 5)
    with pytest.raises(ValueError, match="wrong name prefix"):
        port_gen.normalize_gpt_params(params, name="other")


@pytest.mark.parametrize("variant,window", [("gpt2", 0), ("llama", 0),
                                            ("gpt2", 5), ("llama", 3)])
def test_gpt_generate_tokens_identical(variant, window):
    _, params, heads = fx.model(variant)
    prompt = np.stack([fx.prompts(1, seed=s, lo=9, hi=10)[0]
                       for s in (7, 8)])
    ref = ref_gen.gpt_generate(params, prompt, 20, num_heads=heads,
                               window=window)
    out = port_gen.gpt_generate(params, prompt, 20, num_heads=heads,
                                window=window, device="cpu")
    assert out.dtype == np.int32 and out.shape == ref.shape
    assert np.array_equal(out, ref)


def test_gpt_generate_serve_fixture():
    """The tests/test_serve.py oracle case: one prompt, 16 tokens."""
    net, params, heads = fx.model("gpt2")
    prompt = fx.prompts(1)[0]
    ref = mx.models.gpt_generate(params, prompt[None], max_new_tokens=16,
                                 symbol=net)
    out = mt.models.gpt_generate(params, prompt[None], 16, num_heads=heads,
                                 window=0, device="cpu")
    assert np.array_equal(out, ref)


def test_gpt_generate_contract_errors():
    _, params, heads = fx.model("gpt2")
    p = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="positional table"):
        port_gen.gpt_generate(params, p, fx.SEQ, num_heads=heads, window=0,
                              device="cpu")
    with pytest.raises(ValueError, match="batch, prompt_len"):
        port_gen.gpt_generate(params, p[0], 4, num_heads=heads,
                              device="cpu")
    out = port_gen.gpt_generate(params, p, 0, num_heads=heads, device="cpu")
    assert np.array_equal(out, p)


_FAMILIES = {
    "gpt2": dict(num_layers=3, d_model=48, num_heads=4),
    "llama": dict(num_layers=3, d_model=48, num_heads=6, kv_heads=2,
                  mlp="swiglu", norm="rmsnorm", pos_embed="rope",
                  tie_embeddings=True, d_ff=80),
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_gpt_params_names_shapes_and_values(family):
    from tools.decode_bench import make_params

    kw = _FAMILIES[family]
    net = mx.models.gpt(97, 24, **kw)
    arg_shapes, _, _ = net.infer_shape(data=(1, 24), softmax_label=(1, 24))
    ref_args = [(n, tuple(s)) for n, s in zip(net.list_arguments(),
                                              arg_shapes)
                if n not in ("data", "softmax_label")]
    assert mt.models.gpt_arguments(97, 24, **kw) == ref_args
    ref = make_params(net, 1, 24, np.float32, seed=5)
    port = mt.models.gpt_params(97, 24, seed=5, **kw)
    assert list(port) == list(ref)
    for k in ref:
        assert port[k].dtype == ref[k].dtype
        assert np.array_equal(port[k], ref[k]), k


def test_params_from_numpy_carries_bfloat16():
    """A reference bf16 checkpoint (ml_dtypes numpy) and a float32 one
    cast on the way both land as identical torch bf16 tensors."""
    _, params, _ = fx.model("llama")
    bf = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
          for k, v in params.items()}
    a = mt.params_from_numpy(bf, "cpu")
    b = mt.params_from_numpy(params, "cpu", dtype=torch.bfloat16)
    for k in params:
        assert a[k].dtype == torch.bfloat16
        assert torch.equal(a[k], b[k]), k
        np.testing.assert_array_equal(a[k].float().numpy(),
                                      bf[k].astype(np.float32))
