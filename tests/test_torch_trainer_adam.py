"""Adam steps of the port's ShardedTrainer against the JAX reference's,
and the train -> serve loop inside the port.

The six tiny-``gpt`` variants of ``test_torch_trainer.py`` take 3 Adam
steps (lr 3e-3) on one batch from the same parameters.  The first
step's head outputs are held at 5e-6 and the later steps' at 1e-4:
Adam's first step moves every element by about lr whatever its
gradient's size, so an element whose gradient sits within float32 noise
of zero can step the other way in the other framework (2 lr = 6e-3),
which reaches the outputs at the 1e-5 level.  Parameters are held
element by element at

    2e-5 + 3 lr min(2, 1e-5 max|g| / |g_i|)

with g the port's first-step gradient of that parameter tensor: Adam
divides by sqrt(v), so gradient noise of relative size 1e-5 (the two
frameworks' float32 sums in other orders) moves an element by about
lr 1e-5 max|g| / |g_i| per step, up to a flipped sign where |g_i| is at
rounding level.  The key biases (``*_k_bias`` and the key rows of
``*_qkv_bias``) of the variants without rope are that case, logged in
ROADMAP §C: their exact gradient is zero (a key bias adds the same q.b
to every score of a softmax row), so both frameworks step on
rounding-level noise of either sign, each up to lr per step: the test
asserts that their gradient is at rounding level and holds them at
2e-5 + 6 lr.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx

OUT_TOL, LATER_OUT_TOL, ADAM_PARAM_TOL, GRAD_NOISE = (5e-6, 1e-4,
                                                      2e-5, 1e-5)
ROUNDING_LEVEL = 1e-6      # |grad| of an exactly-zero gradient in f32


@pytest.fixture(autouse=True)
def _pinned_threads():
    with fx.pinned_threads():
        yield


def _zero_grad_rows(name, variant):
    """Rows of ``name`` whose exact gradient is zero (key biases without
    rope), or None."""
    if variant == "llama":      # rope rotates the bias: a real gradient
        return None
    if name.endswith("_k_bias"):
        return slice(None)
    if name.endswith("_qkv_bias"):
        d = fx.TRAIN_BASE["d_model"]
        return slice(d, 2 * d)
    return None


@pytest.mark.parametrize("variant", sorted(fx.TRAIN_VARIANTS))
def test_three_adam_steps_match_reference(variant):
    ref, port = fx.train_pair(variant, "adam")
    batch = fx.train_batch()
    grads, _ = port._grads_of(port._place_batch(batch))
    for step in range(3):
        want = np.asarray(ref.step(batch)[0])
        got = port.step(batch)[0].numpy()
        tol = OUT_TOL if step == 0 else LATER_OUT_TOL
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    want, got = ref.get_params(), port.get_params()
    lr = fx.TRAIN_OPTS["adam"]["learning_rate"]
    for k in want:
        g = grads[k].abs().numpy()
        noise = GRAD_NOISE * float(g.max())
        allowed = ADAM_PARAM_TOL + 3 * lr * np.minimum(
            2.0, noise / np.maximum(g, 1e-30))
        rows = _zero_grad_rows(k, variant)
        if rows is not None:
            # all noise: each framework steps up to lr per step either way
            assert float(g[rows].max()) <= ROUNDING_LEVEL, k
            allowed[rows] = ADAM_PARAM_TOL + 6 * lr
        err = np.abs(got[k] - want[k])
        assert np.all(err <= allowed), (k, float((err / allowed).max()))


def test_trained_fused_qkv_checkpoint_serves_like_reference():
    """Train -> serve: the tiny fused_qkv model trains 3 SGD steps in
    each framework; the port's get_params() goes through
    params_from_numpy (which splits the fused projection) into the
    port's greedy decoder, whose tokens equal the reference decoder's on
    the reference trainer's parameters."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt

    ref, port = fx.train_pair("fused_qkv", "sgd")
    batch = fx.train_batch(2)
    for _ in range(3):
        ref.step(batch)
        port.step(batch)
    heads = fx.TRAIN_BASE["num_heads"]
    prompt = batch["data"][:2, :6]
    want = np.asarray(mx.models.gpt_generate(ref.get_params(), prompt, 8,
                                             num_heads=heads, window=0))
    params = mt.params_from_numpy(port.get_params(), device="cpu")
    assert "gpt_l0_q_weight" in params and "gpt_l0_qkv_weight" not in params
    got = mt.models.gpt_generate(params, prompt, 8, num_heads=heads,
                                 window=0, device="cpu")
    np.testing.assert_array_equal(np.asarray(got), want)


def test_unported_arguments_raise():
    import mxnet_tpu_torch as mt

    net = lambda **kw: mt.models.gpt(fx.VOCAB, 8, num_layers=1, d_model=8,
                                     num_heads=2, **kw)
    shapes = {"data": (2, 8), "softmax_label": (2, 8)}
    for kw in ({"mesh": {"dp": 2}}, {"param_specs": {"x": None}},
               {"sequence_specs": {"data": None}}, {"fsdp": True},
               {"shard_optimizer_state": True}, {"grad_accum_steps": 2}):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            mt.parallel.ShardedTrainer(net(), shapes, device="cpu", **kw)
    for kw in ({"dropout": 0.1}, {"remat": True}):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            net(**kw)
    tr = mt.parallel.ShardedTrainer(net(), shapes, device="cpu",
                                    mesh={"dp": 1})
    assert tr._rescale_grad == 0.5 and tr.params["gpt_head_weight"].dtype \
        == torch.float32


def test_bf16_trainer_keeps_ids_int_and_labels_float():
    import mxnet_tpu_torch as mt

    tr = mt.parallel.ShardedTrainer(
        mt.models.gpt(fx.VOCAB, 8, num_layers=1, d_model=8, num_heads=2),
        {"data": (2, 8), "softmax_label": (2, 8)}, dtype="bfloat16",
        input_dtypes={"data": np.int32}, device="cpu")
    placed = tr._place_batch(fx.train_batch())
    assert placed["data"].dtype == torch.int32
    assert placed["softmax_label"].dtype == torch.float32
    assert all(p.dtype == torch.bfloat16 for p in tr.params.values())
    out = tr.step({k: v[:2, :8] for k, v in fx.train_batch().items()})[0]
    assert out.dtype == torch.bfloat16 and out.shape == (16, fx.VOCAB)
    params = tr.get_params()
    assert params["gpt_head_weight"].dtype == np.float32
