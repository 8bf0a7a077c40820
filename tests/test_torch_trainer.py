"""GPT training through the port's ShardedTrainer against the JAX
reference's, on the CPU.

A tiny ``gpt`` (2 layers, d_model 32, 4 heads, S 16, B 4) in six variants
(GPT-2 style; llama style with rope, 2 kv heads, SwiGLU, RMSNorm and a
tied head; ``fused_qkv``; ``loss="ce"``; a sliding window in the ``bshd``
layout; the reference at ``attn_impl="flash"``, its Pallas kernels in
interpret mode, against the port's plain flash versions).  Both trainers
start from the same parameters (the reference trainer's, through
``set_params``) and take 3 SGD steps (lr 0.1, momentum 0.9) on one
batch.  Head outputs are held at 5e-6 after every step and parameters
at 1e-5 after the last: the same float32 arithmetic summed in other
orders (and, on a multi-threaded CPU, in an order that varies from run
to run), ~1e-6 on gradients of order 1, carried by 0.1 + 0.19 + 0.271
of lr-weighted momentum sums.  The Adam steps are in
``test_torch_trainer_adam.py``.
"""

import numpy as np
import pytest

import torch_port_fixtures as fx

OUT_TOL, SGD_PARAM_TOL = 5e-6, 1e-5


@pytest.fixture(autouse=True)
def _pinned_threads():
    with fx.pinned_threads():
        yield


@pytest.mark.parametrize("variant", sorted(fx.TRAIN_VARIANTS))
def test_three_sgd_steps_match_reference(variant):
    ref, port = fx.train_pair(variant, "sgd")
    batch = fx.train_batch()
    assert sorted(port.get_params()) == sorted(ref.get_params())
    for _ in range(3):
        want = np.asarray(ref.step(batch)[0])
        got = port.step(batch)[0].numpy()
        np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=OUT_TOL)
    want, got = ref.get_params(), port.get_params()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=SGD_PARAM_TOL,
                                   atol=SGD_PARAM_TOL, err_msg=k)


def test_eval_and_param_round_trip():
    ref, port = fx.train_pair("gpt2", "sgd")
    batch = fx.train_batch(1)
    np.testing.assert_allclose(port.eval(batch)[0].numpy(),
                               np.asarray(ref.eval(batch)[0]),
                               rtol=OUT_TOL, atol=OUT_TOL)
    params = port.get_params()
    port.set_params({k: v + 1 for k, v in params.items()})
    assert all(np.array_equal(port.get_params()[k], v + 1)
               for k, v in params.items())


@pytest.mark.parametrize("variant", sorted(fx.TRAIN_VARIANTS))
def test_parameters_carry_reference_names_shapes_and_order(variant):
    """The GPT module's parameters (and gpt_arguments, fused_qkv
    included) are the reference Symbol's arguments, in its order."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt

    extra = {**fx.TRAIN_BASE, **fx.TRAIN_VARIANTS[variant]}
    net = mx.models.gpt(fx.VOCAB, fx.TRAIN_SEQ, **extra)
    shape = (fx.TRAIN_BATCH, fx.TRAIN_SEQ)
    arg_shapes, _, _ = net.infer_shape(data=shape, softmax_label=shape)
    want = [(n, tuple(s)) for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")]
    arch = {k: v for k, v in extra.items()
            if k not in ("loss", "attn_window", "attn_layout", "attn_impl")}
    assert mt.models.gpt_arguments(fx.VOCAB, fx.TRAIN_SEQ, **arch) == want
    module = mt.models.gpt(fx.VOCAB, fx.TRAIN_SEQ, **extra)
    got = [(n, tuple(p.shape)) for n, p in module.named_parameters()]
    assert got == list(dict(want).items())
