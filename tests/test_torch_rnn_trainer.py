"""RNN-op language-model training through the port's ShardedTrainer
against the JAX reference's, on the CPU, and the unrolled LSTM LM.

The LM of ``examples/rnn_time_major.py`` (Embedding -> RNN -> Reshape ->
FullyConnected -> SoftmaxOutput, time-major (T, N) ids) with 2 LSTM or
GRU layers, V 12, T 8, N 4, H 16, ``rescale_grad = 1/N``.  Both trainers
start from the reference trainer's Xavier parameters (``set_params``)
and take 3 steps on one batch.  SGD (lr 0.1, momentum 0.9): head outputs
held at 5e-6 after every step and parameters at 1e-5 after the last,
the same float32 arithmetic summed in other orders.  Adam (lr 0.01):
the first step's outputs at 5e-6 and the later ones' at 1e-4, and
parameters at 2e-5 + 3 lr min(2, 1e-5 max|g| / |g_i|) element by
element, as ``test_torch_trainer_adam.py`` derives: Adam divides by
sqrt(v), so float32 gradient noise of relative size 1e-5 moves an
element by about lr 1e-5 max|g| / |g_i| per step.  The forced-kernel
variant (``MXNET_TPU_FUSED_RNN=1``) runs the reference's Pallas kernels
in interpret mode against the port's plain kernel versions.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx

OUT_TOL, LATER_OUT_TOL, SGD_PARAM_TOL = 5e-6, 1e-4, 1e-5
ADAM_PARAM_TOL, GRAD_NOISE = 2e-5, 1e-5


def _steps(mode, optimizer):
    ref, port = fx.rnn_train_pair(mode, optimizer)
    batch = fx.rnn_batch()
    assert list(port.get_params()) == list(ref.get_params())
    grads, _ = port._grads_of(port._place_batch(batch))
    for step in range(3):
        want = np.asarray(ref.step(batch)[0])
        got = port.step(batch)[0].numpy()
        tol = OUT_TOL if optimizer == "sgd" or step == 0 else LATER_OUT_TOL
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    want, got = ref.get_params(), port.get_params()
    lr = fx.RNN_OPTS[optimizer]["learning_rate"]
    for k in want:
        if optimizer == "sgd":
            np.testing.assert_allclose(got[k], want[k], rtol=SGD_PARAM_TOL,
                                       atol=SGD_PARAM_TOL, err_msg=k)
            continue
        g = grads[k].abs().numpy()
        allowed = ADAM_PARAM_TOL + 3 * lr * np.minimum(
            2.0, GRAD_NOISE * float(g.max()) / np.maximum(g, 1e-30))
        err = np.abs(got[k] - want[k])
        assert np.all(err <= allowed), (k, float((err / allowed).max()))


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_three_steps_match_reference(mode, optimizer, monkeypatch):
    monkeypatch.delenv("MXNET_TPU_FUSED_RNN", raising=False)
    _steps(mode, optimizer)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_three_steps_match_reference_through_the_kernel_path(mode,
                                                             monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FUSED_RNN", "1")
    _steps(mode, "adam")


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_lm_parameters_carry_reference_names_shapes_and_order(mode):
    net = fx.ref_rnn_lm(mode)
    shape = (fx.RNN_SEQ, fx.RNN_BATCH)
    arg_shapes, _, _ = net.infer_shape(data=shape, softmax_label=shape)
    want = [(n, tuple(s)) for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")]
    module = fx.port_rnn_lm(mode)
    assert [(n, tuple(p.shape)) for n, p in module.named_parameters()] == want


def test_lstm_unroll_matches_reference_symbol():
    """lstm_unroll's argument names, shapes and order, and its forward
    (gate order i, g, f, o) against the reference Symbol's."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt

    L, S, V, Hd, E, NL, B = 2, 5, 11, 8, 6, 11, 3
    ref = mx.models.lstm.lstm_unroll(L, S, V, Hd, E, NL)
    state_shapes = {f"l{i}_init_{k}": (B, Hd) for i in range(L)
                    for k in "ch"}
    arg_shapes, _, _ = ref.infer_shape(data=(B, S), softmax_label=(B, S),
                                       **state_shapes)
    want = list(zip(ref.list_arguments(), map(tuple, arg_shapes)))
    port = mt.models.lstm_unroll(L, S, V, Hd, E, NL)
    assert port.arguments(B) == want
    assert [(n, tuple(p.shape)) for n, p in port.named_parameters()] == [
        a for a in want if a[0] not in state_shapes
        and a[0] not in ("data", "softmax_label")]

    rng = np.random.RandomState(5)
    values = {n: (rng.randn(*s) * 0.4).astype(np.float32) for n, s in want}
    values["data"] = rng.randint(0, V, (B, S)).astype(np.float32)
    values["softmax_label"] = rng.randint(0, NL, (B, S)).astype(np.float32)
    exe = ref.simple_bind(mx.cpu(), grad_req="null", data=(B, S),
                          softmax_label=(B, S), **state_shapes)
    for name, arr in exe.arg_dict.items():
        arr[:] = values[name]
    ref_out = exe.forward(is_train=False)[0].asnumpy()
    port.to_empty(device="cpu")
    with torch.no_grad():
        for name, p in port.named_parameters():
            p.copy_(torch.from_numpy(values[name]))
        got = port(torch.from_numpy(values["data"]).long(),
                   torch.from_numpy(values["softmax_label"]),
                   **{k: torch.from_numpy(values[k]) for k in state_shapes})
    np.testing.assert_allclose(got.numpy(), ref_out, rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        mt.models.lstm_unroll(L, S, V, Hd, E, NL, dropout=0.2)
