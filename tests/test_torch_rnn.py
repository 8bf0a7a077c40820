"""The port's ``RNN`` op against the JAX reference's, on the CPU.

The reference op runs through ``simple_bind`` (the pattern of
``tests/test_rnn.py`` and ``tests/test_pallas_lstm.py``); the port's
``ops.RNN`` takes the same numpy inputs: all four modes, bidirectional,
two layers and ``state_outputs``, forward outputs and the gradients of
data, parameters and initial states under random head gradients.  By
default both run their eager scans; with ``MXNET_TPU_FUSED_RNN=1`` both
route LSTM and GRU layers through the kernel path (the reference's
Pallas kernels in interpret mode, the port's plain kernel versions).
float32 throughout, held at 1e-5 (outputs) and 2e-5 (gradients): the
same float32 math summed in other orders.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

from mxnet_tpu_torch import ops
from mxnet_tpu_torch.ops import fused_gru, fused_lstm
from mxnet_tpu_torch.ops import rnn as port_rnn

OUT_TOL, GRAD_TOL = 1e-5, 2e-5
T, N, I, H = 5, 3, 6, 7

CASES = {
    "uni1": dict(num_layers=1, bidirectional=False, state_outputs=False),
    "bi2_states": dict(num_layers=2, bidirectional=True, state_outputs=True),
    "uni2_states": dict(num_layers=2, bidirectional=False,
                        state_outputs=True),
}


def _arrays(mode, case, seed=0):
    """Inputs by the reference's argument names, and head gradients."""
    rng = np.random.RandomState(seed)
    cfg = CASES[case]
    args, outs = port_rnn.rnn_infer_shape((T, N, I), H, cfg["num_layers"],
                                          mode, cfg["bidirectional"],
                                          cfg["state_outputs"])
    names = ["data", "rnn_parameters", "rnn_state", "rnn_state_cell"]
    arrays = {n: (rng.randn(*s) * (0.5 if n == "data" else 0.3))
              .astype(np.float32) for n, s in zip(names, args)}
    heads = [rng.randn(*s).astype(np.float32) for s in outs]
    return arrays, heads


def _reference(mode, case, arrays, heads):
    import mxnet_tpu as mx

    cfg = CASES[case]
    extra = ([mx.sym.Variable("rnn_state_cell")] if mode == "lstm" else [])
    net = mx.sym.RNN(mx.sym.Variable("data"),
                     mx.sym.Variable("rnn_parameters"),
                     mx.sym.Variable("rnn_state"), *extra, state_size=H,
                     mode=mode, name="rnn", **cfg)
    exe = net.simple_bind(mx.cpu(), grad_req="write", data=(T, N, I))
    for name, arr in exe.arg_dict.items():
        arr[:] = arrays[name]
    exe.forward(is_train=True)
    outs = [o.asnumpy() for o in exe.outputs]
    exe.backward([mx.nd.array(h) for h in heads])
    return outs, {k: v.asnumpy() for k, v in exe.grad_dict.items()}


def _port(mode, case, arrays, heads):
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in arrays.items()}
    out = ops.RNN(t["data"], t["rnn_parameters"], t["rnn_state"],
                  t.get("rnn_state_cell"), state_size=H, mode=mode,
                  **CASES[case])
    outs = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(outs, [torch.from_numpy(h) for h in heads])
    return ([o.detach().numpy() for o in outs],
            {k: v.grad.numpy() for k, v in t.items()})


def _compare(mode, case, seed=0):
    arrays, heads = _arrays(mode, case, seed)
    r_out, r_grad = _reference(mode, case, arrays, heads)
    p_out, p_grad = _port(mode, case, arrays, heads)
    assert len(p_out) == len(r_out)
    for a, b in zip(p_out, r_out):
        np.testing.assert_allclose(a, b, rtol=OUT_TOL, atol=OUT_TOL)
    assert sorted(p_grad) == sorted(r_grad)
    for k in r_grad:
        np.testing.assert_allclose(p_grad[k], r_grad[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", ["rnn_relu", "rnn_tanh", "lstm", "gru"])
def test_op_matches_reference(mode, case, monkeypatch):
    monkeypatch.delenv("MXNET_TPU_FUSED_RNN", raising=False)
    _compare(mode, case)


@pytest.mark.parametrize("case", ["uni1", "bi2_states"])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_op_matches_reference_through_the_kernel_path(mode, case,
                                                      monkeypatch):
    """MXNET_TPU_FUSED_RNN=1: the reference's Pallas kernels (interpret)
    against the port's plain kernel versions, which must be the path
    taken (including the reverse direction's flips)."""
    monkeypatch.setenv("MXNET_TPU_FUSED_RNN", "1")
    mod = fused_lstm if mode == "lstm" else fused_gru
    name = f"fused_{mode}_fwd_torch"
    real, calls = getattr(mod, name), []
    monkeypatch.setattr(mod, name,
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _compare(mode, case, seed=1)
    layers = CASES[case]["num_layers"] * (2 if CASES[case]["bidirectional"]
                                          else 1)
    assert len(calls) == layers


def test_cpu_scan_unless_forced(monkeypatch):
    """Without the knob, CPU tensors take the scan (the reference runs
    its kernels off the TPU only when forced)."""
    monkeypatch.delenv("MXNET_TPU_FUSED_RNN", raising=False)
    calls = []
    real = fused_lstm.fused_lstm_fwd_torch
    monkeypatch.setattr(fused_lstm, "fused_lstm_fwd_torch",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    arrays, _ = _arrays("lstm", "uni1")
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    big = torch.zeros(16, N, I)                     # T >= 8
    ops.RNN(big, t["rnn_parameters"], t["rnn_state"], t["rnn_state_cell"],
            state_size=H, num_layers=1, mode="lstm")
    assert calls == []


def test_weight_layout_matches_reference():
    """_weight_size and _slice_params give the reference's blocks, so a
    ``*_parameters`` vector moves between the packages unchanged."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import rnn as ref_rnn

    for mode in ("rnn_tanh", "lstm", "gru"):
        for L, bidir in ((1, False), (3, True)):
            rp = ref_rnn.RNNParam(state_size=H, num_layers=L, mode=mode,
                                  bidirectional=bidir)
            pp = port_rnn.RNNParam(H, L, mode, bidir)
            size = ref_rnn._weight_size(rp, I)
            assert port_rnn._weight_size(pp, I) == size
            flat = np.arange(size, dtype=np.float32)
            want = ref_rnn._slice_params(rp, I, jnp.asarray(flat))
            got = port_rnn._slice_params(pp, I, torch.from_numpy(flat))
            for wl, gl in zip(want, got):
                for wd, gd in zip(wl, gl):
                    for w, g in zip(wd, gd):
                        np.testing.assert_array_equal(g.numpy(),
                                                      np.asarray(w))


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_relu"])
def test_infer_shape_matches_reference(mode):
    import mxnet_tpu as mx

    net = mx.sym.RNN(mx.sym.Variable("data"), state_size=H, num_layers=2,
                     mode=mode, bidirectional=True, state_outputs=True,
                     name="rnn")
    arg_shapes, out_shapes, _ = net.infer_shape(data=(T, N, I))
    args, outs = port_rnn.rnn_infer_shape((T, N, I), H, 2, mode, True, True)
    assert [tuple(s) for s in arg_shapes] == args
    assert [tuple(s) for s in out_shapes] == outs


def test_dropout_when_training_raises_and_arguments_are_checked():
    arrays, _ = _arrays("gru", "uni2_states")
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    kw = dict(state_size=H, num_layers=2, mode="gru", p=0.5)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ops.RNN(t["data"], t["rnn_parameters"], t["rnn_state"], **kw)
    # outside training p has no effect, as in the reference
    with torch.no_grad():
        out = ops.RNN(t["data"], t["rnn_parameters"], t["rnn_state"], **kw)
        ref = ops.RNN(t["data"], t["rnn_parameters"], t["rnn_state"],
                      state_size=H, num_layers=2, mode="gru")
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="mode must be"):
        ops.RNN(t["data"], t["rnn_parameters"], t["rnn_state"],
                state_size=H, num_layers=2, mode="rnn")
    with pytest.raises(ValueError, match="parameters hold"):
        ops.RNN(t["data"], t["rnn_parameters"][1:], t["rnn_state"],
                state_size=H, num_layers=2, mode="gru")
    with pytest.raises(ValueError, match="needs state_cell"):
        ops.RNN(t["data"], t["rnn_parameters"], t["rnn_state"],
                state_size=H, num_layers=2, mode="lstm")
