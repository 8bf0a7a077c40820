"""The port's sequence Symbol ops against the JAX reference's, on the CPU.

Each graph is bound by ``simple_bind`` in both packages and fed the same
numpy inputs; forward outputs and the gradients of every floating input
(under seeded head gradients; loss ops ignore them) are compared:

- ``RNN`` in the four modes, one layer, and two bidirectional layers
  with ``state_outputs``: argument and output lists, inferred shapes,
  JSON, outputs and gradients, by the default scan in both packages and,
  for one bidirectional LSTM and GRU layer, with
  ``MXNET_TPU_FUSED_RNN=1`` (the reference's Pallas kernels in interpret
  mode, the port's plain kernel versions);
- ``SequenceLast``, ``SequenceMask`` (with ``value``) and
  ``SequenceReverse``, with and without ``use_sequence_length``;
- ``CTCLoss`` with the blank first and last, padded labels, repeated
  labels, label lengths and data lengths, through each of its names.

float32 throughout: outputs within 1e-5 and gradients within 2e-5 of
each one's largest magnitude (the same float32 math summed in other
orders, as ``tests/test_torch_rnn.py`` states); the Sequence ops, which
only move values, bit for bit.
"""

import numpy as np
import pytest

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

OUT_TOL, GRAD_TOL = 1e-5, 2e-5
T, N, I, H = 5, 3, 6, 7


def _run(M, net, arrays, heads=None, grads=()):
    """Outputs and the gradients of ``grads`` of ``net`` bound on the
    CPU with ``arrays``: a training forward, then a backward with
    ``heads`` (none for a loss)."""
    ctx = M.cpu()
    with ctx:
        exe = net.simple_bind(
            ctx, grad_req={n: "write" if n in grads else "null"
                           for n in net.list_arguments()},
            **{k: v.shape for k, v in arrays.items()})
        for k, v in arrays.items():
            exe.arg_dict[k][:] = v
        outs = [o.asnumpy() for o in exe.forward(is_train=True)]
        exe.backward([M.nd.array(h) for h in heads] if heads else None)
    return outs, {n: exe.grad_dict[n].asnumpy() for n in grads}


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * scale


def _pair(build, arrays, heads=None, grads=(), exact=False):
    """``build(M)`` in both packages under fresh NameManagers: the same
    arguments, JSON, outputs and gradients."""
    nets = {}
    for M in (mx, mt):
        with M.sym.NameManager():
            nets[M] = build(M)
    assert nets[mt].list_arguments() == nets[mx].list_arguments()
    assert nets[mt].list_outputs() == nets[mx].list_outputs()
    assert nets[mt].tojson() == nets[mx].tojson()
    ref = _run(mx, nets[mx], arrays, heads, grads)
    got = _run(mt, nets[mt], arrays, heads, grads)
    pairs = [(g, w, OUT_TOL) for g, w in zip(got[0], ref[0])]
    pairs += [(got[1][n], ref[1][n], GRAD_TOL) for n in grads]
    for g, w, tol in pairs:
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            _close(g, w, tol)
    return nets[mt]


# -- RNN --------------------------------------------------------------------
RNN_CASES = {
    "uni1": dict(num_layers=1, bidirectional=False, state_outputs=False),
    "bi1_states": dict(num_layers=1, bidirectional=True, state_outputs=True),
    "bi2_states": dict(num_layers=2, bidirectional=True, state_outputs=True),
}


def _rnn_case(mode, case, seed=0):
    from mxnet_tpu_torch.ops.rnn import rnn_infer_shape

    cfg = RNN_CASES[case]
    args, outs = rnn_infer_shape((T, N, I), H, cfg["num_layers"], mode,
                                 cfg["bidirectional"], cfg["state_outputs"])
    names = ["data", "rnn_parameters", "rnn_state", "rnn_state_cell"]
    rng = np.random.RandomState(seed)
    arrays = {n: (rng.randn(*s) * (0.5 if n == "data" else 0.3))
              .astype(np.float32) for n, s in zip(names, args)}
    heads = [rng.randn(*s).astype(np.float32) for s in outs]
    return arrays, heads


def _rnn_build(mode, case):
    def build(M):
        return M.sym.RNN(M.sym.Variable("data"), state_size=H, mode=mode,
                         name="rnn", **RNN_CASES[case])
    return build


@pytest.mark.parametrize("mode,case", [
    ("rnn_relu", "uni1"), ("rnn_tanh", "bi2_states"), ("lstm", "uni1"),
    ("lstm", "bi2_states"), ("gru", "bi2_states")])
def test_rnn_symbol_op_matches_reference(mode, case, monkeypatch):
    monkeypatch.delenv("MXNET_TPU_FUSED_RNN", raising=False)
    arrays, heads = _rnn_case(mode, case)
    net = _pair(_rnn_build(mode, case), arrays, heads, grads=tuple(arrays))
    _, out_shapes, _ = net.infer_shape(data=(T, N, I))
    assert [tuple(s) for s in out_shapes] == [h.shape for h in heads]


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_symbol_op_kernel_path_matches_reference(mode, monkeypatch):
    """MXNET_TPU_FUSED_RNN=1: the reference's Pallas kernels (interpret)
    against the port's plain kernel versions, which must be the path
    taken (the scan's step is never made)."""
    from mxnet_tpu_torch.ops import rnn as port_rnn

    monkeypatch.setenv("MXNET_TPU_FUSED_RNN", "1")

    def no_scan(mode, H):
        raise AssertionError("the eager scan ran on the kernel path")

    monkeypatch.setattr(port_rnn, "_cell_step", no_scan)
    arrays, heads = _rnn_case(mode, "bi1_states", seed=1)
    _pair(_rnn_build(mode, "bi1_states"), arrays, heads,
          grads=tuple(arrays))


def test_rnn_symbol_op_dropout_and_registration():
    """``p > 0`` raises only in a training forward of more than one
    layer, naming §A16; the op's names reach ``nd`` and ``sym``."""
    arrays, _ = _rnn_case("lstm", "bi2_states")
    net = mt.sym.RNN(mt.sym.Variable("data"), state_size=H, mode="lstm",
                     name="rnn", p=0.5, **RNN_CASES["bi2_states"])
    with mt.cpu():
        exe = net.simple_bind(mt.cpu(), grad_req="null", data=(T, N, I))
        for k, v in arrays.items():
            exe.arg_dict[k][:] = v
        exe.forward(is_train=False)
        with pytest.raises(NotImplementedError, match="A16"):
            exe.forward(is_train=True)
    for name in ("RNN", "SequenceLast", "SequenceMask", "SequenceReverse",
                 "CTCLoss", "ctc_loss"):
        assert callable(getattr(mt.nd, name))
        assert callable(getattr(mt.sym, name))


# -- Sequence ops -----------------------------------------------------------
SEQ_OPS = {"SequenceLast": {}, "SequenceMask": {"value": -1.5},
           "SequenceReverse": {}}


@pytest.mark.parametrize("use_len", [False, True])
@pytest.mark.parametrize("op", sorted(SEQ_OPS))
def test_sequence_op_matches_reference(op, use_len):
    rng = np.random.RandomState(2)
    arrays = {"data": rng.randn(T, N, 2, 3).astype(np.float32)}
    if use_len:
        arrays["sequence_length"] = np.array([T, 1, 3], np.float32)
    x_shape = arrays["data"].shape
    out_shape = x_shape[1:] if op == "SequenceLast" else x_shape
    heads = [rng.randn(*out_shape).astype(np.float32)]

    def build(M):
        args = [M.sym.Variable("data")]
        if use_len:
            args.append(M.sym.Variable("sequence_length"))
        return getattr(M.sym, op)(*args, use_sequence_length=use_len,
                                  name="seq", **SEQ_OPS[op])

    _pair(build, arrays, heads, grads=("data",), exact=True)


# -- CTCLoss ----------------------------------------------------------------
CTC_T, CTC_N, CTC_C, CTC_L = 12, 5, 6, 4


def _ctc_arrays(case, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(CTC_T, CTC_N, CTC_C).astype(np.float32)
    if case["blank_label"] == "first":
        lab = rng.randint(1, CTC_C, (CTC_N, CTC_L)).astype(np.float32)
    else:
        lab = rng.randint(0, CTC_C - 1, (CTC_N, CTC_L)).astype(np.float32)
    lab[0, 1] = lab[0, 0]                        # a repeated label
    arrays = {"data": x, "label": lab}
    if case.get("pad"):
        lab[1, 2:] = -1                          # padded tails
        lab[3, 3:] = -1
    if case.get("use_data_lengths"):
        arrays["data_lengths"] = np.array([12, 9, 7, 12, 10], np.float32)
    if case.get("use_label_lengths"):
        arrays["label_lengths"] = np.array([4, 2, 3, 1, 4], np.float32)
    return arrays


CTC_CASES = {
    "first_padded": dict(blank_label="first", pad=True),
    "last": dict(blank_label="last"),
    "first_lengths": dict(blank_label="first", use_label_lengths=True,
                          use_data_lengths=True),
    "last_label_lengths": dict(blank_label="last", use_label_lengths=True),
}


@pytest.mark.parametrize("case,name", [
    ("first_padded", "CTCLoss"), ("last", "ctc_loss"),
    ("first_lengths", "warpctc"), ("last_label_lengths", "_contrib_ctcloss")])
def test_ctc_loss_matches_reference(case, name):
    kw = {k: v for k, v in CTC_CASES[case].items() if k != "pad"}
    arrays = _ctc_arrays(CTC_CASES[case])

    def build(M):
        return getattr(M.sym, name)(*[M.sym.Variable(n) for n in arrays],
                                    name="ctc", **kw)

    net = _pair(build, arrays, grads=("data",))
    loss, _ = _run(mt, net, arrays)
    assert np.isfinite(loss[0]).all() and (loss[0] > 0).all()


def test_ctc_loss_ndarray_matches_brute_force():
    """The loss of one short sequence is -log of the summed probability
    of every frame path that collapses to the label (repeats merged,
    blanks dropped), enumerated."""
    import itertools

    rng = np.random.RandomState(4)
    Tn, C = 4, 3
    x = rng.randn(Tn, 1, C).astype(np.float32)
    lab = np.array([[1, 1]], np.float32)         # blank 0, labels "1 1"
    with mt.cpu():
        loss = mt.nd.ctc_loss(mt.nd.array(x), mt.nd.array(lab)).asnumpy()
    p = np.exp(x[:, 0]) / np.exp(x[:, 0]).sum(-1, keepdims=True)
    total = 0.0
    for path in itertools.product(range(C), repeat=Tn):
        merged = [k for i, k in enumerate(path) if i == 0 or k != path[i - 1]]
        if [k for k in merged if k != 0] == [1, 1]:
            total += np.prod([p[t, k] for t, k in enumerate(path)])
    np.testing.assert_allclose(loss, [-np.log(total)], rtol=1e-5)
