"""The port's SequentialModule, PythonModule, PythonLossModule, Monitor
and count_flops against the JAX reference's, on the CPU.

- A ``SequentialModule`` of two Modules (an MLP's hidden layer, then its
  head with ``take_labels`` and ``auto_wiring``), from the same numpy
  parameters, over 3 SGD steps: parameters within 2e-6 of the
  reference's, outputs within 1e-6, the input gradients of a module
  bound with ``inputs_need_grad`` and the metric the same.
- A Module followed by a ``PythonLossModule`` whose ``grad_func`` is a
  numpy softmax cross-entropy gradient: the same parameters after 3
  steps; a ``PythonModule`` subclass binds and reports its shapes.
- ``Monitor``: one monitored step of a Module gives the reference's
  ``(step, name, stat)`` list, names in order and each statistic within
  1e-6 of its value (the reference's default statistic raises on its
  NDArray, so it is given the port's default, the mean absolute value,
  explicitly); the interval, ``sort`` and ``toc_print``.
- ``flops.count_flops`` equal to the reference's for ``gpt_symbol``, an
  RNN-op language model and ``lstm_unroll_symbol``.
"""

import logging

import numpy as np
import pytest

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import mxnet_tpu as mx
import mxnet_tpu.flops  # noqa: F401  (not imported by the package)
import mxnet_tpu_torch as mt

_RS = np.random.RandomState(0)
X = _RS.randn(32, 10).astype(np.float32)
Y = _RS.randint(0, 4, 32).astype(np.float32)
SGD = (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4))


def _params(shapes, seed=1):
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in shapes.items()}


PARAMS = _params({"fc1_weight": (16, 10), "fc1_bias": (16,),
                  "fc2_weight": (4, 16), "fc2_bias": (4,)})


def _parts(M):
    with M.sym.NameManager():
        h = M.sym.Activation(M.sym.FullyConnected(
            M.sym.Variable("data"), name="fc1", num_hidden=16),
            act_type="relu")
        out = M.sym.SoftmaxOutput(M.sym.FullyConnected(
            M.sym.Variable("data"), name="fc2", num_hidden=4),
            name="softmax")
    return h, out


def _batches(M, n=3):
    return [M.io.DataBatch([M.nd.array(X[i * 8:(i + 1) * 8])],
                           [M.nd.array(Y[i * 8:(i + 1) * 8])])
            for i in range(n)]


def _train(mod, M, steps=3, metric=None):
    outs = []
    for db in _batches(M, steps):
        mod.forward(db, is_train=True)
        mod.backward()
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
        if metric is not None:
            mod.update_metric(metric, db.label)
    return outs


def _params_of(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _sequential(M):
    with M.cpu():
        body, head = _parts(M)
        seq = M.mod.SequentialModule()
        seq.add(M.mod.Module(body, label_names=[], context=M.cpu()))
        seq.add(M.mod.Module(head, context=M.cpu()), take_labels=True,
                auto_wiring=True)
        seq.bind([("data", (8, 10))], [("softmax_label", (8,))],
                 inputs_need_grad=True)
        seq.init_params(arg_params={k: M.nd.array(v)
                                    for k, v in PARAMS.items()})
        seq.init_optimizer(optimizer="sgd", optimizer_params=SGD)
        metric = M.metric.create("acc")
        outs = _train(seq, M, metric=metric)
        grads = seq.get_input_grads()[0].asnumpy()
        return seq, _params_of(seq), outs, grads, metric.get()


def test_sequential_module_matches_reference():
    _, ref, ref_outs, ref_grads, ref_metric = _sequential(mx)
    seq, got, outs, grads, metric = _sequential(mt)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2e-6)
    for a, b in zip(outs, ref_outs):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(grads, ref_grads, rtol=0, atol=1e-6)
    assert metric[0] == ref_metric[0]
    assert metric[1] == pytest.approx(ref_metric[1], abs=1e-9)
    assert seq.data_names == ["data"]
    assert seq.output_names == ["softmax_output"]
    assert seq.label_shapes == [("softmax_label", (8,))]


def _softmax_ce_grad(scores, labels):
    p = scores.asnumpy()
    p = np.exp(p - p.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    p[np.arange(len(p)), labels.asnumpy().astype(int)] -= 1.0
    return p


def _with_python_loss(M):
    with M.cpu():
        with M.sym.NameManager():
            logits = M.sym.FullyConnected(M.sym.Variable("data"), name="fc1",
                                          num_hidden=4)
        seq = M.mod.SequentialModule()
        seq.add(M.mod.Module(logits, label_names=[], context=M.cpu()))
        seq.add(M.mod.PythonLossModule(grad_func=_softmax_ce_grad),
                take_labels=True, auto_wiring=True)
        seq.bind([("data", (8, 10))], [("softmax_label", (8,))])
        seq.init_params(arg_params={
            "fc1_weight": M.nd.array(PARAMS["fc2_weight"][:, :10]),
            "fc1_bias": M.nd.array(PARAMS["fc2_bias"])})
        seq.init_optimizer(optimizer="sgd", optimizer_params=SGD)
        outs = _train(seq, M)
        return seq, _params_of(seq), outs


def test_python_loss_module_matches_reference():
    _, ref, ref_outs = _with_python_loss(mx)
    seq, got, outs = _with_python_loss(mt)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2e-6)
    for a, b in zip(outs, ref_outs):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    loss = seq._modules[-1]
    assert loss.output_shapes == [("pyloss_output", (8, 4))]
    assert loss.get_params() == ({}, {})
    with pytest.raises(mt.MXNetError, match="ignores out_grads"):
        loss.backward(out_grads=[mt.nd.zeros((8, 4), ctx=mt.cpu())])


def test_python_module_subclass_binds_and_reports_shapes():
    class Doubler(mt.mod.PythonModule):
        def _compute_output_shapes(self):
            return [("double_output", self._data_shapes[0][1])]

    mod = Doubler(("data",), (), ["double_output"])
    assert mod.data_names == ["data"] and mod.label_shapes is None
    mod.bind([("data", (8, 10))])
    mod.init_params()
    mod.init_optimizer()
    assert mod.binded and mod.params_initialized and mod.optimizer_initialized
    assert mod.output_shapes == [("double_output", (8, 10))]
    assert mod.get_params() == ({}, {})
    mod.update()
    with pytest.raises(mt.MXNetError, match="single data/label"):
        mt.mod.PythonLossModule(data_names=("a", "b"))
    with pytest.raises(TypeError, match="callable"):
        mt.mod.PythonLossModule(grad_func=3)


def _monitored(M, **kw):
    with M.cpu():
        body, head = _parts(M)
        mod = M.mod.Module(head(data=body), context=M.cpu())
        mod.bind([("data", (8, 10))], [("softmax_label", (8,))])
        mod.init_params(arg_params={k: M.nd.array(v)
                                    for k, v in PARAMS.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
        if M is mx:
            kw.setdefault("stat_func", lambda x: np.abs(x.asnumpy()).mean())
        mon = M.monitor.Monitor(1, **kw)
        mod.install_monitor(mon)
        mon.tic()
        _train(mod, M, steps=1)
        return mon.toc(), mon, mod


@pytest.mark.parametrize("pattern", [".*", ".*weight"])
def test_monitor_one_step_matches_reference(pattern):
    ref, _, _ = _monitored(mx, pattern=pattern)
    got, mon, mod = _monitored(mt, pattern=pattern)
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in ref]
    assert len(got) >= 4
    for (_, name, a), (_, _, b) in zip(got, ref):
        assert float(a) == pytest.approx(float(b), rel=1e-6, abs=1e-9), name
    names = {n for _, n, _ in got}
    assert {"fc1_weight", "fc1_weight_grad"} <= names
    if pattern == ".*weight":
        assert names == {"fc1_weight", "fc1_weight_grad", "fc2_weight",
                         "fc2_weight_grad"}


def test_monitor_interval_sort_and_print(caplog):
    got, mon, mod = _monitored(mt, pattern=".*weight", sort=True)
    assert [n for _, n, _ in got] == sorted(n for _, n, _ in got)
    mon.interval = 2
    mon.step = 1
    with mt.cpu():
        mon.tic()        # step 1: not a multiple of the interval
        _train(mod, mt, steps=1)
        assert mon.toc() == []
        mon.tic()
        _train(mod, mt, steps=1)
    with caplog.at_level(logging.INFO):
        mon.toc_print()
    assert sum("fc2_weight_grad" in r.getMessage()
               for r in caplog.records) == 1


def _lm(M):
    with M.sym.NameManager():
        emb = M.sym.Embedding(M.sym.Variable("data"), input_dim=20,
                              output_dim=8, name="embed")
        rnn = M.sym.RNN(M.sym.SwapAxis(emb, dim1=0, dim2=1), state_size=8,
                        num_layers=2, mode="lstm", name="lstm")
        flat = M.sym.Reshape(M.sym.SwapAxis(rnn, dim1=0, dim2=1),
                             shape=(-1, 8))
        fc = M.sym.FullyConnected(flat, num_hidden=20, name="cls")
        label = M.sym.Reshape(M.sym.Variable("softmax_label"), shape=(-1,))
        return M.sym.SoftmaxOutput(fc, label, name="softmax")


def _gpt(M):
    kw = dict(num_layers=2, d_model=32, num_heads=4)
    with M.sym.NameManager():
        if M is mx:
            return mx.models.gpt(53, 16, **kw)
        return mt.models.gpt_symbol(53, 16, **kw)


def _unroll(M):
    kw = dict(num_lstm_layer=2, seq_len=5, input_size=30, num_hidden=8,
              num_embed=6, num_label=30)
    with M.sym.NameManager():
        if M is mx:
            return mx.models.lstm_unroll(**kw)
        return mt.models.lstm_unroll_symbol(**kw)


FLOPS_CASES = {
    "gpt_symbol": (_gpt, dict(data=(2, 16), softmax_label=(2, 16))),
    "rnn_lm": (_lm, dict(data=(4, 9), softmax_label=(4, 9))),
    "lstm_unroll_symbol": (_unroll, dict(
        data=(4, 5), softmax_label=(4, 5),
        **{f"l{i}_init_{k}": (4, 8) for i in range(2) for k in "ch"})),
}


@pytest.mark.parametrize("case", sorted(FLOPS_CASES))
def test_count_flops_matches_reference(case):
    build, shapes = FLOPS_CASES[case]
    want = mx.flops.count_flops(build(mx), **shapes)
    got = mt.flops.count_flops(build(mt), **shapes)
    assert got == want > 0
