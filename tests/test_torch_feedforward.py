"""The port's ``model.FeedForward`` and ``DataParallelExecutorManager``
against the JAX reference's, on the CPU.

- ``FeedForward`` over an MLP (FullyConnected / Activation /
  SoftmaxOutput) and over a GRU RNN-op language model, from the same
  numpy parameters (no initializer draw): ``fit`` over an iterator
  (unshuffled: the reference's numpy ``fit`` shuffles with numpy's global
  generator), then ``predict`` and ``score`` on numpy arrays; parameters
  within 2e-6 of the reference's, predictions within 1e-5 and the score
  within 1e-6.  ``create`` trains as ``fit``.  ``fit`` on numpy arrays
  shuffles with the port's own generator (``random.np_rng``) and rolls
  the last batch over.
- A checkpoint written by either package's ``FeedForward.save`` loads
  with the other's ``FeedForward.load`` and predicts the same.
- ``DataParallelExecutorManager`` against the reference's: the same
  outputs, gradients and metric after a staged batch, ``copy_to`` and
  the ``sym_gen`` bucket path; more than one context raises, naming
  ROADMAP §A18.
"""

import numpy as np
import pytest

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

_RS = np.random.RandomState(0)
X = _RS.randn(48, 10).astype(np.float32)
Y = _RS.randint(0, 4, 48).astype(np.float32)
OPT = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)


def _mlp(M):
    with M.sym.NameManager():
        data = M.sym.Variable("data")
        h = M.sym.FullyConnected(data, name="fc1", num_hidden=16)
        h = M.sym.Activation(h, act_type="relu")
        h = M.sym.FullyConnected(h, name="fc2", num_hidden=4)
        return M.sym.SoftmaxOutput(h, name="softmax")


def _params(net, seed=1, **shapes):
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


def _as_nd(M, params):
    return {k: M.nd.array(v) for k, v in params.items()}


def _values(d):
    return {k: v.asnumpy() for k, v in d.items()}


def _fit_mlp(M, create=False):
    with M.cpu():
        net = _mlp(M)
        params = _params(net, data=(16, 10))
        train = M.io.NDArrayIter(X, Y, batch_size=16)
        if create:
            ff = M.model.FeedForward.create(
                net, train, ctx=M.cpu(), num_epoch=2,
                arg_params=_as_nd(M, params), **OPT)
        else:
            ff = M.model.FeedForward(net, ctx=M.cpu(), num_epoch=2,
                                     numpy_batch_size=16,
                                     arg_params=_as_nd(M, params), **OPT)
            ff.fit(train)
        pred = ff.predict(X)
        score = ff.score(X, Y)
    return ff, _values(ff.arg_params), pred, score


@pytest.mark.parametrize("create", [False, True], ids=["fit", "create"])
def test_feedforward_fit_predict_score_match_reference(create):
    _, ref, ref_pred, ref_score = _fit_mlp(mx, create)
    ff, got, pred, score = _fit_mlp(mt, create)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2e-6)
    np.testing.assert_allclose(pred, ref_pred, rtol=0, atol=1e-5)
    assert score == pytest.approx(ref_score, abs=1e-6)
    assert isinstance(pred, np.ndarray) and pred.shape == ref_pred.shape


def _gru_lm(M, V=13, E=6, H=5):
    with M.sym.NameManager():
        emb = M.sym.Embedding(M.sym.Variable("data"), input_dim=V,
                              output_dim=E, name="embed")
        rnn = M.sym.RNN(M.sym.SwapAxis(emb, dim1=0, dim2=1), state_size=H,
                        num_layers=2, mode="gru", name="gru")
        flat = M.sym.Reshape(M.sym.SwapAxis(rnn, dim1=0, dim2=1),
                             shape=(-1, H))
        fc = M.sym.FullyConnected(flat, num_hidden=V, name="cls")
        label = M.sym.Reshape(M.sym.Variable("softmax_label"), shape=(-1,))
        return M.sym.SoftmaxOutput(fc, label, name="softmax")


def test_feedforward_trains_the_gru_lm_as_the_reference():
    rng = np.random.RandomState(2)
    toks = rng.randint(0, 13, (12, 7)).astype(np.float32)
    labels = rng.randint(0, 13, (12, 7)).astype(np.float32)
    out = {}
    for M in (mx, mt):
        with M.cpu():
            net = _gru_lm(M)
            params = _params(net, data=(4, 7), softmax_label=(4, 7))
            ff = M.model.FeedForward(net, ctx=M.cpu(), num_epoch=1,
                                     numpy_batch_size=4,
                                     arg_params=_as_nd(M, params), **OPT)
            ff.fit(M.io.NDArrayIter(toks, labels, batch_size=4))
            pred = ff.predict(M.io.NDArrayIter(toks, labels, batch_size=4))
        out[M] = (_values(ff.arg_params), pred)
    for k, v in out[mx][0].items():
        np.testing.assert_allclose(out[mt][0][k], v, rtol=0, atol=2e-6)
    np.testing.assert_allclose(out[mt][1], out[mx][1], rtol=0, atol=1e-5)


def test_feedforward_numpy_fit_shuffles_with_the_port_generator():
    with mt.cpu():
        net = _mlp(mt)
        ff = mt.model.FeedForward(net, ctx=mt.cpu(), num_epoch=1,
                                  numpy_batch_size=20,
                                  arg_params=_as_nd(mt, _params(
                                      net, data=(16, 10))), **OPT)
        it = ff._init_iter(X, Y, is_train=True)
        assert it.last_batch_handle == "roll_over"
        mt.random.seed(7)
        seen = np.concatenate([b.data[0].asnumpy()
                               for b in ff._init_iter(X, Y, True)])
        assert sorted(map(tuple, seen[:48])) == sorted(map(tuple, X))
        assert not np.array_equal(seen[:48], X)
        mt.random.seed(7)
        again = np.concatenate([b.data[0].asnumpy()
                                for b in ff._init_iter(X, Y, True)])
        np.testing.assert_array_equal(seen, again)
        with pytest.raises(ValueError, match="y is required"):
            ff._init_iter(X, None, is_train=True)
        module = ff._get_module(it)
        assert module.data_names == ["data"]
        assert module.label_names == ["softmax_label"]
        ff.fit(X, Y)
        assert ff.predict(X).shape == (48, 4)


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_feedforward_checkpoint_crosses_packages(direction, tmp_path):
    src, dst = (mt, mx) if direction == "port_to_reference" else (mx, mt)
    prefix = str(tmp_path / "ff")
    with src.cpu():
        net = _mlp(src)
        ff = src.model.FeedForward(net, ctx=src.cpu(), num_epoch=3,
                                   arg_params=_as_nd(src, _params(
                                       net, data=(16, 10))))
        ff.save(prefix)
        want = ff.predict(X)
    with dst.cpu():
        loaded = dst.model.FeedForward.load(prefix, 3, ctx=dst.cpu())
        assert loaded.begin_epoch == 3
        got = loaded.predict(X)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _manager(M, ctx=None, sym_gen=None, key=None):
    with M.cpu():
        net = _mlp(M)
        params = _params(net, data=(16, 10))
        train = M.io.NDArrayIter(X, Y, batch_size=16)
        if key is not None:
            train.default_bucket_key = key
        args = net.list_arguments()
        names = [n for n in args if n not in ("data", "softmax_label")]
        mgr = M.executor_manager.DataParallelExecutorManager(
            net, ctx or [M.cpu()], train, args, names, [],
            sym_gen=sym_gen)
        mgr.set_params(_as_nd(M, params), {})
        batch = next(iter(train))
        if key is not None:
            batch.bucket_key = key
            batch.provide_data = train.provide_data
            batch.provide_label = train.provide_label
        mgr.load_data_batch(batch)
        mgr.forward(is_train=True)
        mgr.backward()
        metric = M.metric.create("acc")
        mgr.update_metric(metric, batch.label)
        grads = {n: g[0].asnumpy() for n, g in zip(names, mgr.grad_arrays)}
        outs = [o.asnumpy() for o in mgr.curr_execgrp.get_outputs()]
        copied = {n: M.nd.zeros(v.shape) for n, v in params.items()}
        mgr.copy_to(copied, {})
        return mgr, grads, outs, metric.get(), _values(copied), params


@pytest.mark.parametrize("bucketed", [False, True], ids=["plain", "sym_gen"])
def test_executor_manager_matches_reference(bucketed):
    res = {}
    for M in (mx, mt):
        gen = (lambda key, M=M: _mlp(M)) if bucketed else None
        res[M] = _manager(M, sym_gen=gen, key=7 if bucketed else None)
    _, g_ref, o_ref, m_ref, c_ref, params = res[mx]
    mgr, g, o, m, c, _ = res[mt]
    for k in g_ref:
        np.testing.assert_allclose(g[k], g_ref[k], rtol=0, atol=1e-5)
    np.testing.assert_allclose(o[0], o_ref[0], rtol=0, atol=1e-6)
    assert m == m_ref
    for k, v in params.items():
        np.testing.assert_array_equal(c[k], v)
    assert mgr.slices == [slice(0, 16)]
    if bucketed:
        assert list(mgr.execgrp_bucket) == [7]


def test_executor_manager_more_contexts_raise_naming_a18():
    with mt.cpu():
        net = _mlp(mt)
        train = mt.io.NDArrayIter(X, Y, batch_size=16)
        with pytest.raises(NotImplementedError, match="A18"):
            mt.executor_manager.DataParallelExecutorManager(
                net, [mt.cpu(0), mt.cpu(1)], train, net.list_arguments(),
                ["fc1_weight"], [])
