"""The port's custom operators (``operator.py``, ``nd.Custom``,
``sym.Custom``) against the reference's, on the CPU.

- ``tests/test_operator.py::test_custom_dispatcher``'s cases: a
  registered ``CustomOpProp`` through ``nd.Custom`` and ``sym.Custom``
  (forward and the op's own backward), an unknown ``op_type`` raising,
  ``register`` refreshing ``nd.<name>`` and ``sym.<name>``.
- ``examples/numpy_ops.py``'s softmax as a ``CustomOp`` and as a
  ``NumpyOp`` (and an ``NDArrayOp``), forward and backward against the
  reference's on the same inputs, then trained through ``Module.fit``
  (SGD with momentum, an unshuffled iterator, the same initial
  parameters) in both packages: every parameter within 1e-5 of the
  reference's after the epoch (float32 products in other orders).
- The callbacks' buffers: numpy arrays with ``asnumpy``,
  ``wait_to_read`` and ``context`` (the CPU), run under the CPU context.

The registries are process-global: every op name here is unique to this
file.  Inputs come from ``numpy.random.default_rng``.
"""

import numpy as np
import pytest

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

FIT_TOL = 1e-5


def _scale_prop(M, name, seen=None):
    op = M.operator

    @op.register(name)
    class ScaleProp(op.CustomOpProp):
        def list_arguments(self):
            return ["data"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            class Scale(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    if seen is not None:
                        seen.append((type(in_data[0]), in_data[0].context,
                                     M.current_context()))
                        in_data[0].wait_to_read()
                    self.assign(out_data[0], req[0], in_data[0] * 2.0)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0] * 2.0)

            return Scale()

    return ScaleProp


def test_custom_dispatcher_matches_reference():
    seen = []
    _scale_prop(mx, "_cop_scale2x")
    _scale_prop(mt, "_cop_scale2x", seen)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    with mt.cpu():
        got = mt.nd.Custom(mt.nd.array(x), op_type="_cop_scale2x").asnumpy()
        direct = mt.nd._cop_scale2x(mt.nd.array(x)).asnumpy()
    want = mx.nd.Custom(mx.nd.array(x), op_type="_cop_scale2x").asnumpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(direct, x * 2.0)
    cls, ctx, current = seen[0]
    assert issubclass(cls, np.ndarray) and ctx == mt.cpu()
    assert current == mt.cpu()
    # the Symbol: forward and the op's own backward
    outs = {}
    head = rng.standard_normal((3, 4)).astype(np.float32)
    for M in (mx, mt):
        s = M.sym.Custom(M.sym.Variable("data"), op_type="_cop_scale2x",
                         name="sc")
        assert s.list_arguments() == ["data"]
        with M.cpu():
            exe = s.simple_bind(M.cpu(), data=x.shape)
            exe.arg_dict["data"][:] = x
            y = exe.forward(is_train=True)[0].asnumpy()
            exe.backward([M.nd.array(head)])
            outs[M] = (y, exe.grad_dict["data"].asnumpy())
    for g, w in zip(outs[mt], outs[mx]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(outs[mt][1], head * 2.0)
    assert hasattr(mt.sym, "_cop_scale2x") and hasattr(mt.nd, "_cop_scale2x")


def test_custom_unknown_op_type_raises():
    data = mt.sym.Variable("data")
    with pytest.raises(mt.MXNetError, match="not registered"):
        mt.sym.Custom(data, op_type="_cop_no_such_op")
    with pytest.raises(mt.MXNetError, match="not registered"):
        mt.nd.Custom(op_type="_cop_no_such_op")
    for fn in (mt.sym.Custom, mt.nd.Custom):
        with pytest.raises(TypeError, match="op_type"):
            fn(data)
    assert "_cop_demo_softmax" in mt.operator.get_all_registered_operators()


# -- examples/numpy_ops.py's softmax -----------------------------------------
def _softmax_ops(M, tag):
    """The example's CustomOp softmax registered as ``tag`` and its
    NumpyOp and NDArrayOp twins."""
    op = M.operator

    class Softmax(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        M.nd.array(e / e.sum(axis=1, keepdims=True)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().ravel().astype(np.int64)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], M.nd.array(y))

    @op.register(tag)
    class SoftmaxProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    def legacy(base):
        class NumpySoftmax(base):
            def __init__(self):
                super().__init__(need_top_grad=False)

            def list_arguments(self):
                return ["data", "label"]

            def list_outputs(self):
                return ["output"]

            def infer_shape(self, in_shape):
                return [in_shape[0], (in_shape[0][0],)], [in_shape[0]]

            def forward(self, in_data, out_data):
                x = in_data[0]
                e = np.exp(x - x.max(axis=1, keepdims=True))
                out_data[0][:] = e / e.sum(axis=1, keepdims=True)

            def backward(self, out_grad, in_data, out_data, in_grad):
                lab = in_data[1].ravel().astype(np.int64)
                y = out_data[0].copy()
                y[np.arange(lab.shape[0]), lab] -= 1.0
                in_grad[0][:] = y

        return NumpySoftmax()

    return {"custom": tag, "numpy": legacy(op.NumpyOp),
            "ndarray": legacy(op.NDArrayOp)}


_OPS = {mx: _softmax_ops(mx, "_cop_demo_softmax"),
        mt: _softmax_ops(mt, "_cop_demo_softmax")}


def _net(M, kind):
    data = M.sym.Variable("data")
    fc1 = M.sym.FullyConnected(data, name="fc1", num_hidden=16)
    act1 = M.sym.Activation(fc1, act_type="relu")
    fc2 = M.sym.FullyConnected(act1, name="fc2", num_hidden=10)
    label = M.sym.Variable("softmax_label")
    if kind == "custom":
        return M.sym.Custom(fc2, label, name="softmax",
                            op_type=_OPS[M]["custom"])
    return _OPS[M][kind](data=fc2, label=label, name="softmax")


def _data(n=64):
    rng = np.random.default_rng(1)
    y = rng.integers(0, 10, n)
    X = rng.standard_normal((n, 40)).astype(np.float32) * 0.3
    X[np.arange(n), y * 4] += 2.0
    return X, y.astype(np.float32)


@pytest.mark.parametrize("kind", ["custom", "numpy", "ndarray"])
def test_softmax_op_forward_backward_matches_reference(kind):
    X, y = _data(8)
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((8, 10)).astype(np.float32)
    res = {}
    for M in (mx, mt):
        label = M.sym.Variable("softmax_label")
        if kind == "custom":
            s = M.sym.Custom(M.sym.Variable("data"), label, name="sm",
                             op_type=_OPS[M]["custom"])
        else:
            s = _OPS[M][kind](data=M.sym.Variable("data"), label=label,
                              name="sm")
        assert s.list_arguments() == ["data", "softmax_label"]
        with M.cpu():
            exe = s.simple_bind(M.cpu(), data=(8, 10), softmax_label=(8,))
            exe.arg_dict["data"][:] = logits
            exe.arg_dict["softmax_label"][:] = y
            out = exe.forward(is_train=True)[0].asnumpy()
            exe.backward()
            res[M] = (out, exe.grad_dict["data"].asnumpy(),
                      exe.grad_dict["softmax_label"].asnumpy())
    for g, w in zip(res[mt], res[mx]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)
    assert not res[mt][2].any()
    np.testing.assert_allclose(res[mt][0].sum(1), 1.0, atol=1e-6)


def _fit(M, kind, init):
    X, y = _data()
    with M.cpu():
        mod = M.mod.Module(_net(M, kind), context=M.cpu())
        mod.fit(M.io.NDArrayIter(X, y, 16), num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                arg_params={k: M.nd.array(v) for k, v in init.items()})
        args, _ = mod.get_params()
        return {k: v.asnumpy() for k, v in args.items()}


@pytest.mark.parametrize("kind", ["custom", "numpy"])
def test_module_fit_through_custom_softmax_matches_reference(kind):
    with mx.sym.NameManager():
        net = _net(mx, kind)
    shapes = net.infer_shape(data=(16, 40), softmax_label=(16,))[0]
    rng = np.random.default_rng(3)
    init = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    want, got = _fit(mx, kind, init), _fit(mt, kind, init)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= FIT_TOL, k
        assert np.abs(got[k] - init[k]).max() > 1e-3, k      # it trained


def test_host_array_surface():
    from mxnet_tpu_torch.operator import _host_array

    a = _host_array(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert isinstance(a.asnumpy(), np.ndarray)
    assert a.wait_to_read() is a and a.wait_to_write() is a
    assert a.context == mt.cpu()
    deps = mt.operator.NDArrayOp().declare_backward_dependency([1], [2], [3])
    assert deps == [1, 2, 3]
