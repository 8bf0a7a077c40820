"""The port's Executor (``mxnet_tpu_torch.executor``) against the reference's.

Each case of the reference's ``tests/test_executor.py`` (grad_req write,
add and null, per-argument dicts, forward kwargs, loss-op head gradients,
the monitor callback, mirroring, reshape, partial_forward) runs in both
packages on the same seeded numpy inputs under a CPU context; outputs and
gradients are held within 2e-6 (float32 in another order) or exactly
where no arithmetic differs.  Dropout is held by its rate and scale
statistics (the two generators differ) and by reproducing its own draws.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx
from torch_port_fixtures import (  # noqa: F401
    collect_engines_after_module)  # (autouse)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = 2e-6
_RS = np.random.RandomState(11)
A = _RS.rand(3, 4).astype(np.float32)
B = _RS.rand(3, 4).astype(np.float32)
H = _RS.randn(3, 4).astype(np.float32)


def _ab(M):
    a, b = M.sym.Variable("a"), M.sym.Variable("b")
    return a * b + a


def _mlp(M, loss="SoftmaxOutput"):
    data = M.sym.Variable("data")
    net = M.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = M.sym.Activation(net, act_type="tanh")
    net = M.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return getattr(M.sym, loss)(net, name="softmax")


def _both(case):
    out = []
    for M in (mx, mt):
        with M.cpu(), M.sym.NameManager():
            out.append(case(M))
    return out


def _close(ref, got, tol=TOL):
    assert set(ref) == set(got)
    for k in ref:
        r, g = np.asarray(ref[k]), np.asarray(got[k])
        assert g.shape == r.shape, k
        scale = max(float(np.abs(r).max()), 1.0) if r.size else 1.0
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * scale, err_msg=k)


def test_bind_write_add_null_and_dict_reqs():
    def case(M):
        out, res = _ab(M), {}
        exe = out.bind(M.cpu(), args={"a": M.nd.array(A), "b": M.nd.array(B)})
        res["fwd"] = exe.forward()[0].asnumpy()
        ga, gb = M.nd.zeros((3, 4)), M.nd.zeros((3, 4))
        exe = out.bind(M.cpu(), args=[M.nd.array(A), M.nd.array(B)],
                       args_grad=[ga, gb], grad_req="write")
        exe.forward(is_train=True)
        exe.backward([M.nd.array(H)])
        res["write_a"], res["write_b"] = ga.asnumpy(), gb.asnumpy()
        ga, gb = M.nd.ones((3, 4)), M.nd.ones((3, 4))
        exe = out.bind(M.cpu(), args=[M.nd.array(A), M.nd.array(B)],
                       args_grad=[ga, gb], grad_req="add")
        for i in range(2):
            exe.forward(is_train=True)
            exe.backward([M.nd.array(H * (i + 1))])
        res["add_a"], res["add_b"] = ga.asnumpy(), gb.asnumpy()
        exe = out.simple_bind(M.cpu(), grad_req="null", a=(2, 2), b=(2, 2))
        exe.forward(is_train=True)
        exe.backward()
        res["null_empty"] = np.array(exe.grad_dict == {})
        exe = out.simple_bind(M.cpu(), grad_req={"a": "write", "b": "null"},
                              a=(3, 4), b=(3, 4))
        res["dict_keys"] = np.array(sorted(exe.grad_dict))
        exe.forward(is_train=True, a=A, b=B)
        exe.backward(M.nd.array(H))
        res["dict_a"] = exe.grad_dict["a"].asnumpy()
        res["kwargs"] = exe.forward(a=np.ones((3, 4)),
                                    b=np.full((3, 4), 3.0))[0].asnumpy()
        res["output_names"] = np.array(list(exe.output_dict))
        return res

    ref, got = _both(case)
    for k in ("null_empty", "dict_keys", "output_names"):
        np.testing.assert_array_equal(got.pop(k), ref.pop(k))
    _close(ref, got)


def test_loss_ops_ignore_head_gradients():
    x = _RS.randn(4, 8).astype(np.float32)
    y = np.array([0, 1, 2, 3], np.float32)

    def case(M):
        exe = _mlp(M).simple_bind(M.cpu(), data=(4, 8), softmax_label=(4,))
        rng = np.random.RandomState(7)
        for name, arr in exe.arg_dict.items():
            if name not in ("data", "softmax_label"):
                arr[:] = rng.uniform(-0.3, 0.3, arr.shape)
        res = {}
        exe.forward(is_train=True, data=x, softmax_label=y)
        exe.backward()
        res["ones"] = exe.grad_dict["fc1_weight"].asnumpy()
        res["data_ones"] = exe.grad_dict["data"].asnumpy()
        exe.forward(is_train=True)
        exe.backward([M.nd.array(rng.randn(4, 4).astype(np.float32))])
        res["random_head"] = exe.grad_dict["fc1_weight"].asnumpy()
        res["label_grad"] = exe.grad_dict["softmax_label"].asnumpy()
        # a second backward with explicit head gradients after the first
        # consumed the forward (the reference re-runs its program)
        exe.backward([M.nd.array(np.ones((4, 4), np.float32))])
        res["again"] = exe.grad_dict["fc1_weight"].asnumpy()
        res["out"] = exe.outputs[0].asnumpy()
        return res

    ref, got = _both(case)
    _close(ref, got)
    np.testing.assert_array_equal(got["ones"], got["random_head"])
    np.testing.assert_array_equal(got["label_grad"], 0)


def test_monitor_callback_sees_every_output():
    def case(M):
        exe = _mlp(M).simple_bind(M.cpu(), data=(4, 8), softmax_label=(4,))
        exe.copy_params_from({k: np.full(v.shape, 0.05, np.float32)
                              for k, v in exe.arg_dict.items()
                              if k not in ("data", "softmax_label")})
        seen = {}
        exe.set_monitor_callback(lambda n, a: seen.__setitem__(n, a.asnumpy()))
        exe.forward(is_train=True, data=np.ones((4, 8), np.float32),
                    softmax_label=np.zeros(4, np.float32))
        exe.backward()
        seen["grad"] = exe.grad_dict["fc2_weight"].asnumpy()
        return seen

    ref, got = _both(case)
    assert list(got) == list(ref)
    _close(ref, got)


@pytest.mark.parametrize("how", ["attr", "env", "gpt_remat"])
def test_mirroring_keeps_gradients(how, monkeypatch):
    """Recomputation through torch.utils.checkpoint: the gradients equal
    the plain run's and the reference's."""
    def build(M, mirror):
        if how == "gpt_remat":
            fn = mx.models.gpt if M is mx else mt.models.gpt_symbol
            return fn(fx.VOCAB, 16, remat=mirror, **fx.VARIANTS["gpt2"]), \
                dict(data=(2, 16), softmax_label=(2, 16))
        if how == "env":
            monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR",
                               "1" if mirror else "0")
            return _mlp(M), dict(data=(4, 8), softmax_label=(4,))
        data = M.sym.Variable("data")
        scope = M.AttrScope(force_mirroring="1") if mirror else M.AttrScope()
        with scope:
            act = M.sym.Activation(data, act_type="tanh")
        return M.sym.MakeLoss(M.sym.sum(act * act)), dict(data=(3, 3))

    def case(M):
        res = {}
        for mirror in (False, True):
            net, shapes = build(M, mirror)
            exe = net.simple_bind(M.cpu(), **shapes)
            rng = np.random.RandomState(3)
            for name, arr in exe.arg_dict.items():
                if name in ("data", "softmax_label") and how != "attr":
                    arr[:] = rng.randint(0, 4, arr.shape)
                else:
                    arr[:] = rng.uniform(-0.5, 0.5, arr.shape)
            exe.forward(is_train=True)
            exe.backward()
            for k, g in exe.grad_dict.items():
                res[f"{mirror}_{k}"] = g.asnumpy()
        return res

    ref, got = _both(case)
    _close(ref, got)
    for k in got:
        if k.startswith("True_"):
            np.testing.assert_allclose(got[k], got["False_" + k[5:]],
                                       rtol=0, atol=1e-6)


def test_reshape_flags_and_buffer_reuse():
    def case(M):
        out = _ab(M)
        exe = out.simple_bind(M.cpu(), a=(4, 2), b=(4, 2))
        exe.arg_dict["a"][:] = np.arange(8).reshape(4, 2)
        res = {}
        small = exe.reshape(a=(2, 2), b=(2, 2))
        res["prefix"] = small.arg_dict["a"].asnumpy()
        res["small_out"] = small.forward(b=np.ones((2, 2)))[0].asnumpy()
        try:
            exe.reshape(a=(8, 2), b=(8, 2))
            res["up_refused"] = np.array(False)
        except M.MXNetError:
            res["up_refused"] = np.array(True)
        big = exe.reshape(a=(8, 2), b=(8, 2), allow_up_sizing=True)
        res["big"] = big.forward(a=np.ones((8, 2)),
                                 b=np.ones((8, 2)))[0].asnumpy()
        net = _mlp(M)
        e2 = net.simple_bind(M.cpu(), data=(4, 8), softmax_label=(4,))
        try:
            e2.reshape(data=(4, 6))
            res["partial_refused"] = np.array(False)
        except M.MXNetError:
            res["partial_refused"] = np.array(True)
        e3 = e2.reshape(partial_shaping=True, data=(2, 6))
        res["w_shape"] = np.array(e3.arg_dict["fc1_weight"].shape)
        return res

    ref, got = _both(case)
    _close(ref, got)
    # same-or-smaller reuses the old array's memory in the port too
    with mt.cpu():
        exe = _ab(mt).simple_bind(mt.cpu(), a=(4, 2), b=(4, 2))
        small = exe.reshape(a=(2, 2), b=(2, 2))
        small.arg_dict["a"][:] = 9.0
        assert (exe.arg_dict["a"].asnumpy()[:2] == 9.0).all()


def test_partial_forward_matches_full_forward_and_backward():
    x = _RS.randn(4, 8).astype(np.float32)
    y = np.array([0, 1, 2, 3], np.float32)

    def case(M):
        exe = _mlp(M).simple_bind(M.cpu(), data=(4, 8), softmax_label=(4,))
        rng = np.random.RandomState(5)
        for name, arr in exe.arg_dict.items():
            if name not in ("data", "softmax_label"):
                arr[:] = rng.uniform(-0.3, 0.3, arr.shape)
        exe.arg_dict["data"][:] = x
        exe.arg_dict["softmax_label"][:] = y
        seen = []
        exe.set_monitor_callback(lambda n, a: seen.append(n))
        res = {"full": exe.forward(is_train=True)[0].asnumpy()}
        exe.backward()
        res["full_g"] = exe.grad_dict["fc1_weight"].asnumpy()
        left, step = None, 0
        while left != 0:
            left = exe.partial_forward(is_train=True, step=step)
            step += 1
        res["steps"] = np.array(step)
        res["partial"] = exe.outputs[0].asnumpy()
        exe.backward()
        res["partial_g"] = exe.grad_dict["fc1_weight"].asnumpy()
        res["past_end"] = np.array(exe.partial_forward(step=99))
        res["seen"] = np.array(len(seen))
        try:
            exe.partial_forward(step=2)
            res["order_refused"] = np.array(False)
        except M.MXNetError:
            res["order_refused"] = np.array(True)
        return res

    ref, got = _both(case)
    _close(ref, got)
    np.testing.assert_array_equal(got["partial"], got["full"])
    np.testing.assert_array_equal(got["partial_g"], got["full_g"])


def test_dropout_rate_scale_and_replay():
    """Dropout draws from the executor's chain: ~p of the values are
    zeroed, the rest scaled by 1/(1-p); a stepwise run and an
    explicit-head backward reproduce the forward's mask; eval is
    identity."""
    p = 0.3
    with mt.cpu():
        data = mt.sym.Variable("data")
        net = mt.sym.MakeLoss(mt.sym.sum(mt.sym.Dropout(data, p=p)))
        mt.random.seed(0)
        exe = net.simple_bind(mt.cpu(), data=(200, 100))
        exe.arg_dict["data"][:] = np.ones((200, 100), np.float32)
        exe.forward(is_train=True)
        inner = mt.sym.Dropout(mt.sym.Variable("data"), p=p).simple_bind(
            mt.cpu(), data=(200, 100))
        inner.arg_dict["data"][:] = 1.0
        out = inner.forward(is_train=True)[0].asnumpy()
        zero = float((out == 0).mean())
        assert abs(zero - p) < 0.01
        np.testing.assert_allclose(out[out != 0], 1 / (1 - p), rtol=1e-6)
        inner.backward([mt.nd.ones((200, 100))])
        g = inner.grad_dict["data"].asnumpy()
        np.testing.assert_array_equal(g == 0, out == 0)
        left, step = None, 0
        while left != 0:
            left = inner.partial_forward(is_train=True, step=step)
            step += 1
        again = inner.outputs[0].asnumpy()
        assert abs(float((again == 0).mean()) - p) < 0.01
        np.testing.assert_array_equal(
            inner.forward(is_train=False)[0].asnumpy(), 1.0)


def test_shared_exec_and_contexts():
    with mt.cpu():
        net = _mlp(mt)
        e1 = net.simple_bind(mt.cpu(), data=(4, 8), softmax_label=(4,))
        e2 = net.simple_bind(mt.cpu(), data=(2, 8), softmax_label=(2,),
                             shared_exec=e1)
        assert e2.arg_dict["fc1_weight"] is e1.arg_dict["fc1_weight"]
        assert e2.arg_dict["data"] is not e1.arg_dict["data"]
        other = _mlp(mt).simple_bind(mt.cpu(), data=(4, 5),
                                     softmax_label=(4,))
        with pytest.raises(mt.MXNetError, match="shared_exec holds"):
            net.simple_bind(mt.cpu(), data=(4, 8), softmax_label=(4,),
                            shared_exec=other)
        with mt.AttrScope(ctx_group="dev1"):
            fc = mt.sym.FullyConnected(mt.sym.Variable("data"),
                                       num_hidden=3, name="fc")
        with mt.AttrScope(ctx_group="dev2"):
            fc2 = mt.sym.FullyConnected(fc, num_hidden=2, name="fc2")
        net2 = mt.sym.MakeLoss(mt.sym.sum(fc2))
        # groups over one device run as one segment
        same = net2.simple_bind(mt.cpu(), data=(2, 4), group2ctx={
            "dev1": mt.cpu(), "dev2": mt.cpu()})
        same.forward(is_train=True)
        same.backward()
        # over distinct devices they raise (model parallelism, §A18)
        with pytest.raises(NotImplementedError, match="A18"):
            net2.simple_bind(mt.cpu(), data=(2, 4), group2ctx={
                "dev1": mt.cpu(0), "dev2": mt.cpu(1)})
        assert "FullyConnected fc(data[0]" in same.debug_str()


def test_bind_on_gpu_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the refusal is what is tested here")
    with mt.sym.NameManager():
        net = _mlp(mt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        net.simple_bind(mt.gpu(0), data=(4, 8), softmax_label=(4,))
