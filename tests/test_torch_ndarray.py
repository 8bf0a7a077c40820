"""The port's NDArray (``mxnet_tpu_torch.ndarray``) against the reference's.

Each case of the reference's ``tests/test_ndarray.py`` runs in both
packages on the same numpy inputs (drawn from a seeded RandomState) under
a CPU context, and the results are held equal: exactly for copies,
creation, indexing, comparisons and integer ops, within 1e-6 relative
(float32 arithmetic in another order) for the rest.  ``save``/``load``
files cross between the packages in both directions, bfloat16 included
(the reference's ``__bf16__:`` uint16 encoding).  Random draws are held
by their statistics, since the two generators differ.
"""

import pickle

import numpy as np
import pytest
import torch

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)
from torch_port_fixtures import (  # noqa: F401
    collect_engines_after_module)  # (autouse)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

RTOL = 1e-6


def _both(case):
    """``case(M)`` in each package under its CPU context: (ref, port)
    as numpy values (lists of them stay lists)."""
    out = []
    for M in (mx, mt):
        with M.cpu():
            r = case(M)
        out.append([x.asnumpy() for x in r] if isinstance(r, list)
                   else r.asnumpy() if hasattr(r, "asnumpy") else r)
    return out


def _close(ref, got, rtol=RTOL, atol=0.0):
    if isinstance(ref, list):
        assert len(ref) == len(got)
        for a, b in zip(ref, got):
            _close(a, b, rtol, atol)
        return
    got = np.asarray(got)
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


_RS = np.random.RandomState(0)
X = _RS.randn(4, 5).astype(np.float32)
Y = (_RS.rand(4, 5) + 0.5).astype(np.float32)
X3 = _RS.rand(2, 3, 4).astype(np.float32)

ELEMENTWISE = {
    "add": lambda M, a, b: a + b,
    "sub": lambda M, a, b: a - b,
    "mul": lambda M, a, b: a * b,
    "div": lambda M, a, b: a / b,
    "add_scalar": lambda M, a, b: a + 2,
    "rsub_scalar": lambda M, a, b: 2 - a,
    "div_scalar": lambda M, a, b: a / 2,
    "rdiv_scalar": lambda M, a, b: 2 / b,
    "neg": lambda M, a, b: -a,
    "pow_scalar": lambda M, a, b: b ** 2.5,
    "sqrt": lambda M, a, b: M.nd.sqrt(b),
    "square": lambda M, a, b: M.nd.square(a),
    "exp": lambda M, a, b: M.nd.exp(a),
    "log": lambda M, a, b: M.nd.log(b),
    "tanh": lambda M, a, b: M.nd.tanh(a),
    "sigmoid": lambda M, a, b: M.nd.sigmoid(a),
    "relu": lambda M, a, b: M.nd.relu(a),
    "abs": lambda M, a, b: M.nd.abs(a),
    "maximum": lambda M, a, b: M.nd.maximum(a, b),
    "minimum_scalar": lambda M, a, b: M.nd.minimum(a, 0.5),
    "power": lambda M, a, b: M.nd.power(b, a),
    "broadcast_plus": lambda M, a, b: M.nd.broadcast_plus(a, b[:1]),
    "clip": lambda M, a, b: M.nd.clip(a, a_min=-0.5, a_max=0.5),
    "smooth_l1": lambda M, a, b: M.nd.smooth_l1(a, sigma=2.0),
    "gammaln": lambda M, a, b: M.nd.gammaln(b),
    "gt": lambda M, a, b: a > b,
    "eq_scalar": lambda M, a, b: M.nd.round(a) == 0,
    "le_scalar": lambda M, a, b: a <= 0.1,
}


@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_elementwise_matches_reference(name):
    fn = ELEMENTWISE[name]
    ref, got = _both(lambda M: fn(M, M.nd.array(X), M.nd.array(Y)))
    # torch.lgamma and jax's gammaln are two float32 approximations:
    # within 2e-6 absolute of each other near its zeros
    _close(ref, got, rtol=2e-6, atol=2e-6 if name == "gammaln" else 0.0)


def test_creation_matches_reference():
    def case(M):
        a = M.nd.zeros((3, 4))
        b = M.nd.ones((2, 2), dtype="float64")
        c = M.nd.full((2,), 7.0)
        d = M.nd.array([[1, 2], [3, 4]])
        e = M.nd.arange(0, 6, 2)
        f = M.nd.array(np.arange(6, dtype=np.int32))
        return [a, b, c, d, e, f], [str(x.dtype) for x in (a, b, c, d, e, f)]

    with mx.cpu():
        r, ref_dt = case(mx)
        ref = [x.asnumpy() for x in r]
    with mt.cpu():
        p, got_dt = case(mt)
        got = [x.asnumpy() for x in p]
    assert ref_dt == got_dt
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)


def test_inplace_and_setitem_match_reference():
    def case(M):
        a = M.nd.ones((2, 3))
        a += 2
        a *= 2
        a -= 1
        a /= 5
        b = M.nd.zeros((3, 4))
        b[:] = 2.5
        b[1] = 1.0
        b[0:2] = 0.0
        c = M.nd.zeros((3, 4))
        c[:] = np.arange(12).reshape(3, 4)
        d = M.nd.zeros((2, 3))
        d[:] = M.nd.array(np.ones((1, 3), np.float32) * 4)
        return [a, b, c, d]

    ref, got = _both(case)
    _close(ref, got, rtol=0)


def test_slicing_reshape_transpose_match_reference():
    x = np.arange(24).reshape(4, 6).astype(np.float32)

    def case(M):
        a = M.nd.array(x)
        return [a[1], a[1:3], a.reshape((6, 4)), a.T,
                M.nd.transpose(a, axes=(1, 0)), a.broadcast_to((4, 6)),
                M.nd.array([[1.0], [2.0]]).broadcast_to((2, 3)),
                M.nd.Reshape(a, shape=(-1, 0, 2), reverse=False),
                M.nd.slice_axis(a, axis=1, begin=1, end=4),
                M.nd.SwapAxis(M.nd.array(X3), dim1=0, dim2=2),
                M.nd.expand_dims(a, axis=1), M.nd.flip(a, axis=0),
                M.nd.Concat(a, a, dim=0), M.nd.tile(a, reps=(2, 1)),
                M.nd.one_hot(M.nd.array([1, 0, 3]), depth=4)]

    ref, got = _both(case)
    _close(ref, got, rtol=0)
    with mt.cpu():
        assert mt.nd.array(x)[2, 3].asscalar() == x[2, 3]
        with pytest.raises(ValueError):
            mt.nd.array([[1.0], [2.0]]).broadcast_to((3, 3))


def test_dot_and_reduce_match_reference():
    a2 = _RS.rand(3, 4).astype(np.float32)
    b2 = _RS.rand(4, 5).astype(np.float32)
    b3 = _RS.rand(2, 4, 3).astype(np.float32)

    def case(M):
        a = M.nd.array(X3)
        return [M.nd.dot(M.nd.array(a2), M.nd.array(b2)),
                M.nd.dot(M.nd.array(b2), M.nd.array(a2), transpose_a=True,
                         transpose_b=True),
                M.nd.batch_dot(M.nd.array(X3), M.nd.array(b3)),
                M.nd.sum(a), M.nd.sum(a, axis=(1,)),
                M.nd.max(a, axis=(0, 2)), M.nd.mean(a, axis=(2,),
                                                    keepdims=True),
                M.nd.min(a), M.nd.prod(a, axis=(1,)), M.nd.norm(a),
                M.nd.argmax(a, axis=2), M.nd.argmax_channel(a),
                M.nd.broadcast_axis(M.nd.array(X3[:, :1]), axis=(1,),
                                    size=(3,))]

    ref, got = _both(case)
    _close(ref, got, rtol=2e-6)


def test_copy_and_context():
    with mt.cpu():
        a = mt.nd.array(_RS.rand(3, 3))
        b = a.copy()
        b[:] = 0
        assert not (a.asnumpy() == 0).all()
        c = mt.nd.zeros((3, 3))
        a.copyto(c)
        np.testing.assert_array_equal(a.asnumpy(), c.asnumpy())
        d = a.copyto(mt.cpu(1))
        assert d.context == mt.cpu(1) and a.as_in_context(mt.cpu()) is a
        np.testing.assert_array_equal(d.asnumpy(), a.asnumpy())
        # arrays on distinct contexts do not mix, as in the reference
        with pytest.raises(mt.MXNetError):
            _ = d + a
        e = pickle.loads(pickle.dumps(a))
        np.testing.assert_array_equal(e.asnumpy(), a.asnumpy())
    assert mt.current_context() == mt.gpu(0)


def test_save_load_cross_both_ways(tmp_path):
    data = [_RS.rand(3, 3).astype(np.float32) for _ in range(3)]
    for src, dst in ((mx, mt), (mt, mx)):
        with src.cpu():
            f = str(tmp_path / f"{src.__name__}.npz")
            src.nd.save(f, [src.nd.array(a) for a in data])
            src.nd.save(f + ".d", {"w": src.nd.array(data[0]),
                                    "i": src.nd.array(np.arange(4,
                                                                dtype=np.int32))})
        with dst.cpu():
            got = dst.nd.load(f)
            got_d = dst.nd.load(f + ".d")
        assert len(got) == 3
        for a, b in zip(data, got):
            np.testing.assert_array_equal(b.asnumpy(), a)
        assert set(got_d) == {"w", "i"}
        np.testing.assert_array_equal(got_d["w"].asnumpy(), data[0])
        assert str(got_d["i"].dtype) == "int32"


def test_bf16_save_load_cross_both_ways(tmp_path):
    x = _RS.rand(4, 4).astype(np.float32)
    with mx.cpu():
        ref = mx.nd.array(x, dtype="bfloat16")
        mx.nd.save(str(tmp_path / "ref.npz"), {"a": ref})
        ref_bits = np.asarray(ref.asnumpy()).view(np.uint16)
    with mt.cpu():
        got = mt.nd.load(str(tmp_path / "ref.npz"))["a"]
        assert got._data.dtype == torch.bfloat16
        assert mt.base.dtype_name(got.dtype) == "bfloat16"
        np.testing.assert_array_equal(
            got._data.view(torch.int16).numpy().view(np.uint16), ref_bits)
        mine = mt.nd.array(x, dtype="bfloat16")
        mt.nd.save(str(tmp_path / "port.npz"), {"a": mine})
        # asnumpy of bfloat16 is float32 holding the same values
        np.testing.assert_array_equal(got.asnumpy(),
                                      got.astype("float32").asnumpy())
    with mx.cpu():
        back = mx.nd.load(str(tmp_path / "port.npz"))["a"]
        assert back.dtype == mx.base.np_dtype("bfloat16")
        np.testing.assert_array_equal(np.asarray(back.asnumpy()).view(
            np.uint16), ref_bits)


def test_onehot_choose_fill_match_reference():
    lhs_v = [[1., 2., 3.], [4., 5., 6.], [7., 8., 9.]]

    def case(M):
        out = M.nd.zeros((3, 3))
        M.nd.onehot_encode(M.nd.array([1, 0, 2]), out)
        lhs = M.nd.array(lhs_v)
        rhs = M.nd.array([2, 0, 1])
        vals = M.nd.array([-1., -2., -3.])
        picked = M.nd.choose_element_0index(lhs, rhs)
        filled = M.nd.fill_element_0index(lhs, vals, rhs)
        untouched = lhs.copy()
        M.nd.fill_element_0index(lhs, vals, rhs, out=lhs)
        return [out, picked, filled, untouched, lhs]

    ref, got = _both(case)
    _close(ref, got, rtol=0)


def test_samplers_draw_by_statistics():
    """Different generators: the port's draws are held by their moments
    and its seeding by reproducibility."""
    with mt.cpu():
        mt.random.seed(42)
        u = mt.random.uniform(0, 1, shape=(4000,)).asnumpy()
        n = mt.random.normal(0, 1, shape=(4000,)).asnumpy()
        mt.random.seed(42)
        u2 = mt.random.uniform(0, 1, shape=(4000,)).asnumpy()
    np.testing.assert_array_equal(u, u2)
    assert 0.0 <= u.min() and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.02 and abs(u.var() - 1 / 12) < 0.01
    assert abs(n.mean()) < 0.06 and abs(n.std() - 1.0) < 0.05


def test_gpu_context_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the refusal is what is tested here")
    for ctx in (mt.gpu(0), mt.tpu(0)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mt.nd.zeros((2,), ctx=ctx)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mt.nd.zeros((2,))          # the default context is gpu(0)


def test_custom_waits_for_a15b():
    """``Custom`` is ported: an unregistered ``op_type`` raises as the
    reference's does (test_torch_custom_op.py drives registered ones),
    and so does a call without one."""
    for M in (mt, mx):
        with pytest.raises(M.MXNetError, match="not registered"):
            M.nd.Custom(op_type="anything")
        with pytest.raises(M.MXNetError, match="not registered"):
            M.sym.Custom(op_type="anything")
        with pytest.raises(TypeError, match="op_type"):
            M.nd.Custom(mt.nd.zeros((1,), ctx=mt.cpu()))
