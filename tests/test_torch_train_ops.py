"""Training-path operators of the PyTorch port against the JAX reference.

Each port op (``mxnet_tpu_torch.ops``: LayerNorm, RMSNorm, gelu, silu,
RoPE, FullyConnected, Embedding, SoftmaxOutput, SoftmaxCELoss) and the
reference op of the same name (its ``OpDef.forward``, differentiated by
``jax.vjp``, or its explicit ``backward`` for the loss heads) get the same
numpy inputs and head gradients; outputs and input gradients are held at
2e-6 in float32 (the same float32 arithmetic in another order).  The
loss heads' backward ignores the head gradient, as the reference's does,
unless ``out_grad``.

The initializers draw from a ``torch.Generator``, so their values differ
from the reference's numpy draws: the name rules are held exactly, the
distributions by their bounds and moments.
"""

import math

import numpy as np
import pytest
import torch

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

from mxnet_tpu_torch import initializer as port_init
from mxnet_tpu_torch import ops

TOL = 2e-6


def _ref_op(name, **kw):
    from mxnet_tpu.ops.op import OP_REGISTRY

    op = OP_REGISTRY.get(name)
    return op, op.make_params(kw)


def _ref_fwd_vjp(name, inputs, head, **kw):
    """Reference output and input gradients at head gradient ``head``."""
    import jax
    import jax.numpy as jnp

    op, params = _ref_op(name, **kw)
    args = [jnp.asarray(a) for a in inputs]
    out, vjp = jax.vjp(
        lambda *xs: op.forward(params, list(xs), [], True, None)[0][0], *args)
    grads = vjp(jnp.asarray(head))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_fwd_grad(fn, inputs, head, **kw):
    t = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*t, **kw)
    out.backward(torch.from_numpy(head))
    return out.detach().numpy(), [x.grad.numpy() for x in t]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("name,fn,n_params", [
    ("LayerNorm", ops.LayerNorm, 2),
    ("RMSNorm", ops.RMSNorm, 1),
])
def test_norms_match_reference(name, fn, n_params):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 16) * 3 + 1).astype(np.float32)
    inputs = [x] + [rng.randn(16).astype(np.float32)
                    for _ in range(n_params)]
    head = rng.randn(*x.shape).astype(np.float32)
    ref_out, ref_g = _ref_fwd_vjp(name, inputs, head)
    out, g = _port_fwd_grad(fn, inputs, head)
    _close(out, ref_out)
    for a, b in zip(g, ref_g):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("name", ["LayerNorm", "RMSNorm"])
def test_norms_keep_bf16_with_f32_statistics(name):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(4, 32).astype(np.float32) * 100)
    xb = x.to(torch.bfloat16)
    gamma = torch.ones(32)
    fn = getattr(ops, name)
    args = (gamma, torch.zeros(32)) if name == "LayerNorm" else (gamma,)
    y = fn(xb, *args)
    assert y.dtype == torch.bfloat16
    # statistics from the bf16 values in float32: one rounding at the end
    assert torch.equal(y, fn(xb.float(), *args).to(torch.bfloat16))


@pytest.mark.parametrize("name,fn", [("gelu", ops.gelu), ("silu", ops.silu)])
def test_activations_match_reference(name, fn):
    rng = np.random.RandomState(2)
    x = (rng.randn(6, 20) * 3).astype(np.float32)
    head = rng.randn(*x.shape).astype(np.float32)
    ref_out, ref_g = _ref_fwd_vjp(name, [x], head)
    out, g = _port_fwd_grad(fn, [x], head)
    _close(out, ref_out)
    _close(g[0], ref_g[0])


@pytest.mark.parametrize("layout,offset,base", [("bshd", 0, 10000.0),
                                                ("bhsd", 5, 500.0)])
def test_rope_matches_reference(layout, offset, base):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 3, 8).astype(np.float32)
    if layout == "bhsd":
        x = np.ascontiguousarray(x.transpose(0, 2, 1, 3))
    head = rng.randn(*x.shape).astype(np.float32)
    kw = dict(layout=layout, offset=offset, base=base)
    ref_out, ref_g = _ref_fwd_vjp("RoPE", [x], head, **kw)
    out, g = _port_fwd_grad(ops.RoPE, [x], head, **kw)
    _close(out, ref_out, 1e-5)
    _close(g[0], ref_g[0], 1e-5)


@pytest.mark.parametrize("no_bias", [False, True])
def test_fully_connected_matches_reference(no_bias):
    rng = np.random.RandomState(4)
    x = rng.randn(5, 3, 4).astype(np.float32)      # flattened to (5, 12)
    w = rng.randn(7, 12).astype(np.float32)
    inputs = [x, w] + ([] if no_bias else [rng.randn(7).astype(np.float32)])
    head = rng.randn(5, 7).astype(np.float32)
    ref_out, ref_g = _ref_fwd_vjp("FullyConnected", inputs, head,
                                  num_hidden=7, no_bias=no_bias)

    def fc(x, w, b=None):
        return ops.FullyConnected(x, w, b, num_hidden=7, no_bias=no_bias)

    out, g = _port_fwd_grad(fc, inputs, head)
    _close(out, ref_out, 1e-5)
    for a, b in zip(g, ref_g):
        _close(a, b, 1e-5)


def test_fully_connected_casts_weight_to_activations():
    x = torch.randn(2, 4).to(torch.bfloat16)
    y = ops.FullyConnected(x, torch.randn(3, 4), torch.randn(3))
    assert y.dtype == torch.bfloat16


def test_embedding_matches_reference_with_scatter_add_gradient():
    rng = np.random.RandomState(5)
    ids = np.array([[1, 3, 1], [0, 3, 3]], np.int32)   # repeats: summed
    w = rng.randn(6, 4).astype(np.float32)
    head = rng.randn(2, 3, 4).astype(np.float32)
    import jax
    import jax.numpy as jnp

    op, params = _ref_op("Embedding", input_dim=6, output_dim=4)
    ref_out, vjp = jax.vjp(lambda t: op.forward(
        params, [jnp.asarray(ids), t], [], True, None)[0][0], jnp.asarray(w))
    (ref_gw,) = vjp(jnp.asarray(head))
    tw = torch.from_numpy(w).requires_grad_()
    out = ops.Embedding(torch.from_numpy(ids), tw, input_dim=6, output_dim=4)
    out.backward(torch.from_numpy(head))
    _close(out.detach().numpy(), np.asarray(ref_out))
    _close(tw.grad.numpy(), np.asarray(ref_gw))
    assert ops.Embedding(torch.from_numpy(ids),
                         tw.detach().bfloat16()).dtype == torch.bfloat16


def _loss_case(seed, use_ignore):
    rng = np.random.RandomState(seed)
    x = (rng.randn(8, 11) * 2).astype(np.float32)
    lab = rng.randint(0, 11, (8,)).astype(np.int32)
    if use_ignore:
        lab[[1, 5]] = -1
    head = rng.randn(8, 11).astype(np.float32)
    return x, lab, head


def _ref_loss(name, x, lab, head, **kw):
    import jax.numpy as jnp

    op, params = _ref_op(name, **kw)
    inputs = [jnp.asarray(x), jnp.asarray(lab)]
    out = op.forward(params, inputs, [], True, None)[0][0]
    grad = op.backward(params, [jnp.asarray(head)], inputs, [out])[0]
    return np.asarray(out), np.asarray(grad)


def _port_loss(fn, x, lab, head, **kw):
    tx = torch.from_numpy(x).requires_grad_()
    out = fn(tx, torch.from_numpy(lab), **kw)
    out.backward(torch.from_numpy(head))
    return out.detach().numpy(), tx.grad.numpy()


@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
@pytest.mark.parametrize("use_ignore", [False, True])
@pytest.mark.parametrize("out_grad", [False, True])
def test_softmax_output_matches_reference(normalization, use_ignore,
                                          out_grad):
    x, lab, head = _loss_case(6, use_ignore)
    kw = dict(normalization=normalization, use_ignore=use_ignore,
              out_grad=out_grad, grad_scale=0.5)
    ref_out, ref_g = _ref_loss("SoftmaxOutput", x, lab, head, **kw)
    out, g = _port_loss(ops.SoftmaxOutput, x, lab, head, **kw)
    _close(out, ref_out)
    _close(g, ref_g)


@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
@pytest.mark.parametrize("use_ignore", [False, True])
def test_softmax_ce_loss_matches_reference(normalization, use_ignore):
    x, lab, head = _loss_case(7, use_ignore)
    head = head[:, 0].copy()
    kw = dict(normalization=normalization, use_ignore=use_ignore,
              grad_scale=2.0)
    ref_out, ref_g = _ref_loss("SoftmaxCELoss", x, lab, head, **kw)
    out, g = _port_loss(ops.SoftmaxCELoss, x, lab, head, **kw)
    _close(out, ref_out)
    _close(g, ref_g)


def test_loss_heads_ignore_the_head_gradient_by_default():
    x, lab, head = _loss_case(8, False)
    _, g1 = _port_loss(ops.SoftmaxOutput, x, lab, head)
    _, g2 = _port_loss(ops.SoftmaxOutput, x, lab, np.ones_like(head))
    np.testing.assert_array_equal(g1, g2)
    # multi_output (softmax over axis 1 of (n, c, d)) holds the same
    # contract, and matches the reference in every normalization
    rng = np.random.RandomState(9)
    xm = rng.randn(4, 5, 3).astype(np.float32)
    labm = rng.randint(0, 5, (4, 3)).astype(np.int32)
    labm[0, 1] = -1
    headm = rng.randn(4, 5, 3).astype(np.float32)
    for norm in ("null", "batch", "valid"):
        kw = dict(multi_output=True, use_ignore=True, normalization=norm)
        ref_out, ref_g = _ref_loss("SoftmaxOutput", xm, labm, headm, **kw)
        out, g = _port_loss(ops.SoftmaxOutput, xm, labm, headm, **kw)
        _, g_ones = _port_loss(ops.SoftmaxOutput, xm, labm,
                               np.ones_like(headm), **kw)
        _close(out, ref_out)
        _close(g, ref_g)
        np.testing.assert_array_equal(g, g_ones)


# -- initializers -----------------------------------------------------------
def test_initializer_name_rules_match_reference():
    import mxnet_tpu as mx

    gen = torch.Generator().manual_seed(0)
    for name in ("fc_bias", "ln_gamma", "ln_beta", "bn_moving_mean",
                 "bn_moving_var"):
        ref = mx.nd.zeros((3,)) + 7
        mx.initializer.Uniform(0.07)(name, ref)
        got = torch.full((3,), 7.0)
        port_init.Uniform(0.07)(name, got, gen)
        np.testing.assert_array_equal(got.numpy(), ref.asnumpy())
    with pytest.raises(Exception, match="Unknown initialization"):
        port_init.Uniform()("mystery", torch.zeros(2), gen)


@pytest.mark.parametrize("shape", [(256, 128), (64, 16, 3, 3), (1, 32, 64)])
@pytest.mark.parametrize("rnd_type,factor_type", [
    ("uniform", "avg"), ("gaussian", "in"), ("uniform", "out")])
def test_xavier_bounds_and_moments(shape, rnd_type, factor_type):
    gen = torch.Generator().manual_seed(1)
    arr = torch.empty(shape)
    port_init.Xavier(rnd_type, factor_type, magnitude=2.5)("w_weight", arr,
                                                           gen)
    hw = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_in, fan_out = shape[1] * hw, shape[0] * hw
    factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
              "out": fan_out}[factor_type]
    scale = math.sqrt(2.5 / factor)
    std = scale / math.sqrt(3) if rnd_type == "uniform" else scale
    a = arr.numpy().astype(np.float64)
    n = a.size
    if rnd_type == "uniform":
        assert a.min() >= -scale and a.max() < scale
    assert abs(a.mean()) < 5 * std / math.sqrt(n)
    assert abs(a.std() / std - 1) < 5 * math.sqrt(2 / n) + 0.01


def test_uniform_default_scale_bounds_and_reproducibility():
    a = torch.empty(4000)
    port_init.Uniform()("x_weight", a, torch.Generator().manual_seed(3))
    b = torch.empty(4000)
    port_init.Uniform()("x_weight", b, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert float(a.abs().max()) <= 0.07 and float(a.std()) > 0.035
