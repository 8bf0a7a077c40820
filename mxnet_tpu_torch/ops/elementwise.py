"""Elementwise unary / binary / scalar / broadcast operators.

The port of ``mxnet_tpu/ops/elementwise.py``: each registration yields
both an imperative NDArray function and a Symbol op, as in the
reference's MXNET_REGISTER_SIMPLE_OP pattern, with torch expressions for
its jnp ones.
"""

from __future__ import annotations

import torch

from ..param import Params, field
from .op import OpDef, register_op, register_simple_op


class ScalarParam(Params):
    """Scalar operand for *_scalar ops (operator_util.h scalar ops)."""

    scalar = field(float, required=True, doc="scalar operand")


def _unary(name, fn, aliases=()):
    register_simple_op(name, fn, nin=1, aliases=aliases)


def _binary(name, fn, aliases=()):
    register_simple_op(name, fn, nin=2, shape_rule="broadcast", aliases=aliases)


def _scalar(name, fn):
    register_simple_op(name, fn, nin=1, param_cls=ScalarParam)


def _same(fn):
    """A comparison whose result keeps the inputs' dtype (the
    reference's convention)."""
    return lambda a, b: fn(a, b).to(a.dtype)


def _same_scalar(fn):
    return lambda p, x: fn(x, p.scalar).to(x.dtype)


# -- unary (mshadow_op.h functors) ------------------------------------------
_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("round", torch.round)
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("square", torch.square)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", lambda x: 1.0 / torch.sqrt(x))
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("cos", torch.cos)
_unary("sin", torch.sin)
_unary("tanh", torch.tanh)
_unary("sigmoid", lambda x: 1.0 / (1.0 + torch.exp(-x)))
_unary("relu", lambda x: torch.clamp_min(x, 0))
_unary("negative", lambda x: -x, aliases=("_mul_scalar_neg",))
_unary("_copy", lambda x: x)
_unary("gamma", lambda x: torch.exp(torch.lgamma(x)))
_unary("gammaln", torch.lgamma)
_unary("log1p", torch.log1p)
_unary("expm1", torch.expm1)

# -- binary (same-shape in the reference; both broadcast) --------------------
_binary("_plus", torch.add, aliases=("elemwise_add", "_add"))
_binary("_minus", torch.subtract, aliases=("elemwise_sub", "_sub"))
_binary("_mul", torch.multiply, aliases=("elemwise_mul",))
_binary("_div", torch.divide, aliases=("elemwise_div",))
_binary("_power", torch.pow, aliases=("pow",))
_binary("_maximum", torch.maximum)
_binary("_minimum", torch.minimum)
_binary("_hypot", torch.hypot)

# comparison family (returns same dtype as inputs, like the reference)
_binary("_equal", _same(torch.eq))
_binary("_not_equal", _same(torch.ne))
_binary("_greater", _same(torch.gt))
_binary("_greater_equal", _same(torch.ge))
_binary("_lesser", _same(torch.lt))
_binary("_lesser_equal", _same(torch.le))

# -- broadcast_* explicit family (elementwise_binary_broadcast_op.cc) --------
_binary("broadcast_plus", torch.add, aliases=("broadcast_add",))
_binary("broadcast_minus", torch.subtract, aliases=("broadcast_sub",))
_binary("broadcast_mul", torch.multiply)
_binary("broadcast_div", torch.divide)
_binary("broadcast_power", torch.pow)
_binary("broadcast_maximum", torch.maximum)
_binary("broadcast_minimum", torch.minimum)

# -- scalar variants ---------------------------------------------------------
_scalar("_plus_scalar", lambda p, x: x + p.scalar)
_scalar("_minus_scalar", lambda p, x: x - p.scalar)
_scalar("_rminus_scalar", lambda p, x: p.scalar - x)
_scalar("_mul_scalar", lambda p, x: x * p.scalar)
_scalar("_div_scalar", lambda p, x: x / p.scalar)
_scalar("_rdiv_scalar", lambda p, x: p.scalar / x)
_scalar("_power_scalar", lambda p, x: x**p.scalar)
_scalar("_rpower_scalar", lambda p, x: p.scalar**x)
_scalar("_maximum_scalar", lambda p, x: torch.clamp_min(x, p.scalar))
_scalar("_minimum_scalar", lambda p, x: torch.clamp_max(x, p.scalar))
_scalar("_equal_scalar", _same_scalar(torch.eq))
_scalar("_not_equal_scalar", _same_scalar(torch.ne))
_scalar("_greater_scalar", _same_scalar(torch.gt))
_scalar("_greater_equal_scalar", _same_scalar(torch.ge))
_scalar("_lesser_scalar", _same_scalar(torch.lt))
_scalar("_lesser_equal_scalar", _same_scalar(torch.le))


class ElementWiseSumParam(Params):
    num_args = field(int, required=True, lower=1, doc="number of summands")


@register_op("ElementWiseSum", aliases=("add_n", "element_wise_sum"))
class ElementWiseSumOp(OpDef):
    """Variadic sum (src/operator/elementwise_sum-inl.h)."""

    key_var_num_args = "num_args"

    param_cls = ElementWiseSumParam

    def list_arguments(self, params):
        return [f"arg{i}" for i in range(params.num_args)]

    def infer_shape(self, params, in_shapes):
        known = next((s for s in in_shapes if s is not None), None)
        if known is None:
            raise ValueError("ElementWiseSum: no input shape known")
        for s in in_shapes:
            if s is not None and tuple(s) != tuple(known):
                raise ValueError(
                    f"ElementWiseSum: all inputs must share one shape, "
                    f"got {tuple(s)} vs {tuple(known)}")
        return [known if s is None else s for s in in_shapes], [tuple(known)], []

    def forward(self, params, inputs, aux, train, key):
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        return [out], []


def _element_mask(lhs, rhs):
    return lhs * rhs.reshape((rhs.shape[0],) + (1,) * (lhs.dim() - 1)).to(lhs.dtype)


def _element_mask_shape(params, in_shapes):
    lhs, rhs = in_shapes
    if lhs is None:
        raise ValueError("element_mask: lhs shape unknown")
    if len(lhs) < 2 or (rhs is not None and (len(rhs) != 1 or rhs[0] != lhs[0])):
        raise ValueError("element_mask: lhs must be >=2D, rhs 1D with matching dim0")
    return [lhs, (lhs[0],)], tuple(lhs)


def _element_mask_backward(params, out_grads, inputs, outputs):
    # the mask is not differentiated (broadcast_mask_op-inl.h writes only
    # lhs_grad)
    og = out_grads[0]
    return [_element_mask(og, inputs[1]), torch.zeros_like(inputs[1])]


register_simple_op("element_mask", _element_mask, nin=2,
                   shape_rule=_element_mask_shape,
                   backward_fn=_element_mask_backward)


class SmoothL1Param(Params):
    sigma = field(float, default=1.0, doc="transition point scale")


def _smooth_l1(p, x):
    s2 = p.sigma * p.sigma
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * x * x, absx - 0.5 / s2)


register_simple_op("smooth_l1", _smooth_l1, nin=1, param_cls=SmoothL1Param)


class ClipParam(Params):
    a_min = field(float, required=True)
    a_max = field(float, required=True)


register_simple_op("clip", lambda p, x: torch.clamp(x, p.a_min, p.a_max), nin=1,
                   param_cls=ClipParam)
