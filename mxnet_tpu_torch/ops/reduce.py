"""Reduction operators: the port of ``mxnet_tpu/ops/reduce.py``."""

from __future__ import annotations

import torch

from ..param import Params, field, tuple_of
from .op import register_simple_op


class ReduceAxisParam(Params):
    axis = field(tuple_of(int), default=None, doc="axes to reduce; None = all")
    keepdims = field(bool, default=False)


def _reduce_shape(params, in_shapes):
    shp = in_shapes[0]
    if shp is None:
        raise ValueError("reduce: input shape unknown")
    axis = params.axis
    if axis is None:
        out = (1,) if params.keepdims else ()
        return in_shapes, out if out else (1,)
    axis = tuple(a % len(shp) for a in axis)
    if params.keepdims:
        out = tuple(1 if i in axis else d for i, d in enumerate(shp))
    else:
        out = tuple(d for i, d in enumerate(shp) if i not in axis)
        out = out if out else (1,)
    return in_shapes, out


def _all_axes(x, axis):
    return tuple(range(x.dim())) if axis is None else tuple(axis)


def _amax(x, dim, keepdim):
    return torch.amax(x, dim=dim, keepdim=keepdim)


def _amin(x, dim, keepdim):
    return torch.amin(x, dim=dim, keepdim=keepdim)


def _prod(x, dim, keepdim):
    for d in sorted((a % x.dim() for a in dim), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _make_reduce(name, tfn, aliases=()):
    def fn(p, x):
        out = tfn(x, _all_axes(x, p.axis), p.keepdims)
        if out.dim() == 0:
            out = out.reshape(1)
        return out

    register_simple_op(name, fn, nin=1, param_cls=ReduceAxisParam,
                       shape_rule=_reduce_shape, aliases=aliases)


_make_reduce("sum", lambda x, d, k: torch.sum(x, dim=d, keepdim=k),
             aliases=("sum_axis",))
_make_reduce("max", _amax, aliases=("max_axis",))
_make_reduce("min", _amin, aliases=("min_axis",))
_make_reduce("mean", lambda x, d, k: torch.mean(x, dim=d, keepdim=k))
_make_reduce("prod", _prod)


def _norm_fn(x):
    return torch.sqrt(torch.sum(torch.square(x))).reshape(1)


register_simple_op("norm", _norm_fn, nin=1,
                   shape_rule=lambda p, s: (s, (1,)))


class ArgmaxParam(Params):
    axis = field(int, default=None, doc="axis; None reduces all")
    keepdims = field(bool, default=False)


def _arg_shape(params, in_shapes):
    shp = in_shapes[0]
    if params.axis is None:
        return in_shapes, (1,)
    ax = params.axis % len(shp)
    if params.keepdims:
        return in_shapes, tuple(1 if i == ax else d for i, d in enumerate(shp))
    out = tuple(d for i, d in enumerate(shp) if i != ax)
    return in_shapes, out if out else (1,)


def _make_arg(name, tfn):
    def fn(p, x):
        if p.axis is None:
            out = tfn(x.reshape(-1), dim=0)
            if p.keepdims:
                out = out.reshape((1,) * x.dim())
        else:
            out = tfn(x, dim=p.axis, keepdim=p.keepdims)
        out = out.to(x.dtype)
        if out.dim() == 0:
            out = out.reshape(1)
        return out

    register_simple_op(name, fn, nin=1, param_cls=ArgmaxParam, shape_rule=_arg_shape)


_make_arg("argmax", torch.argmax)
_make_arg("argmin", torch.argmin)


def _argmax_channel(x):
    """argmax over axis 1 (reference argmax_channel, broadcast_reduce_op)."""
    return torch.argmax(x, dim=1).to(x.dtype)


register_simple_op("argmax_channel", _argmax_channel, nin=1,
                   shape_rule=lambda p, s: (s, (s[0][0],) + tuple(s[0][2:])))


class BroadcastAxisParam(Params):
    axis = field(tuple_of(int), default=(), doc="axes to broadcast (must be size 1)")
    size = field(tuple_of(int), default=(), doc="target sizes per axis")


def _broadcast_axis_shape(params, in_shapes):
    shp = in_shapes[0]
    if shp is None:
        raise ValueError("broadcast_axis: input shape unknown")
    if len(params.axis) != len(params.size):
        raise ValueError("broadcast_axis: axis and size must have equal length")
    out = list(shp)
    for ax, sz in zip(params.axis, params.size):
        ax = ax % len(out)
        if out[ax] != 1:
            raise ValueError(f"broadcast_axis: axis {ax} has size {out[ax]}, "
                             "can only broadcast size-1 axes")
        out[ax] = sz
    return in_shapes, tuple(out)


def _broadcast_axis(p, x):
    out = list(x.shape)
    for ax, sz in zip(p.axis, p.size):
        out[ax % x.dim()] = sz
    return torch.broadcast_to(x, tuple(out))


register_simple_op("broadcast_axis", _broadcast_axis, nin=1,
                   param_cls=BroadcastAxisParam, shape_rule=_broadcast_axis_shape)


class BroadcastToParam(Params):
    shape = field(tuple_of(int), required=True,
                  doc="target shape; 0 keeps the input size on that axis")


def _broadcast_to_shape(params, in_shapes):
    shp = in_shapes[0]
    if shp is None:
        raise ValueError("broadcast_to: input shape unknown")
    if len(params.shape) != len(shp):
        raise ValueError("broadcast_to: shape ndim mismatch")
    out = tuple(d if t == 0 else t for d, t in zip(shp, params.shape))
    for d, t in zip(shp, out):
        if d != t and d != 1:
            raise ValueError(f"broadcast_to: cannot broadcast {shp} to {out}")
    return in_shapes, out


def _broadcast_to(p, x):
    out = tuple(d if t == 0 else t for d, t in zip(x.shape, p.shape))
    return torch.broadcast_to(x, out)


register_simple_op("broadcast_to", _broadcast_to, nin=1,
                   param_cls=BroadcastToParam, shape_rule=_broadcast_to_shape)
