"""Random sampling operators: the port of ``mxnet_tpu/ops/sample.py``.

A sampler receives an ``RngKey`` from the executor or from
:func:`mxnet_tpu_torch.random.next_key` and draws from a
``torch.Generator`` seeded with it, on the key's device.
"""

from __future__ import annotations

import torch

from ..param import Params, field, tuple_of
from .op import register_simple_op


class UniformParam(Params):
    low = field(float, default=0.0)
    high = field(float, default=1.0)
    shape = field(tuple_of(int), default=None)


class NormalParam(Params):
    loc = field(float, default=0.0)
    scale = field(float, default=1.0)
    shape = field(tuple_of(int), default=None)


def _sample_shape(p, in_shapes):
    if p.shape is None:
        raise ValueError("sample op: shape required")
    return in_shapes, tuple(p.shape)


def _uniform(p, key=None):
    u = torch.rand(p.shape, generator=key.generator(), device=key.device)
    return p.low + (p.high - p.low) * u


def _normal(p, key=None):
    return p.loc + p.scale * torch.randn(p.shape, generator=key.generator(),
                                         device=key.device)


register_simple_op("_sample_uniform", _uniform, nin=0, param_cls=UniformParam,
                   shape_rule=_sample_shape, need_rng=True,
                   aliases=("uniform", "_random_uniform"))
register_simple_op("_sample_normal", _normal, nin=0, param_cls=NormalParam,
                   shape_rule=_sample_shape, need_rng=True,
                   aliases=("normal", "_random_normal"))
