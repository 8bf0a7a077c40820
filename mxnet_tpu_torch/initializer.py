"""Weight initializers, dispatched on the argument name.

The port of ``mxnet_tpu/initializer.py``'s ``Initializer.__call__`` name
rules (bias 0, gamma 1, beta 0, moving mean 0 / var 1, weight by the
subclass), ``Uniform`` and ``Xavier``.  Every draw takes an explicit
``torch.Generator`` and is made in float32 on the CPU, then copied into
the tensor, so the values depend on the generator's seed and not on the
device.  They differ from the reference's numpy draws; the
distributions are the same.
"""

from __future__ import annotations

import math

import torch

from .base import MXNetError

__all__ = ["Initializer", "Uniform", "Xavier"]


class Initializer:
    """``init(name, arr, generator)`` fills ``arr`` in place by the
    reference's name rules."""

    def __call__(self, name, arr, generator):
        with torch.no_grad():
            if name.startswith("upsampling"):
                raise NotImplementedError(
                    "bilinear upsampling init is not ported yet "
                    "(ROADMAP §A15)")
            if name.endswith("bias") or name.endswith("beta"):
                arr.fill_(0.0)
            elif name.endswith("gamma"):
                arr.fill_(1.0)
            elif name.endswith("weight"):
                self._init_weight(name, arr, generator)
            elif name.endswith("moving_mean") or name.endswith("moving_avg"):
                arr.fill_(0.0)
            elif name.endswith("moving_var"):
                arr.fill_(1.0)
            elif name.endswith("parameters"):
                # fused-RNN flat parameter vectors
                arr.copy_(_uniform(arr.shape, 0.07, generator))
            elif name.endswith("state") or name.endswith("state_cell"):
                arr.fill_(0.0)
            else:
                raise MXNetError(
                    f"Unknown initialization pattern for {name!r}; name an "
                    "initializer pattern (weight/bias/gamma/beta)")

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError


def _uniform(shape, scale, generator):
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return (u * 2.0 - 1.0) * scale


class Uniform(Initializer):
    """Weights uniform in [-scale, scale)."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, name, arr, generator):
        arr.copy_(_uniform(arr.shape, self.scale, generator))


class Xavier(Initializer):
    """Weights with variance scaled by fan-in/fan-out: scale =
    sqrt(magnitude / factor), factor the mean of the fans (``avg``),
    fan-in (``in``) or fan-out (``out``); uniform in [-scale, scale) or
    normal with standard deviation scale (``rnd_type="gaussian"``)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        if rnd_type not in ("uniform", "gaussian"):
            raise ValueError(f"Xavier: rnd_type must be uniform|gaussian "
                             f"(got {rnd_type!r})")
        if factor_type not in ("avg", "in", "out"):
            raise ValueError(f"Xavier: factor_type must be avg|in|out "
                             f"(got {factor_type!r})")
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr, generator):
        shape = tuple(arr.shape)
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = shape[1] * hw_scale if len(shape) > 1 else shape[0]
        fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr.copy_(_uniform(shape, scale, generator))
        else:
            arr.copy_(torch.randn(shape, generator=generator,
                                  dtype=torch.float32) * scale)
