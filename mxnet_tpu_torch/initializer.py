"""Weight initializers: the port of ``mxnet_tpu/initializer.py``.

An initializer is called with ``(name, arr)`` and dispatches on the
argument name (upsampling -> bilinear, bias 0, gamma 1, beta 0, moving
mean 0 / var 1, weight by the subclass, fused-RNN ``parameters`` small
uniform, RNN states 0), as the reference's ``__call__`` does.  ``arr``
is either

- an :class:`~mxnet_tpu_torch.ndarray.NDArray` (the Module path): values
  are drawn with numpy from ``generator`` (a ``numpy.random.RandomState``)
  or, by default, from :func:`mxnet_tpu_torch.random.np_rng`, the port's
  own RandomState that ``mx.random.seed`` seeds.  The draws are the
  reference's, call for call, so one seed gives both packages the same
  initial values;
- a ``torch.Tensor`` (``parallel.ShardedTrainer``'s path): values are
  drawn in float32 on the CPU from ``generator``, a ``torch.Generator``.

``Load``, ``Mixed`` and the registry (:func:`init`) are the reference's.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from .base import MXNetError
from .registry import Registry

__all__ = ["Initializer", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Bilinear", "Load", "Mixed", "One", "Zero",
           "Constant", "init"]

_INIT_REGISTRY = Registry("initializer")


class _NumpyDraw:
    """Draws of the reference's numpy calls, from one RandomState."""

    def __init__(self, rs):
        self.rs = rs

    def sym_uniform(self, scale, shape):
        return self.rs.uniform(-scale, scale, shape)

    def uniform(self, low, high, shape):
        return self.rs.uniform(low, high, shape)

    def normal(self, sigma, shape):
        return self.rs.normal(0, sigma, shape)


class _TorchDraw:
    """Float32 draws on the CPU from one ``torch.Generator``."""

    def __init__(self, gen):
        self.gen = gen

    def sym_uniform(self, scale, shape):
        u = torch.rand(tuple(shape), generator=self.gen, dtype=torch.float32)
        return (u * 2.0 - 1.0) * scale

    def uniform(self, low, high, shape):
        u = torch.rand(tuple(shape), generator=self.gen, dtype=torch.float32)
        return low + (high - low) * u

    def normal(self, sigma, shape):
        return torch.randn(tuple(shape), generator=self.gen,
                           dtype=torch.float32) * sigma


def _assign(arr, value):
    """``arr[:] = value`` for an NDArray or a tensor."""
    if isinstance(arr, torch.Tensor):
        with torch.no_grad():
            if isinstance(value, (int, float)):
                arr.fill_(value)
            else:
                arr.copy_(torch.as_tensor(value).reshape(arr.shape))
    else:
        arr[:] = value


def _draw_for(arr, generator):
    if isinstance(arr, torch.Tensor):
        if generator is None:
            raise ValueError("initializing a tensor needs a torch.Generator")
        return _TorchDraw(generator)
    if generator is None:
        from .random import np_rng
        generator = np_rng()
    return _NumpyDraw(generator)


class Initializer:
    """``init(name, arr[, generator])`` fills ``arr`` in place by the
    reference's name rules."""

    def __call__(self, name, arr, generator=None):
        self._draw = _draw_for(arr, generator)
        if name.startswith("upsampling"):
            self._init_bilinear(name, arr)
        elif name.endswith("bias"):
            self._init_bias(name, arr)
        elif name.endswith("gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("beta"):
            self._init_beta(name, arr)
        elif name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("moving_mean") or name.endswith("moving_avg"):
            self._init_zero(name, arr)
        elif name.endswith("moving_var"):
            self._init_one(name, arr)
        elif name.endswith("parameters"):
            # fused-RNN flat parameter vectors
            self._init_parameters(name, arr)
        elif name.endswith("state") or name.endswith("state_cell"):
            self._init_zero(name, arr)  # fused-RNN initial states
        else:
            self._init_default(name, arr)

    def _init_parameters(self, name, arr):
        _assign(arr, self._draw.sym_uniform(0.07, arr.shape))

    def _init_bilinear(self, name, arr):
        shape = arr.shape
        weight = np.zeros(int(np.prod(shape)), dtype=np.float32)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        _assign(arr, weight.reshape(shape))

    def _init_bias(self, name, arr):
        _assign(arr, 0.0)

    def _init_gamma(self, name, arr):
        _assign(arr, 1.0)

    def _init_beta(self, name, arr):
        _assign(arr, 0.0)

    def _init_zero(self, name, arr):
        _assign(arr, 0.0)

    def _init_one(self, name, arr):
        _assign(arr, 1.0)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_default(self, name, arr):
        raise MXNetError(
            f"Unknown initialization pattern for {name!r}; name an initializer "
            "pattern (weight/bias/gamma/beta) or use Mixed")


@_INIT_REGISTRY.register("uniform")
class Uniform(Initializer):
    """Weights uniform in [-scale, scale)."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, name, arr):
        _assign(arr, self._draw.sym_uniform(self.scale, arr.shape))


@_INIT_REGISTRY.register("normal")
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, name, arr):
        _assign(arr, self._draw.normal(self.sigma, arr.shape))


@_INIT_REGISTRY.register("orthogonal")
class Orthogonal(Initializer):
    def __init__(self, scale=1.414, rand_type="uniform"):
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = self._draw.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = self._draw.normal(1.0, (nout, nin))
        tmp = np.asarray(tmp, dtype=np.float64)
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        _assign(arr, (self.scale * q).reshape(arr.shape))


@_INIT_REGISTRY.register("xavier")
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

    def _init_weight(self, name, arr):
        shape = tuple(arr.shape)
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = shape[1] * hw_scale if len(shape) > 1 else shape[0]
        fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            _assign(arr, self._draw.sym_uniform(scale, shape))
        else:
            _assign(arr, self._draw.normal(scale, shape))


@_INIT_REGISTRY.register("msraprelu")
class MSRAPrelu(Xavier):
    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope**2))


@_INIT_REGISTRY.register("bilinear")
class Bilinear(Initializer):
    """Bilinear-interpolation weights for every weight (the kernel of an
    upsampling Deconvolution); names starting ``upsampling`` get them
    from every initializer."""

    def _init_weight(self, name, arr):
        self._init_bilinear(name, arr)


@_INIT_REGISTRY.register("zero")
class Zero(Initializer):
    def _init_weight(self, name, arr):
        _assign(arr, 0.0)

    _init_default = _init_weight


@_INIT_REGISTRY.register("one")
class One(Initializer):
    def _init_weight(self, name, arr):
        _assign(arr, 1.0)

    _init_default = _init_weight


class Constant(Initializer):
    def __init__(self, value):
        self.value = value

    def _init_weight(self, name, arr):
        _assign(arr, self.value)

    _init_default = _init_weight


class Load:
    """Initialize from a saved dict (``arg:``/``aux:`` prefixes
    stripped); fall back to ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr, generator=None):
        if name in self.param:
            if tuple(self.param[name].shape) != tuple(arr.shape):
                raise MXNetError(f"shape mismatch loading {name}")
            _assign(arr, self.param[name])
        else:
            if self.default_init is None:
                raise MXNetError(f"cannot init {name}: not found and no default")
            self.default_init(name, arr, generator)


class Mixed:
    """Regex-pattern routed initializers: the first pattern that
    matches the name picks the initializer."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must pair up")
        self.map = [(re.compile(p), i) for p, i in zip(patterns, initializers)]

    def __call__(self, name, arr, generator=None):
        for pat, ini in self.map:
            if pat.match(name):
                ini(name, arr, generator)
                return
        raise MXNetError(f"no initializer pattern matches {name!r}; add '.*'")


def init(name, **kwargs):
    """Create a registered initializer by name."""
    return _INIT_REGISTRY.get(name)(**kwargs)
