"""Framework random state: the port of ``mxnet_tpu/random.py``.

:func:`seed` seeds every random source of the frontend: the key chain
(:func:`next_key`) that imperative samplers and executors draw their
seeds from, and the port's own ``numpy.random.RandomState`` that the
initializers draw from (:func:`np_rng`; the reference seeds numpy's
global generator, which its initializers use, so one seed gives both
packages the same initial values).  A key is an ``ops.op.RngKey``: a
seed and a device, from which a random op makes a ``torch.Generator``
there.  The state is per thread, as the reference's key chain.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .ops.op import RngKey

__all__ = ["seed", "next_key", "np_rng", "uniform", "normal"]

_state = threading.local()


def _chain():
    if not hasattr(_state, "chain"):
        _state.chain = torch.Generator().manual_seed(0)
    return _state.chain


def seed(seed_state: int):
    """Seed the key chain and the initializers' RandomState."""
    _state.chain = torch.Generator().manual_seed(int(seed_state))
    _state.np_rng = np.random.RandomState(int(seed_state) & 0xFFFFFFFF)


def np_rng():
    """The RandomState the initializers draw from (seed 0 until
    :func:`seed`)."""
    if not hasattr(_state, "np_rng"):
        _state.np_rng = np.random.RandomState(0)
    return _state.np_rng


def next_key(device="cpu"):
    """A fresh :class:`~mxnet_tpu_torch.ops.op.RngKey` for ``device``."""
    s = int(torch.randint(0, 2 ** 62, (1,), generator=_chain()))
    return RngKey(s, torch.device(device))


def uniform(low=0, high=1, shape=None, ctx=None, out=None):
    from . import ndarray as nd

    return nd._sample_uniform(low=low, high=high, shape=shape or (1,), ctx=ctx, out=out)


def normal(loc=0, scale=1, shape=None, ctx=None, out=None):
    from . import ndarray as nd

    return nd._sample_normal(loc=loc, scale=scale, shape=shape or (1,), ctx=ctx, out=out)
