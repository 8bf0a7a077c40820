"""Carry a reference checkpoint across to the port.

A ``mxnet_tpu`` parameter dict (``Module.get_params()``, a checkpoint
file, ``models.gpt_params``) is a dict of numpy arrays.
:func:`params_from_numpy` normalizes it (``normalize_gpt_params``:
dequantized ``*_wscale`` weights, split ``fused_qkv`` projections) and
turns it into the port's dict of torch tensors on one device.
``parallel.ShardedTrainer.set_params`` takes a trainer's dict as it is,
one :func:`to_tensor` per entry.
"""

from __future__ import annotations

import numpy as np
import torch

from .context import resolve_device
from .models.generate import normalize_gpt_params

__all__ = ["params_from_numpy", "to_tensor"]


def to_tensor(a, device, dtype=None):
    """One array (numpy, incl. the ml_dtypes bfloat16 numpy type the
    reference writes, a torch tensor, or an NDArray, e.g. from
    ``model.load_checkpoint``) as a tensor on ``device``; ``dtype`` casts
    floating-point values only."""
    if isinstance(getattr(a, "_data", None), torch.Tensor):
        a = a._data                    # an NDArray: its tensor
    if not isinstance(a, torch.Tensor):
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:      # e.g. a view of a jax array
            a = a.copy()
        if a.dtype.name == "bfloat16":
            # numpy has no bfloat16 of its own: reinterpret the 16 bits
            a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            a = torch.from_numpy(a)
    if dtype is not None and a.is_floating_point():
        return a.to(device=device, dtype=dtype)
    return a.to(device=device)


def params_from_numpy(np_params, device="cuda", dtype=None, name="gpt"):
    """``{name: tensor}`` on ``device`` (default ``"cuda"``, which raises
    when CUDA is absent), normalized for decoding.  ``dtype`` (e.g.
    ``torch.bfloat16``) casts every floating-point entry; None keeps each
    entry's own dtype."""
    dev = resolve_device(device)
    return {k: to_tensor(v, dev, dtype)
            for k, v in normalize_gpt_params(np_params, name).items()}
