"""Environment knobs shared by the port.

The port keeps the reference's ``MXTPU_*`` knob names and their parsing
rules (``mxnet_tpu/base.py``), so one deployment environment configures
either package the same way.  The one knob whose values differ is the
paged-attention selector, ``MXTPU_TORCH_PAGED_ATTENTION=auto|cuda|torch``
(see ``ops/attention.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["MXNetError", "env_flag", "env_int", "env_float", "np_dtype",
           "dtype_name", "torch_dtype", "numeric_types", "string_types",
           "DTYPE_NAMES"]


class MXNetError(Exception):
    """Error raised by the framework."""


def env_flag(name, default=True):
    """Boolean MXTPU_* knob: one parse for every call site so accepted
    spellings can't drift between features."""
    value = os.environ.get(name)
    if value is None or value == "":
        return default
    return value not in ("0", "false", "False", "FALSE", "no", "off")


def env_int(name, default):
    """Integer MXTPU_* knob; a malformed value falls back to the
    default instead of crashing the caller's hot path."""
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def env_float(name, default):
    """Float MXTPU_* knob (timeouts, rates); malformed values fall back
    to the default like :func:`env_int`."""
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return float(default)


# -- dtypes -----------------------------------------------------------------
# The reference's dtype table (``mxnet_tpu/base.py``).  numpy has no
# bfloat16 of its own and the port loads no ml_dtypes, so "bfloat16"
# resolves to ``torch.bfloat16``; every other name is a numpy dtype.
string_types = (str,)
numeric_types = (float, int, np.generic)

_DTYPE_ALIASES = {
    "float32": np.float32,
    "float64": np.float64,
    "float16": np.float16,
    "uint8": np.uint8,
    "int8": np.int8,
    "int32": np.int32,
    "int64": np.int64,
    "bool": np.bool_,
}
DTYPE_NAMES = tuple(_DTYPE_ALIASES) + ("bfloat16",)

_TORCH_OF = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "uint8": torch.uint8, "int8": torch.int8,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
    "bfloat16": torch.bfloat16,
}


def np_dtype(dtype):
    """A dtype-like (name, numpy dtype, python type, torch dtype) as a
    numpy dtype; ``"bfloat16"`` and ``torch.bfloat16`` as
    ``torch.bfloat16``.  None is float32, as in the reference."""
    if dtype is None:
        return np.dtype(np.float32)
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return torch.bfloat16
        return np.dtype(torch.empty((), dtype=dtype).numpy().dtype)
    if isinstance(dtype, str):
        if dtype == "bfloat16":
            return torch.bfloat16
        if dtype in _DTYPE_ALIASES:
            return np.dtype(_DTYPE_ALIASES[dtype])
    if getattr(dtype, "name", None) == "bfloat16" or \
            getattr(dtype, "__name__", None) == "bfloat16":
        return torch.bfloat16
    return np.dtype(dtype)


def dtype_name(dtype) -> str:
    """Canonical string name for a dtype-like."""
    d = np_dtype(dtype)
    return "bfloat16" if d is torch.bfloat16 else d.name


def torch_dtype(dtype):
    """A dtype-like as a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_OF[dtype_name(dtype)]
