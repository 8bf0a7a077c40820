"""Environment knobs shared by the port.

The port keeps the reference's ``MXTPU_*`` knob names and their parsing
rules (``mxnet_tpu/base.py``), so one deployment environment configures
either package the same way.  The one knob whose values differ is the
paged-attention selector, ``MXTPU_TORCH_PAGED_ATTENTION=auto|cuda|torch``
(see ``ops/attention.py``).
"""

from __future__ import annotations

import os

__all__ = ["MXNetError", "env_flag", "env_int", "env_float"]


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
