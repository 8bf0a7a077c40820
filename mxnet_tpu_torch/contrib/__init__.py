"""Contributed higher-level components built on the public API.

``quantization`` — post-training int8 quantization of a trained Symbol
(the port of ``mxnet_tpu/contrib/quantization.py``).
"""

from . import quantization

__all__ = ["quantization"]
