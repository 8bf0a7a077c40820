"""Attribute scoping (the port of ``mxnet_tpu/attribute.py``).

The implementation lives in :mod:`mxnet_tpu_torch.symbol`; re-exported
here so code written against the reference layout
(``mx.attribute.AttrScope``) works.
"""

from .symbol import AttrScope

__all__ = ["AttrScope"]
