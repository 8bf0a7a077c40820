"""Sequence operators with per-example lengths: the port of
``mxnet_tpu/ops/sequence.py`` (``SequenceLast``, ``SequenceMask``,
``SequenceReverse``).

Layout as the reference's: time-major (T, N, ...) with an optional (N,)
length vector (``use_sequence_length``).  Masks and gathers over the
whole batch at once, no per-example loop.
"""

from __future__ import annotations

import torch

from ..param import Params, field
from .op import OpDef, register_op

__all__ = ["SequenceParam", "SequenceMaskParam"]


class SequenceParam(Params):
    use_sequence_length = field(bool, default=False)


class SequenceMaskParam(SequenceParam):
    value = field(float, default=0.0)


def _seq_args(params):
    return ["data", "sequence_length"] if params.use_sequence_length else ["data"]


def _seq_shapes(params, d):
    return [tuple(d)] + ([(d[1],)] if params.use_sequence_length else [])


def _lengths(x, lengths):
    """The (1, N, 1, ...) int64 lengths, broadcastable against x."""
    return lengths.to(torch.int64).reshape((1, -1) + (1,) * (x.dim() - 2))


def _steps(x):
    """The (T, 1, 1, ...) step index, broadcastable against x."""
    return torch.arange(x.shape[0], device=x.device).reshape(
        (-1,) + (1,) * (x.dim() - 1))


@register_op("SequenceLast")
class SequenceLastOp(OpDef):
    param_cls = SequenceParam

    def list_arguments(self, params):
        return _seq_args(params)

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        return _seq_shapes(params, d), [tuple(d[1:])], []

    def forward(self, params, inputs, aux, train, key):
        x = inputs[0]
        if not params.use_sequence_length:
            return [x[-1]], []
        idx = (_lengths(x, inputs[1]) - 1).clamp(0, x.shape[0] - 1)
        idx = idx.expand((1,) + tuple(x.shape[1:]))
        return [torch.gather(x, 0, idx)[0]], []


@register_op("SequenceMask")
class SequenceMaskOp(OpDef):
    param_cls = SequenceMaskParam

    def list_arguments(self, params):
        return _seq_args(params)

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        return _seq_shapes(params, d), [tuple(d)], []

    def forward(self, params, inputs, aux, train, key):
        x = inputs[0]
        if not params.use_sequence_length:
            return [x], []
        mask = _steps(x) < _lengths(x, inputs[1])
        fill = torch.full((), params.value, dtype=x.dtype, device=x.device)
        return [torch.where(mask, x, fill)], []


@register_op("SequenceReverse")
class SequenceReverseOp(OpDef):
    param_cls = SequenceParam

    def list_arguments(self, params):
        return _seq_args(params)

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        return _seq_shapes(params, d), [tuple(d)], []

    def forward(self, params, inputs, aux, train, key):
        x = inputs[0]
        if not params.use_sequence_length:
            return [x.flip(0)], []
        steps, lengths = _steps(x), _lengths(x, inputs[1])
        # the source row: reversed within [0, len), the identity beyond
        src = torch.where(steps < lengths, lengths - 1 - steps, steps)
        src = src.clamp(0, x.shape[0] - 1)
        return [torch.gather(x, 0, src.expand(x.shape))], []
