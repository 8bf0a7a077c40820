"""Neural-network layer operators of the training path.

The port of ``mxnet_tpu/ops/nn.py``'s ``FullyConnected`` and
``Embedding``, as plain functions on tensors; gradients come from
autograd.
"""

from __future__ import annotations

import torch.nn.functional as F

__all__ = ["FullyConnected", "Embedding"]


def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False):
    """y = x @ W.T + b over x flattened to (N, -1); the weight is stored
    (num_hidden, input_dim) and, like the bias, cast to the activations'
    dtype (mixed precision follows the activations)."""
    if num_hidden is not None and weight.shape[0] != num_hidden:
        raise ValueError(f"FullyConnected: weight has {weight.shape[0]} "
                         f"rows, num_hidden={num_hidden}")
    x2 = data.reshape(data.shape[0], -1)
    y = x2 @ weight.to(data.dtype).t()
    if bias is not None and not no_bias:
        y = y + bias.to(data.dtype)
    return y


def Embedding(data, weight, input_dim=None, output_dim=None):
    """Rows of ``weight`` at the integer ids ``data``; the output is in
    the table's dtype.  The backward is autograd's scatter-add into the
    table."""
    if input_dim is not None and weight.shape[0] != input_dim:
        raise ValueError(f"Embedding: table has {weight.shape[0]} rows, "
                         f"input_dim={input_dim}")
    if output_dim is not None and weight.shape[1] != output_dim:
        raise ValueError(f"Embedding: table width {weight.shape[1]}, "
                         f"output_dim={output_dim}")
    return F.embedding(data.long(), weight)
