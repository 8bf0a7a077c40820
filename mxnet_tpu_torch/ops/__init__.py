"""Operators of the port.

Serving: ``paged_attention`` dispatches a CUDA tensor to the Hopper
paged-attention kernel (``ops.paged_attention_cuda``) and a CPU tensor to
its plain torch version.  Training: ``flash_attention.flash_attention``
(and the ``FlashAttention`` op over it) launches the Hopper flash-attention
forward, dQ and dK/dV kernels (``ops.flash_attention_cuda``) on CUDA
tensors and their plain versions on CPU tensors.  RNN training: the
``RNN`` op (``ops.rnn``) runs its LSTM and GRU layers through
``fused_lstm.fused_lstm`` / ``fused_gru.fused_gru``, which launch the
Hopper fused-LSTM and fused-GRU forward and backward kernels
(``ops.fused_rnn_cuda``) on CUDA tensors and their plain versions on CPU
tensors.  Kernels are built at first launch; each wrapper module's
``launches`` counts its launches.

The op registry (``ops.op``): importing this package registers the
operators of the training frontend (``elementwise``, ``reduce``,
``matrix``, ``nn``, ``loss``, ``sample``, ``attention``, ``rnn``,
``sequence``, ``vision``, ``multibox``, ``quantized``), from which
``ndarray`` and ``symbol`` generate their functions.  The vision layers
and the multibox ops run as plain torch (a convolution goes to cuDNN on
the card), the quantized ops' exact int8 contraction through
``torch._int_mm`` on the card: the reference computes them outside any
Pallas kernel."""

from . import (flash_attention, flash_attention_cuda, fused_gru, fused_lstm,
               fused_rnn_cuda, paged_attention_cuda, rnn)
from . import elementwise, matrix, reduce, sample, sequence, vision  # noqa: F401
from . import multibox, quantized  # noqa: F401
# (the imports above register their ops)
from .attention import (FlashAttention, LayerNorm, RMSNorm, RoPE, gelu,
                        paged_attention, paged_attention_torch,
                        paged_eligible, resolve_paged_impl, silu)
from .loss import SoftmaxCELoss, SoftmaxOutput
from .nn import Embedding, FullyConnected
from .op import (OP_REGISTRY, OpDef, SimpleOpDef, register_op,
                 register_simple_op)
from .rnn import RNN

__all__ = ["paged_attention", "paged_attention_torch", "paged_eligible",
           "resolve_paged_impl", "paged_attention_cuda",
           "flash_attention_cuda", "flash_attention",
           "FlashAttention", "LayerNorm", "RMSNorm", "RoPE", "gelu", "silu",
           "SoftmaxOutput", "SoftmaxCELoss", "FullyConnected", "Embedding",
           "RNN", "rnn", "fused_lstm", "fused_gru", "fused_rnn_cuda",
           "OP_REGISTRY", "OpDef", "SimpleOpDef", "register_op",
           "register_simple_op"]
