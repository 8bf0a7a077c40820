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
``launches`` counts its launches."""

from . import (flash_attention, flash_attention_cuda, fused_gru, fused_lstm,
               fused_rnn_cuda, paged_attention_cuda, rnn)
from .attention import (FlashAttention, LayerNorm, RMSNorm, RoPE, gelu,
                        paged_attention, paged_attention_torch,
                        paged_eligible, resolve_paged_impl, silu)
from .loss import SoftmaxCELoss, SoftmaxOutput
from .nn import Embedding, FullyConnected
from .rnn import RNN

__all__ = ["paged_attention", "paged_attention_torch", "paged_eligible",
           "resolve_paged_impl", "paged_attention_cuda",
           "flash_attention_cuda", "flash_attention",
           "FlashAttention", "LayerNorm", "RMSNorm", "RoPE", "gelu", "silu",
           "SoftmaxOutput", "SoftmaxCELoss", "FullyConnected", "Embedding",
           "RNN", "rnn", "fused_lstm", "fused_gru", "fused_rnn_cuda"]
