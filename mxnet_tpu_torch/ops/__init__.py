"""Operators of the port.

Serving: ``paged_attention`` dispatches a CUDA tensor to the Hopper
paged-attention kernel (``ops.paged_attention_cuda``) and a CPU tensor to
its plain torch version.  Training: ``flash_attention.flash_attention``
(and the ``FlashAttention`` op over it) launches the Hopper flash-attention
forward, dQ and dK/dV kernels (``ops.flash_attention_cuda``) on CUDA
tensors and their plain versions on CPU tensors.  Kernels are built at
first launch; each wrapper module's ``launches`` counts its launches."""

from . import flash_attention, flash_attention_cuda, paged_attention_cuda
from .attention import (FlashAttention, LayerNorm, RMSNorm, RoPE, gelu,
                        paged_attention, paged_attention_torch,
                        paged_eligible, resolve_paged_impl, silu)
from .loss import SoftmaxCELoss, SoftmaxOutput
from .nn import Embedding, FullyConnected

__all__ = ["paged_attention", "paged_attention_torch", "paged_eligible",
           "resolve_paged_impl", "paged_attention_cuda",
           "flash_attention_cuda", "flash_attention",
           "FlashAttention", "LayerNorm", "RMSNorm", "RoPE", "gelu", "silu",
           "SoftmaxOutput", "SoftmaxCELoss", "FullyConnected", "Embedding"]
