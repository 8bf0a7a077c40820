"""Operators of the port.  ``paged_attention`` dispatches a CUDA tensor
to the Hopper kernel (module ``ops.paged_attention_cuda``, built at
first launch, whose ``launches`` counts its launches) and a CPU tensor
to its plain torch version."""

from . import paged_attention_cuda
from .attention import (paged_attention, paged_attention_torch,
                        paged_eligible, resolve_paged_impl)

__all__ = ["paged_attention", "paged_attention_torch", "paged_eligible",
           "resolve_paged_impl", "paged_attention_cuda"]
