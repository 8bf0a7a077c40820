"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX reference, ported slice by slice and
held against it.  This slice serves greedy GPT through continuous
batching (``serve.Engine``), with decode attention in a hand-written
Hopper kernel (``ops.paged_attention_cuda``).  The package imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of
``mxnet_tpu``.  Entry points default to ``device="cuda"`` and raise
when CUDA is absent.
"""

from . import base, context, convert, models, ops, serve, telemetry
from .context import resolve_device
from .convert import params_from_numpy

__version__ = "0.1.0"

__all__ = ["base", "context", "convert", "models", "ops", "serve",
           "telemetry", "resolve_device", "params_from_numpy"]
