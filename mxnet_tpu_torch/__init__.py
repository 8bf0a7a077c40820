"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX reference, ported slice by slice and
held against it.  It serves greedy GPT through continuous batching
(``serve.Engine``), with decode attention in a hand-written Hopper
kernel (``ops.paged_attention_cuda``), and trains GPT through
``parallel.ShardedTrainer`` (``models.gpt``), with attention in
hand-written Hopper flash-attention kernels
(``ops.flash_attention_cuda``), and trains RNN language models through
the ``RNN`` op (``ops.rnn``), whose LSTM and GRU layers run hand-written
Hopper fused-LSTM and fused-GRU kernels (``ops.fused_rnn_cuda``).  The
package imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of
``mxnet_tpu``.  Entry points default to ``device="cuda"`` and raise
when CUDA is absent.
"""

from . import aot, base

# MXTPU_COMPILE_CACHE=<dir>: kernel libraries persist across processes
# under a managed, toolkit-namespaced directory.  Wired before anything
# can build one (it reads files only; nothing is built at import).
aot.enable_from_env()

from . import (context, convert, flops, initializer, models,  # noqa: E402
               monitor, ops, parallel, profiler, serve, telemetry, fleet)
from .context import resolve_device  # noqa: E402
from .convert import params_from_numpy  # noqa: E402

__version__ = "0.1.0"

__all__ = ["aot", "base", "context", "convert", "flops", "fleet",
           "initializer", "models", "monitor", "ops", "parallel",
           "profiler", "serve", "telemetry",
           "resolve_device", "params_from_numpy"]
