"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX reference, ported slice by slice and
held against it.  It serves greedy GPT through continuous batching
(``serve.Engine``), with decode attention in a hand-written Hopper
kernel (``ops.paged_attention_cuda``), and trains GPT through
``parallel.ShardedTrainer`` (``models.gpt``), with attention in
hand-written Hopper flash-attention kernels
(``ops.flash_attention_cuda``), and trains RNN language models through
the ``RNN`` op (``ops.rnn``), whose LSTM and GRU layers run hand-written
Hopper fused-LSTM and fused-GRU kernels (``ops.fused_rnn_cuda``).

The training frontend is the reference's: ``nd`` (NDArray), ``sym``
(Symbol, generated from the op registry), ``Executor``, the optimizers,
metrics, callbacks, ``io.NDArrayIter`` and ``mod.Module``; a GPT Symbol
(``models.gpt_symbol``) trains through it on the same flash kernels.
Contexts default to ``gpu(0)``.

The package imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing of ``mxnet_tpu``.  Entry points default to the card
(``device="cuda"``, ``gpu(0)``) and raise when CUDA is absent.
"""

from . import aot, base

# MXTPU_COMPILE_CACHE=<dir>: kernel libraries persist across processes
# under a managed, toolkit-namespaced directory.  Wired before anything
# can build one (it reads files only; nothing is built at import).
aot.enable_from_env()

from . import (context, convert, flops, initializer, models,  # noqa: E402
               monitor, ops, parallel, profiler, serve, telemetry, fleet)
from . import registry, param, random  # noqa: E402
from . import ndarray, symbol, attribute, graph, executor  # noqa: E402
from . import lr_scheduler, optimizer, metric, callback, io  # noqa: E402
from . import model, module  # noqa: E402
from . import ndarray as nd, symbol as sym, module as mod  # noqa: E402
from . import initializer as init, optimizer as opt  # noqa: E402
from .base import MXNetError  # noqa: E402
from .context import (Context, cpu, cpu_pinned, current_context,  # noqa: E402
                      gpu, num_devices, resolve_device, tpu)
from .convert import params_from_numpy  # noqa: E402
from .executor import Executor  # noqa: E402
from .symbol import AttrScope, Group, Variable  # noqa: E402

__version__ = "0.1.0"

__all__ = ["aot", "base", "context", "convert", "flops", "fleet",
           "initializer", "models", "monitor", "ops", "parallel",
           "profiler", "serve", "telemetry",
           "resolve_device", "params_from_numpy",
           "registry", "param", "random", "ndarray", "nd", "symbol", "sym",
           "attribute", "graph", "executor", "Executor", "lr_scheduler",
           "optimizer", "opt", "metric", "callback", "io", "model",
           "module", "mod", "init", "MXNetError", "Context", "cpu",
           "cpu_pinned", "gpu", "tpu", "current_context", "num_devices",
           "AttrScope", "Group", "Variable"]
