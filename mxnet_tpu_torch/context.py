"""Device resolution and the device context of the training frontend.

Every entry point (``serve.Engine``, ``models.gpt_generate``,
``ops.paged_attention``'s callers, ``convert.params_from_numpy``) takes a
``device`` argument that defaults to ``"cuda"``.  Asking for CUDA on a
machine without it raises: there is no silent retreat to the CPU, so a
run that reports GPU numbers really ran on the GPU.  Tests pass
``device="cpu"`` explicitly.

:class:`Context` is the port of ``mxnet_tpu/context.py``: a logical
device ``(device_type, device_id)``, usable as a with-block.  ``gpu(i)``
and ``tpu(i)`` name ``cuda:i`` and raise when CUDA is absent (the
reference falls back to whatever platform it finds); ``cpu`` and
``cpu_pinned`` name the host.  :func:`current_context` defaults to
``gpu(0)``, since the port's entry points run on the card unless asked
otherwise.

Float32 here means true float32.  The reference's f32 matmuls are full
precision, so the port turns TF32 off for both cuBLAS matmuls and cuDNN
(cuDNN's default is TF32 on, which keeps only ~3 decimal digits).
"""

from __future__ import annotations

import threading

import torch

__all__ = ["resolve_device", "DEFAULT_DEVICE", "Context", "cpu", "gpu",
           "tpu", "cpu_pinned", "current_context", "num_devices"]

DEFAULT_DEVICE = "cuda"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=DEFAULT_DEVICE):
    """``device`` (str or ``torch.device``) as a ``torch.device``;
    raises ``RuntimeError`` when a CUDA device is asked for and none is
    present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' explicitly to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Context:
    """A logical device (device_type, device_id), usable as a with-block."""

    _default_ctx = threading.local()

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 4: "tpu"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "tpu": 4}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in self.devstr2type:
                raise ValueError(f"unknown device type {device_type!r}")
            self.device_typeid = self.devstr2type[device_type]
            self.device_id = device_id
        self._old_ctx = None

    @property
    def device_type(self) -> str:
        return self.devtype2str[self.device_typeid]

    def torch_device(self):
        """The ``torch.device`` this context names: ``cuda:i`` for gpu
        and tpu (raising without CUDA, or when the card is not there),
        the CPU for cpu and cpu_pinned."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        dev = resolve_device(f"cuda:{self.device_id}")
        if self.device_id >= torch.cuda.device_count():
            raise ValueError(f"{self} out of range: only "
                             f"{torch.cuda.device_count()} CUDA device(s)")
        return dev

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    def __str__(self):
        return self.__repr__()

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        Context._default_ctx.value = self._old_ctx
        return False


def cpu(device_id=0) -> Context:
    return Context("cpu", device_id)


def cpu_pinned(device_id=0) -> Context:
    return Context("cpu_pinned", device_id)


def gpu(device_id=0) -> Context:
    """CUDA device ``device_id``."""
    return Context("gpu", device_id)


def tpu(device_id=0) -> Context:
    """The reference's accelerator context; in the port, CUDA device
    ``device_id``, as :func:`gpu`."""
    return Context("tpu", device_id)


def num_devices(device_type="gpu") -> int:
    """Devices of a type: CUDA devices for gpu/tpu (0 without CUDA), one
    host for cpu."""
    if device_type in ("cpu", "cpu_pinned"):
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context() -> Context:
    """The ambient default context: the innermost with-block's, else
    ``gpu(0)``."""
    cur = getattr(Context._default_ctx, "value", None)
    return cur if cur is not None else Context("gpu", 0)
