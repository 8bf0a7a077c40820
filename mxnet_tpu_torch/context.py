"""Device resolution for the port's entry points.

Every entry point (``serve.Engine``, ``models.gpt_generate``,
``ops.paged_attention``'s callers, ``convert.params_from_numpy``) takes a
``device`` argument that defaults to ``"cuda"``.  Asking for CUDA on a
machine without it raises: there is no silent retreat to the CPU, so a
run that reports GPU numbers really ran on the GPU.  Tests pass
``device="cpu"`` explicitly.

Float32 here means true float32.  The reference's f32 matmuls are full
precision, so the port turns TF32 off for both cuBLAS matmuls and cuDNN
(cuDNN's default is TF32 on, which keeps only ~3 decimal digits).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "DEFAULT_DEVICE"]

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
