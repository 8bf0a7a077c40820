"""ShardedTrainer on one device: a model's whole train step.

The port of ``mxnet_tpu/parallel/trainer.py`` for a one-device mesh.  The
reference compiles forward, backward and the optimizer update into one
XLA program over a mesh; here the step runs eagerly on one device: the
model's forward, autograd's backward with a head gradient of ones, the
``1/batch`` gradient rescale, then the functional optimizer's update.
Meshes of more than one device, parameter and sequence shardings, FSDP,
ZeRO and gradient accumulation are not ported yet and raise.

The reference donates the parameter and optimizer-state buffers to its
jitted step, so the update reuses them; the port updates the same
tensors in place under ``torch.no_grad()`` for the same memory saving.
"""

from __future__ import annotations

import inspect
import math

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device
from ..convert import to_tensor
from ..initializer import Uniform

__all__ = ["ShardedTrainer", "sgd_opt", "adam_opt", "adamw_opt"]


def _not_ported(what):
    return NotImplementedError(f"ShardedTrainer: {what} is not ported yet "
                               "(ROADMAP §A18)")


def _clip_grads(grads, clip_gradient=None, clip_by_global_norm=None):
    """The reference's per-element clamp to [-c, c] and global-L2-norm
    rescale, both in float32."""
    if clip_gradient is not None:
        c = float(clip_gradient)
        grads = {k: g.float().clamp(-c, c) for k, g in grads.items()}
    if clip_by_global_norm is not None:
        c = float(clip_by_global_norm)
        sq = sum(g.float().square().sum() for g in grads.values())
        scale = torch.clamp(c / torch.sqrt(sq).clamp_min(1e-12), max=1.0)
        grads = {k: g.float() * scale for k, g in grads.items()}
    return grads


def sgd_opt(learning_rate=0.01, momentum=0.9, weight_decay=0.0,
            clip_gradient=None, clip_by_global_norm=None,
            state_dtype=None):
    """SGD with momentum: ``(init, update)``.  The momentum buffer is
    stored in ``state_dtype`` (default: the parameter's dtype); the
    update computes in float32 and writes parameters and state in
    place."""
    sdt = _torch_dtype(state_dtype) if state_dtype is not None else None

    def init(params):
        if momentum == 0.0:
            return {}
        return {k: torch.zeros_like(v, dtype=sdt or v.dtype)
                for k, v in params.items()}

    @torch.no_grad()
    def update(grads, state, params, lr_scale=1.0):
        grads = _clip_grads(grads, clip_gradient, clip_by_global_norm)
        lr = learning_rate * lr_scale
        for k, p in params.items():
            g = grads[k].float() + weight_decay * p.float()
            if momentum != 0.0:
                m = momentum * state[k].float() - lr * g
                state[k].copy_(m)
                p.copy_(p.float() + m)
            else:
                p.copy_(p.float() - lr * g)
        return params, state

    return init, update


def adam_opt(learning_rate=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
             weight_decay=0.0, decoupled=False, clip_gradient=None,
             clip_by_global_norm=None):
    """Adam: ``(init, update)``, moments in float32.  ``decoupled=True``
    is AdamW (weights multiplied by 1 - lr * wd instead of decay folded
    into the gradient)."""

    def init(params):
        zeros = lambda: {k: torch.zeros_like(v, dtype=torch.float32)
                         for k, v in params.items()}
        return {"m": zeros(), "v": zeros(), "t": 0}

    @torch.no_grad()
    def update(grads, state, params, lr_scale=1.0):
        grads = _clip_grads(grads, clip_gradient, clip_by_global_norm)
        state["t"] += 1
        dev = next(iter(params.values())).device
        t = torch.tensor(float(state["t"]), dtype=torch.float32, device=dev)
        lr = torch.tensor(learning_rate * lr_scale, dtype=torch.float32,
                          device=dev)
        # bias-corrected step size, in float32 as the reference's
        lr_t = lr * torch.sqrt(1 - beta2 ** t) / (1 - beta1 ** t)
        for k, p in params.items():
            pf = p.float()
            g = grads[k].float()
            if not decoupled:
                g = g + weight_decay * pf
            m, v = state["m"][k], state["v"][k]
            m.copy_(beta1 * m + (1 - beta1) * g)
            v.copy_(beta2 * v + (1 - beta2) * g.square())
            if decoupled:
                pf = pf * (1.0 - learning_rate * lr_scale * weight_decay)
            p.copy_(pf - lr_t * m / (torch.sqrt(v) + eps))
        return params, state

    return init, update


def adamw_opt(learning_rate=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
              weight_decay=0.0, clip_gradient=None,
              clip_by_global_norm=None):
    """AdamW: :func:`adam_opt` with decoupled weight decay."""
    return adam_opt(learning_rate, beta1, beta2, eps, weight_decay,
                    decoupled=True, clip_gradient=clip_gradient,
                    clip_by_global_norm=clip_by_global_norm)


_OPTS = {"sgd": sgd_opt, "adam": adam_opt, "adamw": adamw_opt}
_UNPORTED_OPTS = ("lars", "lamb")


def _wrap_update(update_fn, lr_scheduler):
    """A custom ``update`` called as ``update(grads, state, params,
    lr_scale=s)``, as the reference wraps it: an update that names
    ``lr_scale`` (or takes ``**kwargs``) gets it by keyword, the legacy
    4-positional form gets 1.0, the 3-argument form nothing.  A schedule
    that the update cannot take raises rather than training flat."""
    try:
        sig = inspect.signature(update_fn)
    except (TypeError, ValueError):
        return update_fn        # not introspectable: passed by keyword
    try:
        sig.bind(None, None, None, lr_scale=1.0)
        return update_fn
    except TypeError:
        pass
    if lr_scheduler is not None:
        raise MXNetError(
            "lr_scheduler requires the custom optimizer's update(grads, "
            "state, params, lr_scale) to accept an 'lr_scale' argument")
    try:
        sig.bind(None, None, None, 1.0)
        return (lambda grads, state, params, lr_scale=1.0:
                update_fn(grads, state, params, 1.0))
    except TypeError:
        return (lambda grads, state, params, lr_scale=1.0:
                update_fn(grads, state, params))


def _torch_dtype(dtype):
    """A torch dtype from a torch dtype, numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "float64": torch.float64,
                "int32": torch.int32, "int64": torch.int64}[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}") from None


class ShardedTrainer:
    """Train a model (e.g. :func:`~mxnet_tpu_torch.models.gpt`) on one
    device.

    ``symbol`` is the model, an ``nn.Module`` whose ``forward`` takes the
    inputs named by ``input_shapes`` and returns the loss head's outputs
    (a tensor or a tuple of them); its parameters carry checkpoint
    names.  ``optimizer`` is ``"sgd"``, ``"adam"``, ``"adamw"`` or an
    ``(init, update)`` pair whose ``update(grads, state, params[,
    lr_scale])`` returns ``(params, state)`` (new parameter tensors are
    copied into the parameters in place); ``dtype`` the parameters'
    stored dtype (float data inputs follow it, labels and integer inputs
    do not);
    ``initializer`` defaults to ``Uniform(0.07)`` and draws from a
    ``torch.Generator`` seeded with 0 (a caller wanting other values
    passes its own initializer or calls ``set_params``).  ``rescale_grad`` defaults
    to ``1 / batch`` (the first input's leading dimension): the loss
    heads' gradients are un-normalized.  ``lr_scheduler`` is any
    ``step -> lr`` callable, evaluated each step (a custom ``update``
    must then take ``lr_scale``).  ``device`` defaults to
    ``"cuda"`` and raises when CUDA is absent.
    """

    def __init__(self, symbol, input_shapes, mesh=None, batch_axis="dp",
                 param_specs=None, sequence_specs=None, optimizer="sgd",
                 optimizer_params=None, initializer=None, dtype="float32",
                 input_dtypes=None, rescale_grad=None, grad_accum_steps=1,
                 shard_optimizer_state=False, lr_scheduler=None,
                 fsdp=False, fsdp_min_size=2 ** 17, seq_axis=None,
                 device="cuda"):
        if mesh is not None and math.prod(
                dict(getattr(mesh, "shape", mesh)).values()) > 1:
            raise _not_ported("a mesh of more than one device")
        for value, what in ((param_specs, "param_specs"),
                            (sequence_specs, "sequence_specs"),
                            (fsdp, "fsdp"),
                            (shard_optimizer_state, "shard_optimizer_state"),
                            (seq_axis, "seq_axis")):
            if value:
                raise _not_ported(what)
        if int(grad_accum_steps) != 1:
            raise _not_ported("grad_accum_steps > 1")
        self.device = resolve_device(device)
        self.batch_axis = batch_axis
        self.symbol = symbol
        self.input_names = list(input_shapes)
        self._dtype = _torch_dtype(dtype)
        # float data inputs follow the compute dtype; labels stay float32
        # (bf16 cannot hold class ids above 256 exactly); integer inputs
        # keep their type
        self._input_dtypes = {}
        for k in self.input_names:
            dt = _torch_dtype((input_dtypes or {}).get(k, torch.float32))
            if (dt.is_floating_point and self._dtype != torch.float32
                    and not k.endswith("label")):
                dt = self._dtype
            self._input_dtypes[k] = dt

        # place the model's parameters and initialise them by name
        initializer = initializer or Uniform(0.07)
        gen = torch.Generator().manual_seed(0)
        symbol.to_empty(device=self.device)
        self.params = dict(symbol.named_parameters())
        self.param_names = list(self.params)
        for name, p in self.params.items():
            host = torch.empty(p.shape, dtype=torch.float32)
            initializer(name, host, gen)
            p.data = host.to(device=self.device, dtype=self._dtype)

        if optimizer in _UNPORTED_OPTS:
            raise _not_ported(f"optimizer={optimizer!r}")
        if isinstance(optimizer, str):
            factory = _OPTS[optimizer]
            init_fn, self._update_fn = factory(**(optimizer_params or {}))
            default = inspect.signature(
                factory).parameters["learning_rate"].default
            base_lr = float((optimizer_params or {}).get("learning_rate",
                                                         default))
        else:
            init_fn, update_fn = optimizer
            self._update_fn = _wrap_update(update_fn, lr_scheduler)
            base_lr = float((optimizer_params or {}).get("learning_rate",
                                                         1.0))
        self._lr_scheduler = lr_scheduler
        if lr_scheduler is not None and hasattr(lr_scheduler, "base_lr"):
            lr_scheduler.base_lr = base_lr    # the optimizer's lr is its base
        self._base_lr = base_lr
        self._num_update = 0
        self.opt_state = init_fn(self.params)
        if rescale_grad is None:
            rescale_grad = 1.0 / next(iter(input_shapes.values()))[0]
        self._rescale_grad = rescale_grad

    def _place_batch(self, batch):
        placed = {}
        for name in self.input_names:
            v = batch[name]
            dt = self._input_dtypes[name]
            if not isinstance(v, torch.Tensor):
                v = np.asarray(v)
                if dt.is_floating_point:
                    v = v.astype(np.float32)
            placed[name] = to_tensor(v, self.device).to(dt)
        return placed

    def _lr_scale(self):
        self._num_update += 1
        if self._lr_scheduler is None:
            return 1.0
        lr = float(self._lr_scheduler(self._num_update))
        return lr / max(self._base_lr, 1e-30)

    def _grads_of(self, placed):
        """Forward and backward with a head gradient of ones: (grads,
        outputs).  Gradients are un-rescaled, in the parameters'
        dtype."""
        for p in self.params.values():
            p.grad = None
        outs = self.symbol(**placed)
        outs = outs if isinstance(outs, tuple) else (outs,)
        torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in self.params.items()}
        for p in self.params.values():
            p.grad = None
        return grads, tuple(o.detach() for o in outs)

    def step(self, batch):
        """One optimizer step on a batch; returns the head outputs."""
        grads, outs = self._grads_of(self._place_batch(batch))
        scale = self._rescale_grad
        grads = {k: g * scale for k, g in grads.items()}
        with torch.no_grad():
            params, self.opt_state = self._update_fn(
                grads, self.opt_state, self.params,
                lr_scale=self._lr_scale())
            for k, p in params.items():     # the built-ins return these
                if p is not self.params[k]:
                    self.params[k].copy_(p)
        return outs

    def eval(self, batch):
        """The head outputs of a forward pass, no update."""
        with torch.no_grad():
            outs = self.symbol(**self._place_batch(batch))
        return outs if isinstance(outs, tuple) else (outs,)

    def get_params(self):
        """``{name: numpy array}`` on the host.  bfloat16 parameters come
        back as float32 arrays holding exactly the bfloat16 values."""
        return {k: p.detach().float().cpu().numpy().copy()
                for k, p in self.params.items()}

    def set_params(self, arg_params):
        """Copy ``{name: array}`` (numpy, incl. bfloat16, or torch) into
        the parameters as they are, cast to the trainer's dtype; unknown
        names are skipped."""
        with torch.no_grad():
            for k, v in arg_params.items():
                if k in self.params:
                    self.params[k].copy_(to_tensor(v, self.device,
                                                   self._dtype))
