"""Operator definition contract and registry.

The port of ``mxnet_tpu/ops/op.py``: the same metadata contract
(arguments, outputs, aux states, shape/dtype inference, a typed
``Params`` struct) with a ``forward`` over torch tensors.  Ops with
non-autograd backward semantics (loss layers, BlockGrad) declare an
explicit ``backward``; :func:`apply_op` runs those through a
``torch.autograd.Function`` (the port's counterpart of the reference
executor's ``_wrap_custom_vjp``), so whole-graph autograd composes
through them.  Random ops receive an :class:`RngKey`: the seed of a
``torch.Generator`` the op makes on the key's device, so a forward
replayed with the same key (mirroring, ``partial_forward``) draws the
same values.

The registry is the runtime-discoverable op surface:
``mxnet_tpu_torch.ndarray`` and ``mxnet_tpu_torch.symbol`` generate their
functions from it at import time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..base import np_dtype
from ..param import Params
from ..registry import Registry

__all__ = ["OpDef", "OP_REGISTRY", "register_op", "register_simple_op", "SimpleOpDef",
           "apply_op", "RngKey", "not_ported"]

OP_REGISTRY = Registry("operator")


class OpDef:
    """Metadata + torch forward for one operator.

    Subclasses override class attributes / methods as needed.  All shape
    values are tuples of ints, with ``None`` marking "unknown" entries fed
    to bidirectional inference (symbolic.h InferShape contract).
    """

    name: str = None
    param_cls: type = None
    need_rng: bool = False  # op consumes a seed (Dropout, samplers)
    is_loss: bool = False  # backward ignores head gradient (SoftmaxOutput &co)
    # name of the param the frontends fill with the positional-input
    # count when not given (reference key_var_num_args, an OPT-IN per-op
    # property: Concat/ElementWiseSum/Crop/UpSampling — the last ignores
    # it for the signature in bilinear mode, like the reference)
    key_var_num_args: str = None

    # -- signature ---------------------------------------------------------
    def list_arguments(self, params) -> list:
        return ["data"]

    def list_outputs(self, params) -> list:
        return ["output"]

    def list_auxiliary_states(self, params) -> list:
        return []

    def num_inputs(self, params) -> int:
        return len(self.list_arguments(params))

    def num_outputs(self, params) -> int:
        return len(self.list_outputs(params))

    # -- inference ---------------------------------------------------------
    def infer_shape(self, params, in_shapes):
        """Return (in_shapes, out_shapes, aux_shapes), completing Nones.

        Default: single output with the shape of input 0 (identity-like).
        """
        if in_shapes[0] is None:
            raise ValueError(f"{self.name}: cannot infer shape, input 0 unknown")
        return list(in_shapes), [tuple(in_shapes[0])], []

    def infer_dtype(self, params, in_dtypes):
        """Return (in_dtypes, out_dtypes, aux_dtypes)."""
        dt = next((d for d in in_dtypes if d is not None), np.dtype(np.float32))
        return [d if d is not None else dt for d in in_dtypes], [dt] * self.num_outputs(params), [
            dt
        ] * len(self.list_auxiliary_states(params))

    # -- lowering ----------------------------------------------------------
    def forward(self, params, inputs, aux, train, key):
        """The computation, on torch tensors.

        Parameters
        ----------
        params : Params or None
        inputs : list of tensors
        aux : list of tensors (auxiliary states, e.g. BN moving stats)
        train : bool
        key : RngKey or None (present iff ``need_rng``)

        Returns
        -------
        (outputs, new_aux) : both lists of tensors.  ``new_aux`` must
        have the same structure as ``aux`` (unchanged entries passed
        through); it is committed by the executor after a training step.
        """
        raise NotImplementedError

    # Ops with explicit backward semantics (loss layers) override this.
    # Returning None means "differentiate forward with autograd".
    def backward(self, params, out_grads, inputs, outputs):
        """Explicit gradient: return grads w.r.t. every input.

        ``out_grads`` are head gradients (ignored by loss ops, which is
        exactly the reference's SoftmaxOutput contract); an entry for a
        non-floating input is dropped.
        """
        return None

    has_backward = False  # set True when ``backward`` is overridden

    def make_params(self, kwargs) -> Params:
        if self.param_cls is None:
            if kwargs:
                raise ValueError(f"{self.name} takes no keyword params, got {sorted(kwargs)}")
            return None
        return self.param_cls(**kwargs)

    def __repr__(self):
        return f"<Op {self.name}>"


def register_op(name, aliases=()):
    """Class decorator: instantiate and register an OpDef subclass."""

    def _reg(cls):
        inst = cls()
        inst.name = name
        if "backward" in cls.__dict__:
            inst.has_backward = True
        OP_REGISTRY.register(name, inst, aliases=aliases)
        return cls

    return _reg


class SimpleOpDef(OpDef):
    """One-liner op: n inputs -> 1 output via a torch function.

    The rebuild of MXNET_REGISTER_SIMPLE_OP: register the kernel once,
    get both the NDArray function and the Symbol op, on every device.
    """

    def __init__(self, name, fn, nin=1, shape_rule="same", dtype_rule="same",
                 param_cls=None, arg_names=None, is_loss=False, backward_fn=None,
                 need_rng=False):
        self.name = name
        self.fn = fn
        self.nin = nin
        self.shape_rule = shape_rule
        self.dtype_rule = dtype_rule
        self.param_cls = param_cls
        self.arg_names = arg_names or (["data"] if nin == 1 else
                                       ["lhs", "rhs", "mhs"][:nin])
        self.is_loss = is_loss
        self.backward_fn = backward_fn
        self.has_backward = backward_fn is not None
        self.need_rng = need_rng

    def list_arguments(self, params):
        return list(self.arg_names)

    def infer_shape(self, params, in_shapes):
        known = [s for s in in_shapes if s is not None]
        if not known:
            raise ValueError(f"{self.name}: no input shape known")
        rule = self.shape_rule
        if callable(rule):
            out = rule(params, in_shapes)
            if isinstance(out, tuple) and len(out) == 2:
                in_shapes, out_shape = out
            else:
                out_shape = out
            return list(in_shapes), [tuple(out_shape)], []
        if rule == "same":
            ref = known[0]
            return [ref if s is None else s for s in in_shapes], [tuple(ref)], []
        if rule == "broadcast":
            ref = tuple(np.broadcast_shapes(*known))
            return list(in_shapes), [ref], []
        raise ValueError(f"bad shape rule {rule!r}")

    def infer_dtype(self, params, in_dtypes):
        if callable(self.dtype_rule):
            return self.dtype_rule(params, in_dtypes)
        dt = next((d for d in in_dtypes if d is not None), np.dtype(np.float32))
        return [d if d is not None else dt for d in in_dtypes], [dt], []

    def forward(self, params, inputs, aux, train, key):
        if self.need_rng:
            out = self.fn(params, *inputs, key=key) if params is not None or self.param_cls \
                else self.fn(*inputs, key=key)
        elif self.param_cls is not None:
            out = self.fn(params, *inputs)
        else:
            out = self.fn(*inputs)
        return [out], []

    def backward(self, params, out_grads, inputs, outputs):
        if self.backward_fn is None:
            return None
        return self.backward_fn(params, out_grads, inputs, outputs)


def register_simple_op(name, fn, nin=1, aliases=(), **kw):
    op = SimpleOpDef(name, fn, nin=nin, **kw)
    OP_REGISTRY.register(name, op, aliases=aliases)
    return op


def as_np_dtype(d):
    return None if d is None else np_dtype(d)


def not_ported(what, item):
    """The error an op or option that a later slice ports raises."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP §{item})")


class RngKey(NamedTuple):
    """What a random op draws from: a seed and the device to draw on.
    The same key gives the same draws, so a replayed forward
    (mirroring, ``partial_forward``, an explicit-head backward)
    reproduces its random values."""

    seed: int
    device: torch.device

    def generator(self):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.seed))
        return gen


class _Custom(torch.autograd.Function):
    """An op with an explicit ``backward``: forward under no grad, the
    op's own backward for the inputs' gradients."""

    @staticmethod
    def forward(ctx, op, params, *inputs):
        outs, _ = op.forward(params, list(inputs), [], True, None)
        # an output that is an input (identity forwards) gets its own
        # storage, as autograd wants a Function's outputs to be new
        outs = [o.clone() if any(o is x for x in inputs) else o
                for o in outs]
        ctx.op, ctx.params = op, params
        ctx.save_for_backward(*inputs, *outs)
        ctx.n_in = len(inputs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gouts):
        saved = ctx.saved_tensors
        inputs, outs = list(saved[:ctx.n_in]), list(saved[ctx.n_in:])
        gins = ctx.op.backward(ctx.params, list(gouts), inputs, outs)
        gins = [g if x.is_floating_point() else None
                for g, x in zip(gins, inputs)]
        return (None, None, *gins)


def apply_op(op, params, inputs, aux, train, key):
    """``op.forward``, through :class:`_Custom` when the op declares its
    own backward and a gradient is wanted."""
    if op.has_backward and torch.is_grad_enabled() and any(
            x.requires_grad for x in inputs):
        return list(_Custom.apply(op, params, *inputs)), list(aux)
    return op.forward(params, inputs, aux, train, key)
