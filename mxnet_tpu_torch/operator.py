"""Custom operators defined in Python.

The port of ``mxnet_tpu/operator.py`` (the reference's
python/mxnet/operator.py: ``CustomOp``/``CustomOpProp`` and ``register``,
and the legacy ``NumpyOp``/``NDArrayOp`` callback classes).  A custom
op's ``forward`` and ``backward`` are host callbacks: the inputs are
copied to the host, the user's numpy code fills the outputs, and the
outputs are copied back to the inputs' device.  In a graph the op runs
through ``ops.op.apply_op``'s ``torch.autograd.Function``, so its
``backward`` gives the gradients of its inputs.  The callbacks run under
the CPU context: an ``nd.array`` made inside one is a host array.

The op declares shapes and dtypes through a ``CustomOpProp`` exactly as
in the reference, so graph inference composes.  The head gradient that
reaches a custom op at a graph head is the executor's (ones, unless
``backward`` is given head gradients), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError, np_dtype, torch_dtype
from .context import cpu
from .ops.op import OP_REGISTRY, OpDef
from .registry import Registry

__all__ = ["CustomOp", "CustomOpProp", "register", "PythonOp", "NumpyOp",
           "NDArrayOp", "get_all_registered_operators"]

_CUSTOM_REGISTRY = Registry("custom-op")


class _HostArray(np.ndarray):
    """Buffer handed to custom-op callbacks: a numpy array with the
    NDArray reading surface reference custom ops use (``asnumpy``,
    ``wait_to_read``, ``context``)."""

    def asnumpy(self):
        return np.asarray(self)

    def wait_to_read(self):
        return self

    def wait_to_write(self):
        return self

    @property
    def context(self):
        return cpu()


def _host_array(a):
    return np.ascontiguousarray(a).view(_HostArray)


def _to_host(t):
    from .ndarray import _host

    return _host_array(_host(t))


def _to_device(a, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


class CustomOp:
    """Base class for custom op execution (operator.py CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        elif req == "null":
            pass
        else:
            raise MXNetError(f"invalid req {req!r}")


class CustomOpProp:
    """Metadata for a custom op (operator.py CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        """Ids of blobs backward needs (the reference's default).
        Informational: the backward receives every input, output and
        head gradient."""
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, shapes, dtypes):
        raise NotImplementedError


class _CustomOpDef(OpDef):
    """A CustomOpProp as a registry op whose forward and backward are
    host callbacks."""

    def __init__(self, name, prop_cls):
        self.name = name
        self.prop_cls = prop_cls
        self.param_cls = None
        self.has_backward = True
        self.is_loss = False

    def make_params(self, kwargs):
        return self.prop_cls(**kwargs)

    def list_arguments(self, prop):
        return list(prop.list_arguments())

    def list_outputs(self, prop):
        return list(prop.list_outputs())

    def list_auxiliary_states(self, prop):
        return list(prop.list_auxiliary_states())

    def infer_shape(self, prop, in_shapes):
        ins, outs, auxs = prop.infer_shape(list(in_shapes))
        return list(ins), [tuple(o) for o in outs], [tuple(a) for a in auxs]

    def infer_dtype(self, prop, in_dtypes):
        # float32 where nothing is known (the reference's assumption)
        filled = [d if d is not None else np.dtype(np.float32)
                  for d in in_dtypes]
        ins, outs, auxs = prop.infer_type(filled)
        return list(ins), list(outs), list(auxs)

    def _operator(self, prop, inputs):
        shapes = [tuple(x.shape) for x in inputs]
        dtypes = [np_dtype(x.dtype) for x in inputs]
        return prop.create_operator(None, shapes, dtypes), shapes, dtypes

    def forward(self, prop, inputs, aux, train, key):
        op, shapes, dtypes = self._operator(prop, inputs)
        _, out_shapes, _ = self.infer_shape(prop, shapes)
        _, out_dtypes, _ = self.infer_dtype(prop, dtypes)
        in_data = [_to_host(x) for x in inputs]
        out_data = [_host_array(np.zeros(s, d))
                    for s, d in zip(out_shapes, out_dtypes)]
        with cpu():
            op.forward(is_train=train, req=["write"] * len(out_data),
                       in_data=in_data, out_data=out_data, aux=[])
        dev = inputs[0].device
        return [_to_device(o, torch_dtype(d), dev)
                for o, d in zip(out_data, out_dtypes)], list(aux)

    def backward(self, prop, out_grads, inputs, outputs):
        op, _, _ = self._operator(prop, inputs)
        in_data = [_to_host(x) for x in inputs]
        out_data = [_to_host(o) for o in outputs]
        ograds = [_to_host(g) for g in out_grads]
        in_grad = [_host_array(np.zeros(d.shape, d.dtype)) for d in in_data]
        with cpu():
            op.backward(req=["write"] * len(in_data), out_grad=ograds,
                        in_data=in_data, out_data=out_data, in_grad=in_grad,
                        aux=[])
        return [_to_device(g, x.dtype, x.device)
                for g, x in zip(in_grad, inputs)]


def register(reg_name):
    """Register a CustomOpProp subclass under a name usable from
    ``nd.``/``sym.`` (and ``Custom(op_type=reg_name)``)."""

    def do_register(prop_cls):
        opdef = _CustomOpDef(reg_name, prop_cls)
        OP_REGISTRY.register(reg_name, opdef)
        _CUSTOM_REGISTRY.register(reg_name, prop_cls)
        from . import ndarray as nd_mod
        from . import symbol as sym_mod

        setattr(nd_mod, reg_name, nd_mod._make_ndarray_function(reg_name))
        setattr(sym_mod, reg_name, sym_mod._make_symbol_function(reg_name))
        return prop_cls

    return do_register


def get_all_registered_operators():
    return OP_REGISTRY.list()


class PythonOp:
    """Base class of legacy python operators (reference operator.py
    PythonOp): a callable symbol factory with need_top_grad metadata.
    Subclasses: NumpyOp (numpy-buffer callbacks), NDArrayOp."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad
        self._registered = None

    def need_top_grad(self):
        return self.need_top_grad_

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def forward(self, in_data, out_data):
        raise NotImplementedError

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError

    def _ensure_registered(self):
        if self._registered:
            return self._registered
        legacy = self
        name = f"_numpy_op_{type(self).__name__}_{id(self):x}"

        class _Prop(CustomOpProp):
            def __init__(self):
                super().__init__(need_top_grad=legacy.need_top_grad_)

            def list_arguments(self):
                return legacy.list_arguments()

            def list_outputs(self):
                return legacy.list_outputs()

            def infer_shape(self, in_shape):
                ins, outs = legacy.infer_shape(in_shape)
                return ins, outs, []

            def create_operator(self, ctx, shapes, dtypes):
                # legacy callbacks mutate writable numpy copies in place
                def _buf(x):
                    return np.array(x.asnumpy())

                class _Op(CustomOp):
                    def forward(self, is_train, req, in_data, out_data, aux):
                        ins = [_buf(d) for d in in_data]
                        outs = [_buf(o) for o in out_data]
                        legacy.forward(in_data=ins, out_data=outs)
                        for dst, src in zip(out_data, outs):
                            dst[:] = src

                    def backward(self, req, out_grad, in_data, out_data,
                                 in_grad, aux):
                        ogs = [_buf(g) for g in out_grad]
                        ins = [_buf(d) for d in in_data]
                        outs = [_buf(o) for o in out_data]
                        igs = [_buf(g) for g in in_grad]
                        legacy.backward(out_grad=ogs, in_data=ins,
                                        out_data=outs, in_grad=igs)
                        for dst, src in zip(in_grad, igs):
                            dst[:] = src

                return _Op()

        register(name)(_Prop)
        self._registered = name
        return name

    def __call__(self, *args, **kwargs):
        return self.get_symbol(*args, **kwargs)

    def get_symbol(self, *args, **kwargs):
        from . import symbol as sym_mod

        name = self._ensure_registered()
        return getattr(sym_mod, name)(*args, **kwargs)


class NumpyOp(PythonOp):
    """Legacy callback op over numpy buffers (reference operator.py
    NumpyOp).  Subclass and call ``get_symbol``."""


class NDArrayOp(PythonOp):
    """Legacy callback op (reference operator.py NDArrayOp); its
    callbacks receive numpy buffers, as NumpyOp's."""

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        """Ids of blobs backward needs (reference operator.py:372-393);
        informational, as CustomOpProp's."""
        deps = []
        if self.need_top_grad():
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps
