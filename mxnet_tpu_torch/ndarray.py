"""Imperative NDArray: the port of ``mxnet_tpu/ndarray.py``.

An :class:`NDArray` wraps one ``torch.Tensor`` on the device of its
:class:`~mxnet_tpu_torch.context.Context`.  Ops run eagerly on it (torch
launches asynchronously on CUDA, as the reference's dispatch did);
``wait_to_read`` synchronizes the device.  Writes (``arr[:] = v``,
``+=``, ``copyto``) go into the tensor in place, so every holder of the
array (an executor, a module's parameter dict, an optimizer state) sees
them.

The module-level op functions (``dot``, ``FullyConnected``, ...) are
generated at import time from the op registry, as the reference does.
``save``/``load`` read and write the reference's npz format, including
its ``__bf16__:`` uint16 encoding of bfloat16 arrays; ``asnumpy`` of a
bfloat16 array is float32 holding the same values (the port loads no
ml_dtypes).
"""

from __future__ import annotations

import builtins
import sys

import numpy as np
import torch

from . import random as _random
from .base import MXNetError, np_dtype, numeric_types, torch_dtype
from .context import Context, cpu, current_context
from .ops import OP_REGISTRY
from .ops.op import apply_op

__all__ = [
    "NDArray", "array", "empty", "zeros", "ones", "full", "arange",
    "concatenate", "save", "load", "imperative_invoke", "onehot_encode",
    "choose_element_0index", "fill_element_0index", "waitall",
    "add", "subtract", "multiply", "divide", "true_divide",
]

# Generated op functions (sum, max, slice, abs, ...) shadow builtins in this
# module's namespace; keep safe references for internal use.
_pyslice = slice
_pysum = sum


def _host(t):
    """A tensor's values as a new numpy array (bfloat16 as float32),
    never a view of the tensor's storage: a later in-place update of
    the array leaves it as it was, as the reference's copy to the host
    does."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy()
    if t.device.type == "cpu":
        return t.numpy().copy()
    return t.cpu().numpy()


class NDArray:
    """Multi-dimensional array on a device context."""

    __slots__ = ("_data", "_ctx", "writable")

    def __init__(self, data, ctx=None, writable=True):
        if ctx is None:
            ctx = current_context()
        self._ctx = ctx
        self._data = data
        self.writable = writable

    # -- core properties ---------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def context(self) -> Context:
        return self._ctx

    @property
    def T(self):
        return transpose(self)  # noqa: F821 (generated below)

    # -- sync / host transfer ----------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    wait_to_write = wait_to_read

    def asnumpy(self) -> np.ndarray:
        return _host(self._data)

    def __array__(self, dtype=None, copy=None):
        if copy is False:
            raise ValueError("NDArray cannot be converted to numpy "
                             "without a copy; use np.asarray(arr) instead")
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def asscalar(self):
        if self.size != 1:
            raise ValueError("the array is not scalar-sized")
        return self.asnumpy().reshape(())[()]

    def astype(self, dtype):
        return NDArray(self._data.to(torch_dtype(dtype)), self._ctx)

    # -- copies ------------------------------------------------------------
    def copyto(self, other):
        """Copy into another NDArray (in place) or to a Context (a new
        array)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise ValueError(f"copyto shape mismatch {self.shape} vs {other.shape}")
            other._check_writable()
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device(), copy=True),
                           other)
        raise TypeError(f"copyto does not support {type(other)}")

    def as_in_context(self, ctx: Context):
        if ctx == self._ctx:
            return self
        return self.copyto(ctx)

    def copy(self):
        return NDArray(self._data.clone(), self._ctx)

    def reshape(self, shape):
        if isinstance(shape, (int, np.integer)):
            shape = (shape,)
        return NDArray(self._data.reshape(tuple(shape)), self._ctx)

    def broadcast_to(self, shape):
        """Broadcast to ``shape``, allowing only size-1 dims to grow."""
        cur = self.shape
        if len(cur) != len(shape):
            cur = (1,) * (len(shape) - len(cur)) + tuple(cur)
        for c, t in zip(cur, shape):
            if c != t and c != 1:
                raise ValueError(
                    f"cannot broadcast {self.shape} to {tuple(shape)}: only "
                    "size-1 dimensions may be expanded")
        return NDArray(torch.broadcast_to(self._data.reshape(cur),
                                          tuple(shape)), self._ctx)

    # -- mutation ----------------------------------------------------------
    def _check_writable(self):
        if not self.writable:
            raise MXNetError("trying to write to a read-only NDArray")

    def _set(self, data):
        """Rebind the array to ``data`` (a tensor of its shape)."""
        self._check_writable()
        self._data = data
        return self

    def _as_value(self, value):
        if isinstance(value, NDArray):
            return value._data
        if isinstance(value, numeric_types):
            return value
        if isinstance(value, torch.Tensor):
            return value
        from .convert import to_tensor
        return to_tensor(np.asarray(value), self._data.device)

    def __setitem__(self, key, value):
        self._check_writable()
        value = self._as_value(value)
        with torch.no_grad():
            if isinstance(key, _pyslice) and key == _pyslice(None):
                if isinstance(value, numeric_types):
                    self._data.fill_(value)
                else:
                    self._data.copy_(torch.broadcast_to(
                        value.to(self._data.device), self._data.shape))
            else:
                if isinstance(value, torch.Tensor):
                    value = value.to(self._data.device, self._data.dtype)
                self._data[key] = value

    def __getitem__(self, key):
        return NDArray(self._data[key], self._ctx)

    # -- python protocol ---------------------------------------------------
    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return f"<NDArray {'x'.join(map(str, self.shape))} @{self._ctx}>"

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    # -- arithmetic --------------------------------------------------------
    def __add__(self, other):
        return _ufunc(self, other, "_plus", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return _ufunc(self, other, "_minus", "_minus_scalar")

    def __rsub__(self, other):
        return _ufunc(self, other, None, "_rminus_scalar")

    def __mul__(self, other):
        return _ufunc(self, other, "_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _ufunc(self, other, "_div", "_div_scalar")

    def __rtruediv__(self, other):
        return _ufunc(self, other, None, "_rdiv_scalar")

    def __pow__(self, other):
        return _ufunc(self, other, "_power", "_power_scalar")

    def __rpow__(self, other):
        return _ufunc(self, other, None, "_rpower_scalar")

    def __neg__(self):
        return imperative_invoke("negative", [self], {})[0]

    def _inplace(self, result):
        self._check_writable()
        with torch.no_grad():
            self._data.copy_(result._data)
        return self

    def __iadd__(self, other):
        return self._inplace(self + other)

    def __isub__(self, other):
        return self._inplace(self - other)

    def __imul__(self, other):
        return self._inplace(self * other)

    def __itruediv__(self, other):
        return self._inplace(self / other)

    def __eq__(self, other):
        return _ufunc(self, other, "_equal", "_equal_scalar")

    def __ne__(self, other):
        return _ufunc(self, other, "_not_equal", "_not_equal_scalar")

    def __gt__(self, other):
        return _ufunc(self, other, "_greater", "_greater_scalar")

    def __ge__(self, other):
        return _ufunc(self, other, "_greater_equal", "_greater_equal_scalar")

    def __lt__(self, other):
        return _ufunc(self, other, "_lesser", "_lesser_scalar")

    def __le__(self, other):
        return _ufunc(self, other, "_lesser_equal", "_lesser_equal_scalar")

    __hash__ = object.__hash__


def _ufunc(lhs, rhs, op_name, scalar_op_name):
    if isinstance(rhs, NDArray):
        if op_name is None:
            raise TypeError("operation not supported between two NDArrays")
        return imperative_invoke(op_name, [lhs, rhs], {})[0]
    if isinstance(rhs, numeric_types):
        return imperative_invoke(scalar_op_name, [lhs], {"scalar": float(rhs)})[0]
    raise TypeError(f"unsupported operand type {type(rhs)}")


# -- imperative dispatch -----------------------------------------------------
def imperative_invoke(op_name, inputs, kwargs, out=None, ctx=None, train=True):
    """Invoke a registered op on NDArrays, eagerly, without gradient
    tracking."""
    op = OP_REGISTRY.get(op_name)
    kv = op.key_var_num_args
    if kv and kv not in kwargs and inputs:
        kwargs = {**kwargs, kv: len(inputs)}
    params = op.make_params(kwargs)
    if inputs:
        ctx = _check_same_context(op_name, inputs)
    elif ctx is None:
        ctx = current_context()
    dev = ctx.torch_device()
    key = _random.next_key(dev) if op.need_rng else None
    with torch.no_grad():
        raw, _ = apply_op(op, params, [a._data for a in inputs], [], train,
                          key)
    results = [NDArray(r, ctx) for r in raw]
    if out is not None:
        outs = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(outs, results):
            dst._check_writable()
            with torch.no_grad():
                dst._data.copy_(src._data)
        return list(outs)
    return results


# -- creation ----------------------------------------------------------------
def _resolve_ctx(ctx):
    return ctx if ctx is not None else current_context()


def _shape(shape):
    return (shape,) if isinstance(shape, (int, np.integer)) else tuple(shape)


def array(source, ctx=None, dtype=None) -> NDArray:
    """An NDArray from any array-like: float32 unless the source already
    carries a non-float64 dtype (the reference's rule)."""
    from .convert import to_tensor

    ctx = _resolve_ctx(ctx)
    if isinstance(source, NDArray):
        t = source._data
    elif isinstance(source, torch.Tensor):
        t = source
    else:
        a = np.asarray(source)
        if dtype is None and (a.dtype == np.float64 or not isinstance(
                source, np.ndarray)):
            a = a.astype(np.float32)
        t = to_tensor(a, torch.device("cpu"))
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    elif isinstance(source, torch.Tensor) and t.dtype == torch.float64:
        t = t.float()
    return NDArray(t.to(ctx.torch_device(), copy=True), ctx)


def empty(shape, ctx=None, dtype=None) -> NDArray:
    return zeros(shape, ctx, dtype)


def zeros(shape, ctx=None, dtype=None) -> NDArray:
    ctx = _resolve_ctx(ctx)
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype or "float32"),
                               device=ctx.torch_device()), ctx)


def ones(shape, ctx=None, dtype=None) -> NDArray:
    ctx = _resolve_ctx(ctx)
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype or "float32"),
                              device=ctx.torch_device()), ctx)


def full(shape, val, ctx=None, dtype=None) -> NDArray:
    ctx = _resolve_ctx(ctx)
    return NDArray(torch.full(_shape(shape), val,
                              dtype=torch_dtype(dtype or "float32"),
                              device=ctx.torch_device()), ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None) -> NDArray:
    ctx = _resolve_ctx(ctx)
    vals = np.arange(start, stop, step, dtype=np_dtype(dtype))
    if repeat > 1:
        vals = np.repeat(vals, repeat)
    return array(vals, ctx=ctx)


def concatenate(arrays, axis=0, always_copy=True) -> NDArray:
    if not arrays:
        raise ValueError("need at least one array")
    if len(arrays) == 1 and not always_copy:
        return arrays[0]
    ctx = arrays[0].context
    return NDArray(torch.cat([a._data for a in arrays], dim=axis), ctx)


def onehot_encode(indices: NDArray, out: NDArray) -> NDArray:
    """Fill out with one-hot rows from indices (reference _onehot_encode)."""
    depth = out.shape[1]
    idx = indices._data.long()
    hot = (torch.arange(depth, device=idx.device) == idx[:, None])
    out._check_writable()
    with torch.no_grad():
        out._data.copy_(hot)
    return out


def _check_same_context(op_name, arrays):
    ctx = arrays[0].context
    for arr in arrays[1:]:
        if arr.context != ctx:
            raise MXNetError(
                f"{op_name}: inputs on different contexts "
                f"({arr.context} vs {ctx}); use copyto/as_in_context")
    return ctx


def _write_out(out, value, ctx):
    if out is not None:
        out._check_writable()
        with torch.no_grad():
            out._data.copy_(value)
        return out
    return NDArray(value, ctx)


def choose_element_0index(lhs: NDArray, rhs: NDArray, out=None) -> NDArray:
    """``lhs[i, rhs[i]]`` for each row i (0-based index;
    src/ndarray/ndarray.cc:728 MatChooseRowElem)."""
    ctx = _check_same_context("choose_element_0index", [lhs, rhs])
    idx = rhs._data.long()
    picked = lhs._data.gather(1, idx[:, None])[:, 0]
    return _write_out(out, picked, ctx)


def fill_element_0index(lhs: NDArray, mhs: NDArray, rhs: NDArray,
                        out=None) -> NDArray:
    """A copy of ``lhs`` with ``[i, rhs[i]] = mhs[i]`` per row i
    (src/ndarray/ndarray.cc:734 MatFillRowElem); written into ``out``
    when given (``out=lhs`` for the in-place form)."""
    ctx = _check_same_context("fill_element_0index", [lhs, mhs, rhs])
    idx = rhs._data.long()
    filled = lhs._data.clone()
    rows = torch.arange(lhs.shape[0], device=idx.device)
    filled[rows, idx] = mhs._data.to(filled.dtype)
    return _write_out(out, filled, ctx)


def _mixed_nd_binary(left, right, op, scalar_op, rscalar_op, py_op, fname):
    """NDArray/Number dispatch of the reference module helpers."""
    if isinstance(left, NDArray) and isinstance(right, NDArray):
        return imperative_invoke(op, [left, right], {})[0]
    if isinstance(left, NDArray) and isinstance(right, numeric_types):
        return imperative_invoke(scalar_op, [left],
                                 {"scalar": float(right)})[0]
    if isinstance(left, numeric_types) and isinstance(right, NDArray):
        return imperative_invoke(rscalar_op, [right],
                                 {"scalar": float(left)})[0]
    if isinstance(left, numeric_types) and isinstance(right, numeric_types):
        return py_op(left, right)
    raise TypeError(
        f"{fname}: types ({type(left)}, {type(right)}) not supported")


def power(lhs, rhs):
    """lhs ** rhs with NDArray/Number operands."""
    return _mixed_nd_binary(lhs, rhs, "_power", "_power_scalar",
                            "_rpower_scalar", lambda a, b: a ** b, "power")


def maximum(lhs, rhs):
    """Elementwise max with NDArray/Number operands."""
    return _mixed_nd_binary(lhs, rhs, "_maximum", "_maximum_scalar",
                            "_maximum_scalar", builtins.max, "maximum")


def minimum(lhs, rhs):
    """Elementwise min with NDArray/Number operands."""
    return _mixed_nd_binary(lhs, rhs, "_minimum", "_minimum_scalar",
                            "_minimum_scalar", builtins.min, "minimum")


def add(lhs, rhs):
    """Elementwise sum, either operand an NDArray or scalar."""
    if isinstance(lhs, NDArray):
        return lhs + rhs
    return rhs + lhs


def subtract(lhs, rhs):
    """Elementwise difference."""
    if isinstance(lhs, NDArray):
        return lhs - rhs
    return rhs.__rsub__(lhs)


def multiply(lhs, rhs):
    """Elementwise product."""
    if isinstance(lhs, NDArray):
        return lhs * rhs
    return rhs * lhs


def divide(lhs, rhs):
    """Elementwise quotient."""
    if isinstance(lhs, NDArray):
        return lhs / rhs
    return rhs.__rtruediv__(lhs)


true_divide = divide


def waitall():
    """Block until all launched work completes."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# -- serialization (the reference's npz format) ------------------------------
_BF16 = "__bf16__:"


def _payload_entry(key, v):
    """(npz key, numpy array) of one value: a bfloat16 tensor as its
    raw bits in uint16 under the ``__bf16__:`` tag."""
    t = v._data if isinstance(v, NDArray) else v
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _BF16 + key, t.view(torch.int16).numpy().view(np.uint16)
        return key, t.numpy()
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":
        return _BF16 + key, a.view(np.uint16)
    return key, a


def save(fname: str, data):
    """Save an NDArray, a list or a str->NDArray dict in the reference's
    npz format (the two-artifact checkpoint's ``.params`` file)."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, (list, tuple)):
        items = [(f"__list__:{i}", a) for i, a in enumerate(data)]
    elif isinstance(data, dict):
        items = list(data.items())
    else:
        raise TypeError("save expects NDArray, list or dict")
    payload = dict(_payload_entry(k, v) for k, v in items)
    with open(fname, "wb") as f:
        np.savez(f, **payload)


def _decode(key, v, ctx):
    if key.startswith(_BF16):
        t = torch.from_numpy(np.ascontiguousarray(v).view(np.int16).copy())
        return key[len(_BF16):], NDArray(
            t.view(torch.bfloat16).to(ctx.torch_device()), ctx)
    return key, array(v, ctx=ctx)


def load(fname: str, ctx=None):
    """Load what :func:`save` (or the reference's ``nd.save``) wrote: a
    list or a dict of NDArrays on ``ctx`` (default the current
    context)."""
    ctx = _resolve_ctx(ctx)
    with np.load(fname, allow_pickle=False) as zf:
        payload = dict(_decode(k, zf[k], ctx) for k in zf.files)
    if payload and all(k.startswith("__list__:") for k in payload):
        items = sorted(payload.items(), key=lambda kv: int(kv[0].split(":")[1]))
        return [v for _, v in items]
    return payload


# -- runtime-generated op functions ------------------------------------------
def _make_ndarray_function(op_name):
    op = OP_REGISTRY.get(op_name)

    def generic_fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        ctx = kwargs.pop("ctx", None)
        inputs = []
        for a in args:
            if isinstance(a, NDArray):
                inputs.append(a)
            elif isinstance(a, (np.ndarray, list, tuple)):
                inputs.append(array(a, ctx=ctx))
            else:
                raise TypeError(f"{op_name}: positional args must be NDArray, got {type(a)}")
        results = imperative_invoke(op_name, inputs, kwargs, out=out, ctx=ctx)
        return results[0] if len(results) == 1 else results

    generic_fn.__name__ = op_name
    generic_fn.__qualname__ = op_name
    generic_fn.__doc__ = (
        f"Imperative op ``{op_name}``"
        + (f"\n{op.param_cls.__doc__}" if op.param_cls else "")
    )
    return generic_fn


def Custom(*args, op_type=None, **kwargs):
    """Generic custom-op invoker (``mt.nd.Custom(..., op_type=name)``):
    dispatches to the CustomOpProp registered under ``op_type``
    (``operator.register``)."""
    if op_type is None:
        raise TypeError("Custom requires op_type=<registered custom op name>")
    if op_type not in OP_REGISTRY:
        raise MXNetError(f"Custom op {op_type!r} is not registered")
    return _make_ndarray_function(op_type)(*args, **kwargs)


def _init_ndarray_module():
    mod = sys.modules[__name__]
    keep = {"power": power, "maximum": maximum, "minimum": minimum}
    for name in OP_REGISTRY.list():
        fn = _make_ndarray_function(name)
        setattr(mod, name, fn)
        canonical = OP_REGISTRY.get(name)
        if canonical.name.lower() == name:
            setattr(mod, canonical.name, fn)  # preserve CamelCase spelling
    for name, fn in keep.items():
        setattr(mod, name, fn)


_init_ndarray_module()
