"""Matrix / shape-manipulation operators: the port of
``mxnet_tpu/ops/matrix.py`` (dot, batch_dot, transpose, expand_dims,
crop/slice, slice_axis, flip, Reshape, Flatten, Concat, SliceChannel,
SwapAxis, Cast, Pad, Crop, tile, one_hot), with torch kernels for its
jnp ones.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import np_dtype, torch_dtype
from ..param import Params, field, tuple_of
from .op import OpDef, register_op, register_simple_op


# -- dot / batch_dot ---------------------------------------------------------
class DotParam(Params):
    transpose_a = field(bool, default=False)
    transpose_b = field(bool, default=False)


def _dot_shape(params, in_shapes):
    a, b = in_shapes
    if a is None or b is None:
        raise ValueError("dot: input shapes unknown")
    am = a[::-1] if params.transpose_a else a
    bm = b[::-1] if params.transpose_b else b
    if len(a) == 1 and len(b) == 1:
        return in_shapes, (1,)
    if am[-1] != bm[0]:
        raise ValueError(f"dot: shape mismatch {a} x {b}")
    return in_shapes, tuple(am[:-1]) + tuple(bm[1:])


def _t(x):
    return x.permute(*reversed(range(x.dim())))


def _dot(p, a, b):
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b).reshape(1)
    am = _t(a) if p.transpose_a else a
    bm = _t(b) if p.transpose_b else b
    if am.dim() <= 2 and bm.dim() <= 2:
        return am @ bm
    return torch.tensordot(am, bm, dims=1)


register_simple_op("dot", _dot, nin=2, param_cls=DotParam, shape_rule=_dot_shape)


def _batch_dot_shape(params, in_shapes):
    a, b = in_shapes
    am = (a[0], a[2], a[1]) if params.transpose_a else a
    bm = (b[0], b[2], b[1]) if params.transpose_b else b
    if am[0] != bm[0] or am[2] != bm[1]:
        raise ValueError(f"batch_dot: shape mismatch {a} x {b}")
    return in_shapes, (am[0], am[1], bm[2])


def _batch_dot(p, a, b):
    am = a.transpose(1, 2) if p.transpose_a else a
    bm = b.transpose(1, 2) if p.transpose_b else b
    return torch.bmm(am, bm)


register_simple_op("batch_dot", _batch_dot, nin=2, param_cls=DotParam,
                   shape_rule=_batch_dot_shape)


# -- transpose / swapaxes / expand_dims / flip -------------------------------
class TransposeParam(Params):
    axes = field(tuple_of(int), default=None, doc="permutation; None reverses")


def _transpose_shape(p, in_shapes):
    s = in_shapes[0]
    axes = p.axes if p.axes else tuple(reversed(range(len(s))))
    return in_shapes, tuple(s[a] for a in axes)


register_simple_op("transpose", lambda p, x: x.permute(*(p.axes or reversed(range(x.dim())))),
                   nin=1, param_cls=TransposeParam, shape_rule=_transpose_shape)


class SwapAxisParam(Params):
    dim1 = field(int, default=0)
    dim2 = field(int, default=0)


def _swap_shape(p, in_shapes):
    s = list(in_shapes[0])
    s[p.dim1], s[p.dim2] = s[p.dim2], s[p.dim1]
    return in_shapes, tuple(s)


register_simple_op("SwapAxis", lambda p, x: x.transpose(p.dim1, p.dim2),
                   nin=1, param_cls=SwapAxisParam, shape_rule=_swap_shape,
                   aliases=("swapaxes",))


class ExpandDimsParam(Params):
    axis = field(int, required=True)


register_simple_op(
    "expand_dims", lambda p, x: x.unsqueeze(p.axis if p.axis >= 0 else p.axis + x.dim() + 1), nin=1,
    param_cls=ExpandDimsParam,
    shape_rule=lambda p, s: (s, tuple(np.expand_dims(np.empty(s[0]), p.axis).shape)))


class FlipParam(Params):
    axis = field(int, required=True)


register_simple_op("flip", lambda p, x: torch.flip(x, (p.axis,)), nin=1,
                   param_cls=FlipParam, shape_rule="same")


# -- slice_axis / crop -------------------------------------------------------
class SliceAxisParam(Params):
    axis = field(int, required=True)
    begin = field(int, required=True)
    end = field(int, default=None, doc="None means to the end")


def _slice_axis_shape(p, in_shapes):
    s = list(in_shapes[0])
    ax = p.axis % len(s)
    begin = p.begin % s[ax] if p.begin < 0 else p.begin
    end = s[ax] if p.end is None else (p.end % s[ax] if p.end < 0 else p.end)
    s[ax] = end - begin
    return in_shapes, tuple(s)


def _slice_axis(p, x):
    ax = p.axis % x.dim()
    begin = p.begin % x.shape[ax] if p.begin < 0 else p.begin
    end = x.shape[ax] if p.end is None else (p.end % x.shape[ax] if p.end < 0 else p.end)
    return x.narrow(ax, begin, end - begin)


register_simple_op("slice_axis", _slice_axis, nin=1, param_cls=SliceAxisParam,
                   shape_rule=_slice_axis_shape)


class SliceParam(Params):
    begin = field(tuple_of(int), required=True)
    end = field(tuple_of(int), required=True)


def _slice_shape(p, in_shapes):
    out = tuple(e - b for b, e in zip(p.begin, p.end))
    return in_shapes, out


register_simple_op(
    "slice", lambda p, x: x[tuple(slice(b, e) for b, e in zip(p.begin, p.end))],
    nin=1, param_cls=SliceParam, shape_rule=_slice_shape, aliases=("crop_like",))


def _check_crop_region(begin, end, shape, opname):
    if not (len(begin) == len(end) == len(shape)):
        raise ValueError(f"{opname}: begin/end ndim must match data ndim")
    for b, e, d in zip(begin, end, shape):
        if not (0 <= b <= e <= d):
            raise ValueError(
                f"{opname}: region [{begin}, {end}) out of bounds for {shape}")


def _crop_assign_shape(p, in_shapes):
    lhs, rhs = in_shapes
    if lhs is None:
        raise ValueError("_crop_assign: lhs shape unknown")
    _check_crop_region(p.begin, p.end, lhs, "_crop_assign")
    want = tuple(e - b for b, e in zip(p.begin, p.end))
    if rhs is not None and tuple(rhs) != want:
        raise ValueError(f"_crop_assign: rhs shape {rhs} != region {want}")
    return [lhs, want], tuple(lhs)


def _crop_assign(p, lhs, rhs):
    # Functional form of the reference's inplace region write
    # (matrix_op-inl.h:453 CropAssign): returns lhs with [begin, end)
    # overwritten by rhs.
    _check_crop_region(p.begin, p.end, tuple(lhs.shape), "_crop_assign")
    want = tuple(e - b for b, e in zip(p.begin, p.end))
    if tuple(rhs.shape) != want:
        raise ValueError(
            f"_crop_assign: rhs shape {tuple(rhs.shape)} != region {want}")
    out = lhs.clone()
    out[tuple(slice(b, e) for b, e in zip(p.begin, p.end))] = rhs.to(lhs.dtype)
    return out


register_simple_op("_crop_assign", _crop_assign, nin=2,
                   param_cls=SliceParam, shape_rule=_crop_assign_shape,
                   aliases=("_slice_assign",))


class CropAssignScalarParam(Params):
    begin = field(tuple_of(int), required=True)
    end = field(tuple_of(int), required=True)
    scalar = field(float, default=0.0, doc="value written into the region")


def _crop_assign_scalar(p, x):
    # matrix_op-inl.h:535 CropAssignScalar
    _check_crop_region(p.begin, p.end, tuple(x.shape), "_crop_assign_scalar")
    out = x.clone()
    out[tuple(slice(b, e) for b, e in zip(p.begin, p.end))] = p.scalar
    return out


def _crop_assign_scalar_shape(p, in_shapes):
    if in_shapes[0] is None:
        raise ValueError("_crop_assign_scalar: input shape unknown")
    _check_crop_region(p.begin, p.end, in_shapes[0], "_crop_assign_scalar")
    return in_shapes, tuple(in_shapes[0])


register_simple_op("_crop_assign_scalar", _crop_assign_scalar, nin=1,
                   param_cls=CropAssignScalarParam,
                   shape_rule=_crop_assign_scalar_shape,
                   aliases=("_slice_assign_scalar",))


# -- Reshape / Flatten -------------------------------------------------------
class ReshapeParam(Params):
    shape = field(tuple_of(int), default=None,
                  doc="target shape; 0 copies input dim, -1 infers one dim, "
                      "-2 copies all remaining dims, -3 merges two "
                      "consecutive dims, -4 splits one dim into the next "
                      "two spec entries")
    reverse = field(bool, default=False,
                    doc="match the special codes from the right")
    target_shape = field(tuple_of(int), default=None,
                         doc="legacy alias; 0 infers the remainder")
    keep_highest = field(bool, default=False,
                         doc="legacy: ignore target_shape[0] and keep the "
                             "input's first dim unchanged")


def _apply_reshape_codes(src, spec):
    """Reference InferReshapeShape (reshape-inl.h): resolve the 0/-1/-2/
    -3/-4 codes of ``spec`` against input shape ``src``."""
    out = []
    i = 0  # cursor into src; advanced by the consuming codes
    j = 0
    infer_at = None
    while j < len(spec):
        d = spec[j]
        if d in (0, -3, -4) and i >= len(src):
            raise ValueError(
                f"Reshape: code {d} at position {j} consumes input dim "
                f"{i}, but the input has only {len(src)} dims")
        if d == -3 and i + 1 >= len(src):
            raise ValueError(
                f"Reshape: -3 at position {j} merges input dims {i} and "
                f"{i + 1}, but the input has only {len(src)} dims")
        if d == 0:
            out.append(src[i])
            i += 1
        elif d == -1:
            if infer_at is not None:
                raise ValueError("Reshape: at most one -1 allowed")
            infer_at = len(out)
            out.append(1)
            i += 1
        elif d == -2:
            out.extend(src[i:])
            i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif d == -4:
            if j + 2 >= len(spec):
                raise ValueError(
                    "Reshape: -4 needs two following entries in the spec")
            d1, d2 = spec[j + 1], spec[j + 2]
            if (d1 == -1 and d2 == -1) or d1 == 0 or d2 == 0 \
                    or d1 < -1 or d2 < -1:
                raise ValueError(
                    f"Reshape: -4 operands must be positive with at most "
                    f"one -1, got ({d1}, {d2})")
            whole = src[i]
            if d1 == -1:
                d1 = whole // d2
            if d2 == -1:
                d2 = whole // d1
            if d1 * d2 != whole:
                raise ValueError(
                    f"Reshape: -4 cannot split {whole} into ({spec[j+1]}, "
                    f"{spec[j+2]})")
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(d)
            i += 1
        j += 1
    return out, infer_at


def _resolve_reshape(p, in_shape):
    in_shape = tuple(in_shape)
    total = int(np.prod(in_shape)) if in_shape else 1
    if p.shape is not None:
        spec = list(p.shape)
        if p.reverse:
            out, infer_at = _apply_reshape_codes(in_shape[::-1], spec[::-1])
            out = out[::-1]
            if infer_at is not None:
                infer_at = len(out) - 1 - infer_at
        else:
            out, infer_at = _apply_reshape_codes(in_shape, spec)
    elif p.target_shape is not None:
        # legacy API: 0 infers the remaining elements
        out = list(p.target_shape)
        if p.keep_highest:
            out[0] = in_shape[0]
        infer_at = out.index(0) if 0 in out else None
        if infer_at is not None:
            out[infer_at] = 1
    else:
        raise ValueError("Reshape: no target shape")
    spec_desc = p.shape if p.shape is not None else p.target_shape
    if infer_at is not None:
        known = int(np.prod(out)) or 1
        if total % known:
            raise ValueError(f"Reshape: cannot infer dim reshaping "
                             f"{in_shape} with {tuple(spec_desc)}")
        out[infer_at] = total // known
    if int(np.prod(out) if out else 1) != total:
        raise ValueError(f"Reshape: cannot reshape {in_shape} to "
                         f"{tuple(spec_desc)}")
    return tuple(out)


register_simple_op(
    "Reshape", lambda p, x: x.reshape(_resolve_reshape(p, tuple(x.shape))), nin=1,
    param_cls=ReshapeParam,
    shape_rule=lambda p, s: (s, _resolve_reshape(p, s[0])), aliases=("reshape",))

register_simple_op(
    "Flatten", lambda x: x.reshape(x.shape[0], -1), nin=1,
    shape_rule=lambda p, s: (s, (s[0][0], int(np.prod(s[0][1:])) if len(s[0]) > 1 else 1)),
    aliases=("flatten",))


# -- Cast --------------------------------------------------------------------
class CastParam(Params):
    dtype = field(str, required=True, doc="target dtype name")


def _cast_dtype(p, in_dtypes):
    ins = [d if d is not None else np.dtype(np.float32) for d in in_dtypes]
    return ins, [np_dtype(p.dtype)], []


register_simple_op("Cast", lambda p, x: x.to(torch_dtype(p.dtype)), nin=1,
                   param_cls=CastParam, dtype_rule=_cast_dtype, aliases=("cast",))


# -- Concat / SliceChannel (multi-arity full ops) ----------------------------
class ConcatParam(Params):
    num_args = field(int, required=True, lower=1)
    dim = field(int, default=1, doc="axis to concatenate on")


@register_op("Concat", aliases=("concat",))
class ConcatOp(OpDef):
    key_var_num_args = "num_args"
    param_cls = ConcatParam

    def list_arguments(self, params):
        return [f"arg{i}" for i in range(params.num_args)]

    def infer_shape(self, params, in_shapes):
        known = [s for s in in_shapes if s is not None]
        if not known:
            raise ValueError("Concat: no input shape known")
        ref = list(known[0])
        dim = params.dim % len(ref)
        total = 0
        for s in in_shapes:
            if s is None:
                raise ValueError("Concat: all input shapes required")
            total += s[dim]
        ref[dim] = total
        return list(in_shapes), [tuple(ref)], []

    def forward(self, params, inputs, aux, train, key):
        return [torch.cat(inputs, dim=params.dim)], []


class SliceChannelParam(Params):
    num_outputs = field(int, required=True, lower=1)
    axis = field(int, default=1)
    squeeze_axis = field(bool, default=False)


@register_op("SliceChannel", aliases=("slice_channel", "split"))
class SliceChannelOp(OpDef):
    param_cls = SliceChannelParam

    def list_outputs(self, params):
        return [f"output{i}" for i in range(params.num_outputs)]

    def infer_shape(self, params, in_shapes):
        s = list(in_shapes[0])
        ax = params.axis % len(s)
        if s[ax] % params.num_outputs:
            raise ValueError(f"SliceChannel: dim {s[ax]} not divisible by "
                             f"{params.num_outputs}")
        s[ax] //= params.num_outputs
        if params.squeeze_axis and s[ax] == 1:
            out = tuple(d for i, d in enumerate(s) if i != ax)
        else:
            out = tuple(s)
        return list(in_shapes), [out] * params.num_outputs, []

    def forward(self, params, inputs, aux, train, key):
        x = inputs[0]
        parts = torch.chunk(x, params.num_outputs, dim=params.axis)
        if params.squeeze_axis:
            parts = [p.squeeze(params.axis) for p in parts]
        return list(parts), []


# -- Pad ---------------------------------------------------------------------
class PadParam(Params):
    mode = field(str, default="constant", enum=("constant", "edge", "reflect"))
    pad_width = field(tuple_of(int), required=True,
                      doc="(before, after) per axis, flattened; NCHW 4D uses 8 ints")
    constant_value = field(float, default=0.0)


def _pad_shape(p, in_shapes):
    s = in_shapes[0]
    pw = p.pad_width
    out = tuple(d + pw[2 * i] + pw[2 * i + 1] for i, d in enumerate(s))
    return in_shapes, out


def _pad(p, x):
    # torch.nn.functional.pad takes (before, after) pairs last axis first
    pw = []
    for i in reversed(range(x.dim())):
        pw += [p.pad_width[2 * i], p.pad_width[2 * i + 1]]
    if p.mode == "constant":
        return torch.nn.functional.pad(x, pw, value=p.constant_value)
    # edge/reflect pad the spatial axes only (the leading two are zero)
    mode = {"edge": "replicate", "reflect": "reflect"}[p.mode]
    return torch.nn.functional.pad(x, pw[:2 * (x.dim() - 2)], mode=mode)


register_simple_op("Pad", _pad, nin=1, param_cls=PadParam, shape_rule=_pad_shape,
                   aliases=("pad",))


# -- Crop (spatial center/offset crop, src/operator/crop-inl.h) --------------
class CropParam(Params):
    num_args = field(int, default=1)
    offset = field(tuple_of(int), default=(0, 0))
    h_w = field(tuple_of(int), default=(0, 0))
    center_crop = field(bool, default=False)


@register_op("Crop")
class CropOp(OpDef):
    key_var_num_args = "num_args"
    param_cls = CropParam

    def list_arguments(self, params):
        return ["data"] if params.num_args == 1 else ["data", "crop_like"]

    def _target_hw(self, params, in_shapes):
        if params.num_args == 2:
            return in_shapes[1][2], in_shapes[1][3]
        return params.h_w

    def infer_shape(self, params, in_shapes):
        n, c = in_shapes[0][0], in_shapes[0][1]
        h, w = self._target_hw(params, in_shapes)
        return list(in_shapes), [(n, c, h, w)], []

    def forward(self, params, inputs, aux, train, key):
        x = inputs[0]
        if params.num_args == 2:
            th, tw = inputs[1].shape[2], inputs[1].shape[3]
        else:
            th, tw = params.h_w
        if params.center_crop:
            oh = (x.shape[2] - th) // 2
            ow = (x.shape[3] - tw) // 2
        else:
            oh, ow = params.offset
        return [x[:, :, oh:oh + th, ow:ow + tw]], []


# -- tile / repeat (convenience parity) --------------------------------------
class TileParam(Params):
    reps = field(tuple_of(int), required=True)


register_simple_op(
    "tile", lambda p, x: torch.tile(x, p.reps), nin=1, param_cls=TileParam,
    shape_rule=lambda p, s: (s, tuple(np.tile(np.empty(s[0], dtype=np.int8), p.reps).shape)))


class OneHotParam(Params):
    depth = field(int, required=True)
    on_value = field(float, default=1.0)
    off_value = field(float, default=0.0)


register_simple_op(
    "one_hot",
    lambda p, x: torch.where(
        torch.arange(p.depth, device=x.device) == x.long()[..., None],
        p.on_value, p.off_value).to(torch.float32),
    nin=1, param_cls=OneHotParam,
    shape_rule=lambda p, s: (s, tuple(s[0]) + (p.depth,)))
