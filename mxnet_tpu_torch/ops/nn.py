"""Neural-network layer operators.

The port of ``mxnet_tpu/ops/nn.py``.  :func:`FullyConnected` and
:func:`Embedding` are plain functions on tensors (gradients from
autograd), used by ``models.GPT`` and by the ops below.  The registered
ops of the training frontend call them or torch directly: the vision
layers (``Convolution``, ``Deconvolution``, ``Pooling``, ``LRN``,
``UpSampling``, ``InstanceNorm``) as plain torch whose gradients come
from autograd (a convolution goes to cuDNN on the card), ``BatchNorm``
as a ``torch.autograd.Function`` that keeps the reference's one-pass
statistics, its hand-written backward and its moving-statistic rule.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..param import Params, field, tuple_of
from .op import OpDef, register_op

__all__ = ["FullyConnected", "Embedding"]


def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False):
    """y = x @ W.T + b over x flattened to (N, -1); the weight is stored
    (num_hidden, input_dim) and, like the bias, cast to the activations'
    dtype (mixed precision follows the activations)."""
    if num_hidden is not None and weight.shape[0] != num_hidden:
        raise ValueError(f"FullyConnected: weight has {weight.shape[0]} "
                         f"rows, num_hidden={num_hidden}")
    x2 = data.reshape(data.shape[0], -1)
    y = x2 @ weight.to(data.dtype).t()
    if bias is not None and not no_bias:
        y = y + bias.to(data.dtype)
    return y


def Embedding(data, weight, input_dim=None, output_dim=None):
    """Rows of ``weight`` at the integer ids ``data``; the output is in
    the table's dtype.  The backward is autograd's scatter-add into the
    table."""
    if input_dim is not None and weight.shape[0] != input_dim:
        raise ValueError(f"Embedding: table has {weight.shape[0]} rows, "
                         f"input_dim={input_dim}")
    if output_dim is not None and weight.shape[1] != output_dim:
        raise ValueError(f"Embedding: table width {weight.shape[1]}, "
                         f"output_dim={output_dim}")
    return F.embedding(data.long(), weight)


def _pair(t, n=2):
    if t is None:
        return (1,) * n
    if len(t) == 1:
        return t * n
    return tuple(t)


# -- FullyConnected ----------------------------------------------------------
class FullyConnectedParam(Params):
    num_hidden = field(int, required=True, lower=1)
    no_bias = field(bool, default=False)
    flatten = field(bool, default=True)


@register_op("FullyConnected")
class FullyConnectedOp(OpDef):
    """y = x @ W.T + b, the weight stored (num_hidden, input_dim)."""

    param_cls = FullyConnectedParam

    def list_arguments(self, params):
        return ["data", "weight"] if params.no_bias else ["data", "weight", "bias"]

    def infer_shape(self, params, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise ValueError("FullyConnected: data shape unknown")
        in_dim = int(np.prod(data[1:]))
        out = [data[0], params.num_hidden]
        completed = [tuple(data), (params.num_hidden, in_dim)]
        if not params.no_bias:
            completed.append((params.num_hidden,))
        return completed, [tuple(out)], []

    def forward(self, params, inputs, aux, train, key):
        bias = None if params.no_bias else inputs[2]
        return [FullyConnected(inputs[0], inputs[1], bias)], []


class ConvolutionParam(Params):
    kernel = field(tuple_of(int), required=True)
    num_filter = field(int, required=True, lower=1)
    stride = field(tuple_of(int), default=None)
    dilate = field(tuple_of(int), default=None)
    pad = field(tuple_of(int), default=None)
    num_group = field(int, default=1, lower=1)
    no_bias = field(bool, default=False)
    workspace = field(int, default=1024, doc="ignored (XLA owns scratch)")
    cudnn_tune = field(str, default=None, doc="ignored on TPU")
    cudnn_off = field(bool, default=False, doc="ignored on TPU")
    layout = field(str, default="NCHW", enum=("NCHW", "NHWC"))


def _conv_out_dim(d, k, s, p, dil):
    return (d + 2 * p - (dil * (k - 1) + 1)) // s + 1


@register_op("Convolution")
class ConvolutionOp(OpDef):
    """2D convolution (reference convolution-inl.h:489) by
    ``F.conv2d``.  The weight is OIHW in both layouts (checkpoint parity
    with the reference); an NHWC input is viewed as NCHW around the call
    (on the card that view is channels-last memory, which cuDNN takes
    as is) and the output viewed back."""

    param_cls = ConvolutionParam

    def list_arguments(self, params):
        return ["data", "weight"] if params.no_bias else ["data", "weight", "bias"]

    def infer_shape(self, params, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise ValueError("Convolution: data shape unknown")
        nhwc = params.layout == "NHWC"
        n = data[0]
        c = data[3] if nhwc else data[1]
        ih, iw = (data[1], data[2]) if nhwc else (data[2], data[3])
        kh, kw = _pair(params.kernel)
        sh, sw = _pair(params.stride)
        ph, pw = _pair(params.pad, 2) if params.pad else (0, 0)
        dh, dw = _pair(params.dilate)
        oh = _conv_out_dim(ih, kh, sh, ph, dh)
        ow = _conv_out_dim(iw, kw, sw, pw, dw)
        # weight layout is OIHW in both cases (reference checkpoint parity)
        wshape = (params.num_filter, c // params.num_group, kh, kw)
        out = ((n, oh, ow, params.num_filter) if nhwc
               else (n, params.num_filter, oh, ow))
        completed = [tuple(data), wshape]
        if not params.no_bias:
            completed.append((params.num_filter,))
        return completed, [out], []

    def forward(self, params, inputs, aux, train, key):
        x, w = inputs[0], inputs[1].to(inputs[0].dtype)
        nhwc = params.layout == "NHWC"
        if nhwc:
            x = x.permute(0, 3, 1, 2)
        bias = None if params.no_bias else inputs[2].to(x.dtype)
        y = F.conv2d(x, w, bias, stride=_pair(params.stride),
                     padding=_pair(params.pad, 2) if params.pad else 0,
                     dilation=_pair(params.dilate), groups=params.num_group)
        return [y.permute(0, 2, 3, 1) if nhwc else y], []


class DeconvolutionParam(Params):
    kernel = field(tuple_of(int), required=True)
    num_filter = field(int, required=True, lower=1)
    stride = field(tuple_of(int), default=None)
    pad = field(tuple_of(int), default=None)
    adj = field(tuple_of(int), default=(0, 0))
    num_group = field(int, default=1)
    no_bias = field(bool, default=True)
    workspace = field(int, default=512)


@register_op("Deconvolution")
class DeconvolutionOp(OpDef):
    """Transposed convolution (reference deconvolution-inl.h) by
    ``F.conv_transpose2d``, whose weight layout (in, out/group, kH, kW)
    is the reference's; ``adj`` is its ``output_padding``."""

    param_cls = DeconvolutionParam

    def list_arguments(self, params):
        return ["data", "weight"] if params.no_bias else ["data", "weight", "bias"]

    def infer_shape(self, params, in_shapes):
        data = in_shapes[0]
        n, c = data[0], data[1]
        kh, kw = _pair(params.kernel)
        sh, sw = _pair(params.stride)
        ph, pw = _pair(params.pad, 2) if params.pad else (0, 0)
        ah, aw = _pair(params.adj, 2)
        if ah >= sh or aw >= sw:
            raise ValueError(
                f"Deconvolution adj {params.adj} must be smaller than "
                f"stride {(sh, sw)}")
        oh = sh * (data[2] - 1) + kh - 2 * ph + ah
        ow = sw * (data[3] - 1) + kw - 2 * pw + aw
        wshape = (c, params.num_filter // params.num_group, kh, kw)
        completed = [tuple(data), wshape]
        if not params.no_bias:
            completed.append((params.num_filter,))
        return completed, [(n, params.num_filter, oh, ow)], []

    def forward(self, params, inputs, aux, train, key):
        x, w = inputs[0], inputs[1].to(inputs[0].dtype)
        bias = None if params.no_bias else inputs[2].to(x.dtype)
        y = F.conv_transpose2d(
            x, w, bias, stride=_pair(params.stride),
            padding=_pair(params.pad, 2) if params.pad else 0,
            output_padding=_pair(params.adj, 2), groups=params.num_group)
        return [y], []


class BatchNormParam(Params):
    eps = field(float, default=1e-3)
    momentum = field(float, default=0.9)
    fix_gamma = field(bool, default=True)
    use_global_stats = field(bool, default=False)
    axis = field(int, default=1, doc="channel axis (use -1 for NHWC)")


def _bn_stats(x, axes, eps):
    """The reference's one-pass batch statistics in float32: the mean
    and the biased variance ``max(E[x^2] - mean^2, 0)``, its inverse
    square root and the count reduced over."""
    n = 1
    for i in axes:
        n *= x.shape[i]
    xf = x.float()
    mean = xf.sum(axes) / n
    var = torch.clamp_min(torch.square(xf).sum(axes) / n
                          - torch.square(mean), 0.0)
    return mean, var, torch.rsqrt(var + eps), n


class _BNTrain(torch.autograd.Function):
    """Training-mode batch normalisation: ``(y, mean, var)`` forward with
    the reference's statistics (``_bn_train_fwd``), its hand-written
    backward (``_bn_train_bwd``) from the same residuals (x, gamma,
    mean, inv).  ``mean`` and ``var`` feed the moving statistics only:
    their gradients are not taken."""

    @staticmethod
    def forward(ctx, x, gamma, beta, axes, eps):
        mean, var, inv, n = _bn_stats(x, axes, eps)
        shape = [x.shape[i] if i not in axes else 1 for i in range(x.dim())]
        a = gamma.float() * inv
        b = beta.float() - mean * a
        y = (x.float() * a.reshape(shape) + b.reshape(shape)).to(x.dtype)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.axes, ctx.n, ctx.shape = axes, n, shape
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        axes, n, shape = ctx.axes, ctx.n, ctx.shape
        dyf = dy.float()
        xhat = (x.float() - mean.reshape(shape)) * inv.reshape(shape)
        dbeta = dyf.sum(axes)
        dgamma = (dyf * xhat).sum(axes)
        a = (gamma.float() * inv).reshape(shape)
        dx = a * (dyf - dbeta.reshape(shape) / n
                  - xhat * dgamma.reshape(shape) / n)
        return (dx.to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None, None)


@register_op("BatchNorm", aliases=("CuDNNBatchNorm",))
class BatchNormOp(OpDef):
    """Batch normalization over ``axis`` (reference batch_norm-inl.h:314).

    aux states: moving_mean, moving_var.  A training forward (without
    ``use_global_stats``) normalises by the batch's one-pass statistics
    (:class:`_BNTrain`) and returns the moving statistics updated by the
    reference's rule ``m * old + (1 - m) * batch`` with the biased
    variance; otherwise it normalises by the moving statistics, which
    pass through unchanged.  ``fix_gamma`` replaces gamma by ones (its
    gradient is then 0)."""

    param_cls = BatchNormParam

    def list_arguments(self, params):
        return ["data", "gamma", "beta"]

    def list_auxiliary_states(self, params):
        return ["moving_mean", "moving_var"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            raise ValueError("BatchNorm: data shape unknown")
        c = (d[params.axis % len(d)],)
        return [tuple(d), c, c], [tuple(d)], [c, c]

    def forward(self, params, inputs, aux, train, key):
        x, gamma, beta = inputs
        moving_mean, moving_var = aux
        if params.fix_gamma:
            gamma = torch.ones_like(gamma)
        ax = params.axis % x.dim()
        axes = tuple(i for i in range(x.dim()) if i != ax)
        if train and not params.use_global_stats:
            y, mean, var = _BNTrain.apply(x, gamma, beta, axes, params.eps)
            m = params.momentum
            with torch.no_grad():
                new_mean = (m * moving_mean + (1 - m) * mean).to(
                    moving_mean.dtype)
                new_var = (m * moving_var + (1 - m) * var).to(
                    moving_var.dtype)
            return [y], [new_mean, new_var]
        shape = [x.shape[i] if i == ax else 1 for i in range(x.dim())]
        inv = torch.rsqrt(moving_var.float() + params.eps)
        y = (x.float() - moving_mean.float().reshape(shape)) * inv.reshape(
            shape)
        y = (y * gamma.float().reshape(shape)
             + beta.float().reshape(shape))
        return [y.to(x.dtype)], [moving_mean, moving_var]


class InstanceNormParam(Params):
    eps = field(float, default=1e-3)


@register_op("InstanceNorm")
class InstanceNormOp(OpDef):
    """Normalization of each (sample, channel) over its spatial axes
    by the biased variance, then ``gamma`` and ``beta`` a channel."""

    param_cls = InstanceNormParam

    def list_arguments(self, params):
        return ["data", "gamma", "beta"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        c = (d[1],)
        return [tuple(d), c, c], [tuple(d)], []

    def forward(self, params, inputs, aux, train, key):
        x, gamma, beta = inputs
        axes = tuple(range(2, x.dim()))
        var, mean = torch.var_mean(x, dim=axes, correction=0, keepdim=True)
        shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
        y = (x - mean) * torch.rsqrt(var + params.eps)
        return [y * gamma.reshape(shape) + beta.reshape(shape)], []


class PoolingParam(Params):
    kernel = field(tuple_of(int), required=True)
    pool_type = field(str, default="max", enum=("max", "avg", "sum"))
    global_pool = field(bool, default=False)
    stride = field(tuple_of(int), default=None)
    pad = field(tuple_of(int), default=None)
    pooling_convention = field(str, default="valid", enum=("valid", "full"))
    layout = field(str, default="NCHW", enum=("NCHW", "NHWC"))


@register_op("Pooling")
class PoolingOp(OpDef):
    """Max/avg/sum pooling (reference pooling-inl.h) in the reference's
    two output-size conventions, 'valid' (floor) and 'full' (ceil).  The
    input is padded explicitly, as the reference pads its window
    reduction (-inf for max, 0 for the sums, plus the one-sided padding
    'full' needs), and pooled without padding, so ``avg`` divides every
    window by ``kh * kw``."""

    param_cls = PoolingParam

    def _geometry(self, params, h, w):
        kh, kw = _pair(params.kernel)
        sh, sw = _pair(params.stride)
        ph, pw = _pair(params.pad, 2) if params.pad else (0, 0)
        if params.global_pool:
            return (h, w), (1, 1), (0, 0), (1, 1)
        rnd = np.ceil if params.pooling_convention == "full" else np.floor
        oh = int(rnd((h + 2 * ph - kh) / sh)) + 1
        ow = int(rnd((w + 2 * pw - kw) / sw)) + 1
        return (kh, kw), (sh, sw), (ph, pw), (oh, ow)

    def infer_shape(self, params, in_shapes):
        nhwc = params.layout == "NHWC"
        if nhwc:
            n, h, w, c = in_shapes[0]
        else:
            n, c, h, w = in_shapes[0]
        if params.global_pool:
            out = (n, 1, 1, c) if nhwc else (n, c, 1, 1)
            return list(in_shapes), [out], []
        _, _, _, (oh, ow) = self._geometry(params, h, w)
        out = (n, oh, ow, c) if nhwc else (n, c, oh, ow)
        return list(in_shapes), [out], []

    def forward(self, params, inputs, aux, train, key):
        x = inputs[0]
        nhwc = params.layout == "NHWC"
        if nhwc:
            x = x.permute(0, 3, 1, 2)
        h, w = x.shape[2], x.shape[3]
        (kh, kw), (sh, sw), (ph, pw), (oh, ow) = self._geometry(params, h, w)
        # 'full' convention can need extra one-sided padding to reach (oh, ow).
        eh = max(0, (oh - 1) * sh + kh - h - 2 * ph)
        ew = max(0, (ow - 1) * sw + kw - w - 2 * pw)
        pads = (pw, pw + ew, ph, ph + eh)
        is_max = params.pool_type == "max"
        if any(pads):
            x = F.pad(x, pads, value=float("-inf") if is_max else 0.0)
        if is_max:
            y = F.max_pool2d(x, (kh, kw), (sh, sw))
        else:
            y = F.avg_pool2d(x, (kh, kw), (sh, sw), divisor_override=(
                None if params.pool_type == "avg" else 1))
        return [y.permute(0, 2, 3, 1) if nhwc else y], []


class LRNParam(Params):
    nsize = field(int, required=True)
    alpha = field(float, default=1e-4)
    beta = field(float, default=0.75)
    knorm = field(float, default=2.0)


@register_op("LRN")
class LRNOp(OpDef):
    """Local response normalization across channels (lrn-inl.h):
    ``x * (knorm + alpha * S / nsize) ** -beta``, S the sum of squares
    over ``nsize`` channels, the window padded ``nsize // 2`` before and
    ``nsize - nsize // 2 - 1`` after, as the reference pads it."""

    param_cls = LRNParam

    def forward(self, params, inputs, aux, train, key):
        x = inputs[0]
        half = params.nsize // 2
        sq = F.pad(torch.square(x), (0, 0, 0, 0, half,
                                     params.nsize - half - 1))
        acc = sq.unfold(1, params.nsize, 1).sum(-1)
        scale = (params.knorm + params.alpha * acc / params.nsize) ** (
            -params.beta)
        return [x * scale], []


class UpSamplingParam(Params):
    scale = field(int, required=True, lower=1)
    sample_type = field(str, default="nearest", enum=("nearest", "bilinear"))
    num_args = field(int, default=1)
    num_filter = field(int, default=0)
    multi_input_mode = field(str, default="concat", enum=("concat", "sum"))
    workspace = field(int, default=512, doc="unused on TPU; kept for compat")


@register_op("UpSampling")
class UpSamplingOp(OpDef):
    """Nearest upsampling (one input, or ``num_args`` inputs each scaled
    to the first's size times ``scale``, then concatenated on channels
    or summed) and bilinear upsampling.  Bilinear resizes as the
    reference's ``jax.image.resize(..., "bilinear")`` does (half-pixel
    centres, the edge rows repeating the edge) and ignores its
    ``weight`` argument, whose gradient is 0."""

    param_cls = UpSamplingParam

    key_var_num_args = "num_args"

    def list_arguments(self, params):
        if params.sample_type == "bilinear":
            return ["data", "weight"]
        return [f"arg{i}" for i in range(params.num_args)] if params.num_args > 1 else ["data"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        oh, ow = d[2] * params.scale, d[3] * params.scale
        multi = params.sample_type == "nearest" and params.num_args > 1
        if multi:
            for s in in_shapes:
                if s is None:
                    continue
                if oh % s[2] or ow % s[3]:
                    raise ValueError(
                        "UpSampling: input spatial size "
                        f"{(s[2], s[3])} must evenly divide the output "
                        f"{(oh, ow)} (= in0 * scale)")
        if multi and params.multi_input_mode == "sum":
            cs = {s[1] for s in in_shapes if s is not None}
            if len(cs) > 1:
                raise ValueError(
                    "UpSampling: number of channels must be the same "
                    f"when multi_input_mode=sum, got {sorted(cs)}")
            c = d[1]
        else:
            c = (sum(s[1] for s in in_shapes if s is not None)
                 if multi else d[1])
        completed = list(in_shapes)
        if params.sample_type == "bilinear":
            k = 2 * params.scale - params.scale % 2
            completed = [tuple(d), (d[1], 1, k, k)]
        return completed, [(d[0], c, oh, ow)], []

    def forward(self, params, inputs, aux, train, key):
        s = params.scale
        oh, ow = inputs[0].shape[2] * s, inputs[0].shape[3] * s
        if params.sample_type == "bilinear":
            return [F.interpolate(inputs[0], scale_factor=s, mode="bilinear",
                                  align_corners=False)], []
        outs = []
        for x in inputs if params.num_args > 1 else inputs[:1]:
            si, sj = oh // x.shape[2], ow // x.shape[3]
            outs.append(x.repeat_interleave(si, 2).repeat_interleave(sj, 3))
        if len(outs) > 1:
            # multi-input nearest: concat channels, or elementwise sum
            # (upsampling-inl.h up_enum::kSum)
            if params.multi_input_mode == "sum":
                return [functools.reduce(torch.add, outs)], []
            return [torch.cat(outs, 1)], []
        return [outs[0]], []


# -- Activation --------------------------------------------------------------
class ActivationParam(Params):
    act_type = field(str, required=True, enum=("relu", "sigmoid", "tanh", "softrelu"))


_ACTS = {
    "relu": lambda x: torch.clamp_min(x, 0),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
}


@register_op("Activation")
class ActivationOp(OpDef):
    param_cls = ActivationParam

    def forward(self, params, inputs, aux, train, key):
        return [_ACTS[params.act_type](inputs[0])], []


class LeakyReLUParam(Params):
    act_type = field(str, default="leaky", enum=("leaky", "prelu", "elu", "rrelu"))
    slope = field(float, default=0.25)
    lower_bound = field(float, default=0.125)
    upper_bound = field(float, default=0.334)


@register_op("LeakyReLU")
class LeakyReLUOp(OpDef):
    param_cls = LeakyReLUParam
    need_rng = True

    def list_arguments(self, params):
        return ["data", "gamma"] if params.act_type == "prelu" else ["data"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if params.act_type == "prelu":
            return [tuple(d), (d[1],)], [tuple(d)], []
        return list(in_shapes), [tuple(d)], []

    def forward(self, params, inputs, aux, train, key):
        x = inputs[0]
        t = params.act_type
        if t == "leaky":
            return [torch.where(x > 0, x, params.slope * x)], []
        if t == "elu":
            return [torch.where(x > 0, x, params.slope * (torch.exp(x) - 1))], []
        if t == "prelu":
            g = inputs[1].reshape((1, -1) + (1,) * (x.dim() - 2))
            return [torch.where(x > 0, x, g * x)], []
        # rrelu: random slope in train, mean slope in eval
        if train and key is not None:
            u = torch.rand(x.shape, generator=key.generator(),
                           device=x.device, dtype=x.dtype)
            slope = params.lower_bound + (
                params.upper_bound - params.lower_bound) * u
        else:
            slope = (params.lower_bound + params.upper_bound) / 2.0
        return [torch.where(x > 0, x, slope * x)], []


class L2NormalizationParam(Params):
    eps = field(float, default=1e-10)
    mode = field(str, default="instance", enum=("instance", "channel", "spatial"))


@register_op("L2Normalization")
class L2NormalizationOp(OpDef):
    param_cls = L2NormalizationParam

    def forward(self, params, inputs, aux, train, key):
        x = inputs[0]
        if params.mode == "instance":
            axes = tuple(range(1, x.dim()))
        elif params.mode == "channel":
            axes = (1,)
        else:  # spatial
            axes = tuple(range(2, x.dim()))
        norm = torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=True)
                          + params.eps)
        return [x / norm], []


# -- Dropout -----------------------------------------------------------------
class DropoutParam(Params):
    p = field(float, default=0.5, lower=0.0, upper=1.0)


@register_op("Dropout")
class DropoutOp(OpDef):
    """Inverted dropout (reference dropout-inl.h); identity in inference.
    The keep mask is drawn from the key's generator, on the input's
    device."""

    param_cls = DropoutParam
    need_rng = True

    def forward(self, params, inputs, aux, train, key):
        x = inputs[0]
        if not train or params.p <= 0.0:
            return [x], []
        keep = 1.0 - params.p
        u = torch.rand(x.shape, generator=key.generator(), device=x.device)
        return [torch.where(u < keep, x / keep,
                            torch.zeros((), dtype=x.dtype,
                                        device=x.device)).to(x.dtype)], []


# -- Embedding ---------------------------------------------------------------
class EmbeddingParam(Params):
    input_dim = field(int, required=True, lower=1)
    output_dim = field(int, required=True, lower=1)


@register_op("Embedding")
class EmbeddingOp(OpDef):
    """Gather forward / scatter-add backward (embedding-inl.h)."""

    param_cls = EmbeddingParam

    def list_arguments(self, params):
        return ["data", "weight"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            raise ValueError("Embedding: data shape unknown")
        w = (params.input_dim, params.output_dim)
        return [tuple(d), w], [tuple(d) + (params.output_dim,)], []

    def infer_dtype(self, params, in_dtypes):
        """Output/weight type is the table's type, never the index
        type."""
        w = in_dtypes[1] if in_dtypes[1] is not None else np.dtype(np.float32)
        d = in_dtypes[0] if in_dtypes[0] is not None else w
        return [d, w], [w], []

    def forward(self, params, inputs, aux, train, key):
        return [Embedding(inputs[0], inputs[1])], []


# -- SoftmaxActivation -------------------------------------------------------
class SoftmaxActivationParam(Params):
    mode = field(str, default="instance", enum=("instance", "channel"))


@register_op("SoftmaxActivation")
class SoftmaxActivationOp(OpDef):
    param_cls = SoftmaxActivationParam

    def forward(self, params, inputs, aux, train, key):
        axis = 1 if params.mode == "channel" else -1
        x = inputs[0]
        if params.mode == "instance" and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        return [torch.softmax(x, dim=axis)], []
