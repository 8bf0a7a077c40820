"""Neural-network layer operators.

The port of ``mxnet_tpu/ops/nn.py``.  :func:`FullyConnected` and
:func:`Embedding` are plain functions on tensors (gradients from
autograd), used by ``models.GPT`` and by the ops below.  The registered
ops of the training frontend (``FullyConnected``, ``Activation``,
``LeakyReLU``, ``Dropout``, ``Embedding``, ``SoftmaxActivation``,
``L2Normalization``) call them or torch directly.  ``Convolution``,
``Deconvolution``, ``BatchNorm``, ``InstanceNorm``, ``Pooling``, ``LRN``
and ``UpSampling`` are registered with the reference's parameters and
shape rules, so their symbols build, infer and serialize; running one
raises, naming ROADMAP §A15b.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..param import Params, field, tuple_of
from .op import OpDef, not_ported, register_op

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
    """The reference's ``Convolution`` signature and shape
    rules; running it waits for A15b."""

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
        raise not_ported("the Convolution op")


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
    """The reference's ``Deconvolution`` signature and shape
    rules; running it waits for A15b."""

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
        raise not_ported("the Deconvolution op")


class BatchNormParam(Params):
    eps = field(float, default=1e-3)
    momentum = field(float, default=0.9)
    fix_gamma = field(bool, default=True)
    use_global_stats = field(bool, default=False)
    axis = field(int, default=1, doc="channel axis (use -1 for NHWC)")


@register_op("BatchNorm", aliases=("CuDNNBatchNorm",))
class BatchNormOp(OpDef):
    """The reference's ``BatchNorm`` signature and shape
    rules; running it waits for A15b."""

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
        raise not_ported("the BatchNorm op")


class InstanceNormParam(Params):
    eps = field(float, default=1e-3)


@register_op("InstanceNorm")
class InstanceNormOp(OpDef):
    """The reference's ``InstanceNorm`` signature and shape
    rules; running it waits for A15b."""

    param_cls = InstanceNormParam

    def list_arguments(self, params):
        return ["data", "gamma", "beta"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        c = (d[1],)
        return [tuple(d), c, c], [tuple(d)], []

    def forward(self, params, inputs, aux, train, key):
        raise not_ported("the InstanceNorm op")


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
    """The reference's ``Pooling`` signature and shape
    rules; running it waits for A15b."""

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
        raise not_ported("the Pooling op")


class LRNParam(Params):
    nsize = field(int, required=True)
    alpha = field(float, default=1e-4)
    beta = field(float, default=0.75)
    knorm = field(float, default=2.0)


@register_op("LRN")
class LRNOp(OpDef):
    """The reference's ``LRN`` signature and shape
    rules; running it waits for A15b."""

    param_cls = LRNParam

    def forward(self, params, inputs, aux, train, key):
        raise not_ported("the LRN op")


class UpSamplingParam(Params):
    scale = field(int, required=True, lower=1)
    sample_type = field(str, default="nearest", enum=("nearest", "bilinear"))
    num_args = field(int, default=1)
    num_filter = field(int, default=0)
    multi_input_mode = field(str, default="concat", enum=("concat", "sum"))
    workspace = field(int, default=512, doc="unused on TPU; kept for compat")


@register_op("UpSampling")
class UpSamplingOp(OpDef):
    """The reference's ``UpSampling`` signature and shape
    rules; running it waits for A15b."""

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
        raise not_ported("the UpSampling op")


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
