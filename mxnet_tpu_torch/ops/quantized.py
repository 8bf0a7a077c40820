"""Quantized inference operators: QuantizedFullyConnected and
QuantizedConvolution.

The port of ``mxnet_tpu/ops/quantized.py``.  Weights are int8 with a
float32 scale per output channel, OIHW for the convolution in both
layouts.  Two modes per op, chosen by whether an activation scale was
calibrated:

- weight-only (``act_scale == 0``): the int8 weights are dequantized and
  the product runs in the activations' dtype;
- calibrated (``act_scale > 0``): activations are quantized per tensor as
  ``round(x * (1 / act_scale))`` (half to even) clipped to +-127, the
  int8 x int8 contraction is exact int32 (the reference's
  ``preferred_element_type=int32``), and the result is rescaled by
  ``act_scale * wscale`` in float32 and the bias added, rounded as one
  fused multiply-add.

The exact contraction (:func:`int8_matmul`) is an im2col of the int8
input (strided views, one copy) against the weight matrix: on CUDA
``torch._int_mm`` (int8 in, int32 out; rows, K and N padded with zeros
to its shape rules), on the CPU a float64 product cast to int32, exact
below 2^53.  A float32 convolution is not exact there: float32 sums of
int8 products round once K * 127^2 passes 2^24.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..param import Params, field, tuple_of
from .nn import _pair
from .op import OpDef, register_op


def _round_up(n, m):
    return -(-n // m) * m


def int8_matmul(a, b):
    """Exact int32 ``a @ b.T`` of int8 ``a`` (M, K) and ``b`` (O, K)."""
    M, K = a.shape
    O = b.shape[0]
    if a.is_cuda:
        # torch._int_mm wants more than 16 rows and K, N multiples of 8
        Mp, Kp, Op = max(M, 17), _round_up(K, 8), _round_up(O, 8)
        a = F.pad(a, (0, Kp - K, 0, Mp - M)).contiguous()
        b = F.pad(b, (0, Kp - K, 0, Op - O)).contiguous()
        return torch._int_mm(a, b.t())[:M, :O]
    return (a.double() @ b.double().t()).to(torch.int32)


def quantize_act(x, act_scale):
    """int8 ``clip(round(x * (1 / act_scale)), -127, 127)`` in float32."""
    inv = torch.tensor(1.0 / act_scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)


def conv_y32(xq, wq, stride, pad, layout="NCHW"):
    """Exact int32 convolution of int8 ``xq`` with int8 OIHW ``wq``: the
    output in ``layout``."""
    O, C, kh, kw = wq.shape
    sh, sw = stride
    ph, pw = pad
    if layout == "NHWC":
        xp = F.pad(xq, (0, 0, pw, pw, ph, ph))
        cols = xp.unfold(1, kh, sh).unfold(2, kw, sw)   # N OH OW C kh kw
    else:
        xp = F.pad(xq, (pw, pw, ph, ph))
        cols = xp.unfold(2, kh, sh).unfold(3, kw, sw)   # N C OH OW kh kw
        cols = cols.permute(0, 2, 3, 1, 4, 5)
    N, OH, OW = cols.shape[:3]
    y = int8_matmul(cols.reshape(N * OH * OW, C * kh * kw),
                    wq.reshape(O, C * kh * kw)).reshape(N, OH, OW, O)
    return y if layout == "NHWC" else y.permute(0, 3, 1, 2)


def _rescale(y32, act_scale, wscale, bias, shape):
    """float32 ``y32 * (act_scale * wscale) [+ bias]``, the product and
    the sum rounded once, as one fused multiply-add (the reference's
    compiled code contracts them into an FMA): in float64 the product of
    two float32 values is exact, so only the sum rounds, and the CPU and
    the card agree."""
    scale = torch.tensor(act_scale, dtype=torch.float32,
                         device=wscale.device) * wscale
    y = y32.float().double() * scale.reshape(shape).double()
    if bias is not None:
        y = y + bias.reshape(shape).double()
    return y.float()


class QuantizedFullyConnectedParam(Params):
    num_hidden = field(int, required=True, lower=1)
    no_bias = field(bool, default=False)
    flatten = field(bool, default=True)
    act_scale = field(float, default=0.0,
                      doc="calibrated activation scale; 0 = weight-only")


@register_op("QuantizedFullyConnected")
class QuantizedFullyConnectedOp(OpDef):
    """y = x @ (w_int8 * wscale).T + b, or with ``act_scale`` the x side
    int8 too and the contraction exact int32.  Inference-oriented: the
    round has zero gradient."""

    param_cls = QuantizedFullyConnectedParam

    def list_arguments(self, params):
        args = ["data", "weight", "wscale"]
        if not params.no_bias:
            args.append("bias")
        return args

    def infer_shape(self, params, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise ValueError("QuantizedFullyConnected: data shape unknown")
        in_dim = int(np.prod(data[1:]))
        completed = [tuple(data), (params.num_hidden, in_dim),
                     (params.num_hidden,)]
        if not params.no_bias:
            completed.append((params.num_hidden,))
        return completed, [(data[0], params.num_hidden)], []

    def infer_dtype(self, params, in_dtypes):
        act = in_dtypes[0] or np.dtype(np.float32)
        ins = [act, np.dtype(np.int8), np.dtype(np.float32)]
        if not params.no_bias:
            ins.append(np.dtype(np.float32))
        return ins, [act], []

    def forward(self, params, inputs, aux, train, key):
        x, wq, wscale = inputs[0], inputs[1], inputs[2].float()
        x2 = x.reshape(x.shape[0], -1)
        bias = None if params.no_bias else inputs[-1].float()
        if params.act_scale > 0.0:
            y32 = int8_matmul(quantize_act(x2, params.act_scale),
                              wq.to(torch.int8))
            y = _rescale(y32, params.act_scale, wscale, bias, (1, -1))
        else:
            w = wq.to(x.dtype) * wscale.to(x.dtype)[:, None]
            y = (x2 @ w.t()).float()
            if bias is not None:
                y = y + bias
        return [y.to(x.dtype)], []


class QuantizedConvolutionParam(Params):
    kernel = field(tuple_of(int), required=True)
    num_filter = field(int, required=True, lower=1)
    stride = field(tuple_of(int), default=None)
    pad = field(tuple_of(int), default=None)
    no_bias = field(bool, default=False)
    layout = field(str, default="NCHW", enum=("NCHW", "NHWC"))
    act_scale = field(float, default=0.0)


@register_op("QuantizedConvolution")
class QuantizedConvolutionOp(OpDef):
    """Convolution with int8 OIHW weights and per-output-channel scales:
    weight-only dequantization, or with ``act_scale`` the exact int32
    contraction of :func:`conv_y32`."""

    param_cls = QuantizedConvolutionParam

    def list_arguments(self, params):
        args = ["data", "weight", "wscale"]
        if not params.no_bias:
            args.append("bias")
        return args

    def infer_shape(self, params, in_shapes):
        data = in_shapes[0]
        if data is None:
            raise ValueError("QuantizedConvolution: data shape unknown")
        n, h, w, c = ((data[0], data[1], data[2], data[3])
                      if params.layout == "NHWC"
                      else (data[0], data[2], data[3], data[1]))
        kh, kw = _pair(params.kernel)
        sh, sw = _pair(params.stride)
        ph, pw = _pair(params.pad, 2) if params.pad else (0, 0)
        oh = (h + 2 * ph - kh) // sh + 1
        ow = (w + 2 * pw - kw) // sw + 1
        out = ((n, oh, ow, params.num_filter) if params.layout == "NHWC"
               else (n, params.num_filter, oh, ow))
        completed = [tuple(data), (params.num_filter, c, kh, kw),
                     (params.num_filter,)]
        if not params.no_bias:
            completed.append((params.num_filter,))
        return completed, [out], []

    def infer_dtype(self, params, in_dtypes):
        act = in_dtypes[0] or np.dtype(np.float32)
        ins = [act, np.dtype(np.int8), np.dtype(np.float32)]
        if not params.no_bias:
            ins.append(np.dtype(np.float32))
        return ins, [act], []

    def forward(self, params, inputs, aux, train, key):
        x, wq, wscale = inputs[0], inputs[1], inputs[2].float()
        stride = _pair(params.stride)
        pad = _pair(params.pad, 2) if params.pad else (0, 0)
        nhwc = params.layout == "NHWC"
        shape = (1, 1, 1, -1) if nhwc else (1, -1, 1, 1)
        bias = None if params.no_bias else inputs[-1].float()
        if params.act_scale > 0.0:
            y32 = conv_y32(quantize_act(x, params.act_scale),
                           wq.to(torch.int8), stride, pad, params.layout)
            y = _rescale(y32, params.act_scale, wscale, bias, shape)
        else:
            w = wq.to(x.dtype) * wscale.to(x.dtype).reshape(-1, 1, 1, 1)
            xc = x.permute(0, 3, 1, 2) if nhwc else x
            y = F.conv2d(xc, w, stride=stride, padding=pad).float()
            if nhwc:
                y = y.permute(0, 2, 3, 1)
            if bias is not None:
                y = y + bias.reshape(shape)
        return [y.to(x.dtype)], []
