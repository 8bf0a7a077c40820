"""Vision operators: ROIPooling, SpatialTransformer, Correlation.

The port of ``mxnet_tpu/ops/vision.py`` (the reference's
src/operator/{roi_pooling,spatial_transformer,correlation}-inl.h): the
same whole-array gathers, masks and shifted products, on torch tensors,
with gradients from autograd.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..param import Params, field, tuple_of
from .op import OpDef, register_op


# -- ROIPooling --------------------------------------------------------------
class ROIPoolingParam(Params):
    pooled_size = field(tuple_of(int), required=True)
    spatial_scale = field(float, required=True)


@register_op("ROIPooling")
class ROIPoolingOp(OpDef):
    """Max-pool features inside each ROI into a fixed grid
    (roi_pooling-inl.h).  rois: (R, 5) rows [batch_idx, x1, y1, x2, y2];
    the scaled corners are rounded half to even and each pixel of the ROI
    falls in bin ``(pixel - corner) * pooled // extent``; an empty bin
    reads 0."""

    param_cls = ROIPoolingParam

    def list_arguments(self, params):
        return ["data", "rois"]

    def infer_shape(self, params, in_shapes):
        data, rois = in_shapes
        if data is None or rois is None:
            raise ValueError("ROIPooling: shapes unknown")
        ph, pw = params.pooled_size
        return list(in_shapes), [(rois[0], data[1], ph, pw)], []

    def forward(self, params, inputs, aux, train, key):
        data, rois = inputs
        _, C, H, W = data.shape
        ph, pw = params.pooled_size
        r = rois.detach()
        bidx = r[:, 0].long()
        x1, y1, x2, y2 = (torch.round(r[:, i] * params.spatial_scale).long()
                          for i in (1, 2, 3, 4))
        rh = torch.clamp_min(y2 - y1 + 1, 1)[:, None]
        rw = torch.clamp_min(x2 - x1 + 1, 1)[:, None]
        ys = torch.arange(H, device=data.device)[None]
        xs = torch.arange(W, device=data.device)[None]
        y1, y2, x1, x2 = y1[:, None], y2[:, None], x1[:, None], x2[:, None]
        # bin index per pixel, or ph/pw for "outside the ROI"
        by = torch.where((ys >= y1) & (ys <= y2),
                         torch.clamp(torch.div((ys - y1) * ph, rh,
                                               rounding_mode="floor"),
                                     0, ph - 1), ph)
        bx = torch.where((xs >= x1) & (xs <= x2),
                         torch.clamp(torch.div((xs - x1) * pw, rw,
                                               rounding_mode="floor"),
                                     0, pw - 1), pw)
        flat_bin = (by[:, :, None] * (pw + 1) + bx[:, None, :]).reshape(
            len(r), 1, H * W).expand(-1, C, -1)
        feat = data[bidx].reshape(len(r), C, H * W)
        out = torch.full((len(r), C, (ph + 1) * (pw + 1)), float("-inf"),
                         dtype=data.dtype, device=data.device)
        out = out.scatter_reduce(2, flat_bin, feat, "amax")
        out = out.reshape(len(r), C, ph + 1, pw + 1)[:, :, :ph, :pw]
        return [torch.where(torch.isfinite(out), out,
                            torch.zeros((), dtype=out.dtype,
                                        device=out.device))], []


# -- SpatialTransformer ------------------------------------------------------
class SpatialTransformerParam(Params):
    target_shape = field(tuple_of(int), required=True)
    transform_type = field(str, default="affine", enum=("affine",))
    sampler_type = field(str, default="bilinear", enum=("bilinear",))


@register_op("SpatialTransformer")
class SpatialTransformerOp(OpDef):
    """Affine grid generator + bilinear sampler
    (spatial_transformer-inl.h).  loc input: (N, 6) affine parameters
    mapping the target grid in [-1, 1] to source coordinates; samples
    outside the source read 0."""

    param_cls = SpatialTransformerParam

    def list_arguments(self, params):
        return ["data", "loc"]

    def infer_shape(self, params, in_shapes):
        data = in_shapes[0]
        th, tw = params.target_shape
        return [tuple(data), (data[0], 6)], [(data[0], data[1], th, tw)], []

    def forward(self, params, inputs, aux, train, key):
        data, loc = inputs
        N, C, H, W = data.shape
        th, tw = params.target_shape
        dev = data.device
        theta = loc.reshape(N, 2, 3).float()
        # normalized target grid in [-1, 1]
        ys = torch.linspace(-1.0, 1.0, th, device=dev)
        xs = torch.linspace(-1.0, 1.0, tw, device=dev)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # (th, tw)
        grid = torch.stack([gx, gy, torch.ones_like(gx)], 0).reshape(3, -1)
        src = torch.einsum("nij,jk->nik", theta, grid)  # (N, 2, th*tw)
        sx = (src[:, 0] + 1.0) * (W - 1) / 2.0
        sy = (src[:, 1] + 1.0) * (H - 1) / 2.0
        x0 = torch.floor(sx).detach()
        y0 = torch.floor(sy).detach()
        wx = (sx - x0).to(data.dtype)[:, None]
        wy = (sy - y0).to(data.dtype)[:, None]
        flat = data.reshape(N, C, H * W)

        def sample(yi, xi):
            """(N, C, P) values at (yi, xi), zero outside the image."""
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            yc = torch.clamp(yi, 0, H - 1).long()
            xc = torch.clamp(xi, 0, W - 1).long()
            idx = (yc * W + xc)[:, None].expand(-1, C, -1)
            return torch.gather(flat, 2, idx) * valid[:, None].to(data.dtype)

        v00 = sample(y0, x0)
        v01 = sample(y0, x0 + 1)
        v10 = sample(y0 + 1, x0)
        v11 = sample(y0 + 1, x0 + 1)
        out = (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
               + v10 * (1 - wx) * wy + v11 * wx * wy)
        return [out.reshape(N, C, th, tw).to(data.dtype)], []


# -- Correlation -------------------------------------------------------------
class CorrelationParam(Params):
    kernel_size = field(int, default=1)
    max_displacement = field(int, default=1)
    stride1 = field(int, default=1)
    stride2 = field(int, default=1)
    pad_size = field(int, default=0)
    is_multiply = field(bool, default=True)


@register_op("Correlation")
class CorrelationOp(OpDef):
    """Optical-flow cost volume between two feature maps
    (correlation-inl.h): for each displacement (du, dv) on the stride2
    grid within max_displacement, mean over channels+kernel window of
    f1(x) * f2(x + d)  (or |f1 - f2| when is_multiply=False)."""

    param_cls = CorrelationParam

    def list_arguments(self, params):
        return ["data1", "data2"]

    def _geometry(self, params, H, W):
        pad = params.pad_size
        bd = params.max_displacement
        k = params.kernel_size
        kr = k // 2
        ph, pw = H + 2 * pad, W + 2 * pad
        d = 2 * bd // params.stride2 + 1
        oh = int(np.ceil((ph - (k - 1) - 2 * bd) / params.stride1))
        ow = int(np.ceil((pw - (k - 1) - 2 * bd) / params.stride1))
        return d, oh, ow, pad, bd, kr

    def infer_shape(self, params, in_shapes):
        n, c, H, W = in_shapes[0]
        d, oh, ow, *_ = self._geometry(params, H, W)
        return [tuple(in_shapes[0])] * 2, [(n, d * d, oh, ow)], []

    def forward(self, params, inputs, aux, train, key):
        f1, f2 = inputs
        N, C, H, W = f1.shape
        d, oh, ow, pad, bd, kr = self._geometry(params, H, W)
        k, s1, s2 = params.kernel_size, params.stride1, params.stride2
        p1 = F.pad(f1, (pad, pad, pad, pad))
        p2 = F.pad(f2, (pad, pad, pad, pad))
        # output grid top-left corners in padded coords
        base = bd + kr
        span_h, span_w = (oh - 1) * s1 + 1, (ow - 1) * s1 + 1

        def window(p, y, x):
            return p[:, :, y:y + span_h:s1, x:x + span_w:s1]

        outs = []
        for dy in range(-bd, bd + 1, s2):
            for dx in range(-bd, bd + 1, s2):
                # window sums over kernel_size at each output position
                acc = 0.0
                for ky in range(-kr, k - kr):
                    for kx in range(-kr, k - kr):
                        a = window(p1, base + ky, base + kx)
                        b = window(p2, base + dy + ky, base + dx + kx)
                        acc = acc + (a * b if params.is_multiply
                                     else torch.abs(a - b))
                outs.append(torch.sum(acc, 1) / (k * k * C))
        return [torch.stack(outs, 1).to(f1.dtype)], []
