"""SSD multibox operators: MultiBoxPrior, MultiBoxTarget, MultiBoxDetection.

The port of ``mxnet_tpu/ops/multibox.py`` (the reference SSD example's
multibox_{prior,target,detection}-inl.h): anchor generation, training
target matching and detection decoding with greedy NMS, as whole-batch
torch ops.  The reference computes these outside any Pallas kernel, so
they run as plain torch on either device.

Box format: corner (xmin, ymin, xmax, ymax), normalized to [0, 1].
Ground-truth label rows: [class_id, xmin, ymin, xmax, ymax]; class -1
pads invalid rows.

Every decision is the same on the CPU and on CUDA, bit for bit:

- anchors are computed in float64 and cast last (the reference runs with
  64-bit floats enabled, so its centres and widths are float64);
- ``log`` and ``exp`` run in float64 and round once to the input dtype
  (float32 ``log``/``exp`` differ between devices by an ulp);
- ties: ``argmax`` takes the first index; every ranking is a stable
  argsort, so equal scores keep anchor order;
- the bipartite claim of two ground truths with the same best anchor goes
  to the higher gt index (the reference's scatter keeps the last writer
  on the CPU), by ``scatter_reduce("amax")`` over gt indices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..param import Params, field, tuple_of
from .op import OpDef, register_op


def _iou(a, b):
    """IoU of (..., P, 4) against (..., Q, 4) corner boxes: (..., P, Q)."""
    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    iw = torch.clamp_min(ix2 - ix1, 0)
    ih = torch.clamp_min(iy2 - iy1, 0)
    inter = iw * ih
    area_a = torch.clamp_min((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]),
                             0)
    area_b = torch.clamp_min((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]),
                             0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def _f64(fn, x):
    """``fn`` (log, exp) in float64, rounded once to ``x``'s dtype."""
    return fn(x.double()).to(x.dtype)


def _scalar(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def descending(score):
    """Row-wise order of ``score`` (N, A), largest first; equal scores
    keep their index order (a stable sort)."""
    return torch.argsort(-score, dim=1, stable=True)


def claim_anchors(best_anchor, n_anchor):
    """(N, n_anchor) gt index claiming each anchor, -1 where none does:
    gt ``j`` claims anchor ``best_anchor[n, j]`` (``n_anchor`` is the
    dropped sentinel), and of gts claiming one anchor the highest index
    wins."""
    N, M = best_anchor.shape
    dev = best_anchor.device
    claimed = torch.full((N, n_anchor + 1), -1, dtype=torch.long, device=dev)
    return claimed.scatter_reduce(
        1, best_anchor, torch.arange(M, device=dev).expand(N, M),
        "amax")[:, :n_anchor]


# -- MultiBoxPrior -----------------------------------------------------------
class MultiBoxPriorParam(Params):
    sizes = field(tuple_of(float), default=(1.0,))
    ratios = field(tuple_of(float), default=(1.0,))
    clip = field(bool, default=False)
    steps = field(tuple_of(float), default=None)
    offsets = field(tuple_of(float), default=(0.5, 0.5))


@register_op("MultiBoxPrior", aliases=("_contrib_MultiBoxPrior",))
class MultiBoxPriorOp(OpDef):
    """Anchor boxes per feature-map cell (multibox_prior-inl.h):
    num_anchors = len(sizes) + len(ratios) - 1, every size with
    ``ratios[0]``, then ``ratios[1:]`` with ``sizes[0]``; ``steps`` and
    ``offsets`` are (y, x)."""

    param_cls = MultiBoxPriorParam

    def _num_anchors(self, params):
        return len(params.sizes) + len(params.ratios) - 1

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        n_anchor = self._num_anchors(params)
        return list(in_shapes), [(1, d[2] * d[3] * n_anchor, 4)], []

    def forward(self, params, inputs, aux, train, key):
        x = inputs[0]
        H, W = x.shape[2], x.shape[3]
        dev, f64 = x.device, torch.float64
        step_y = params.steps[0] if params.steps else 1.0 / H
        step_x = params.steps[1] if params.steps else 1.0 / W
        oy, ox = params.offsets
        cy = (torch.arange(H, device=dev, dtype=f64) + oy) * step_y
        cx = (torch.arange(W, device=dev, dtype=f64) + ox) * step_x
        whs = []
        r0 = np.sqrt(params.ratios[0])
        for s in params.sizes:
            whs.append((s * r0, s / r0))
        for r in params.ratios[1:]:
            sr = np.sqrt(r)
            whs.append((params.sizes[0] * sr, params.sizes[0] / sr))
        whs = torch.tensor(whs, dtype=f64, device=dev)            # (A, 2)
        gy, gx = torch.meshgrid(cy, cx, indexing="ij")
        centers = torch.stack([gx, gy], -1).reshape(-1, 1, 2)
        half = whs.reshape(1, -1, 2) / 2.0
        boxes = torch.cat([centers - half, centers + half], -1).reshape(
            1, -1, 4)
        if params.clip:
            boxes = torch.clamp(boxes, 0.0, 1.0)
        return [boxes.to(x.dtype)], []


# -- MultiBoxTarget ----------------------------------------------------------
class MultiBoxTargetParam(Params):
    overlap_threshold = field(float, default=0.5)
    ignore_label = field(float, default=-1.0)
    negative_mining_ratio = field(float, default=-1.0)
    negative_mining_thresh = field(float, default=0.5)   # parsed, unused
    minimum_negative_samples = field(int, default=0)
    variances = field(tuple_of(float), default=(0.1, 0.1, 0.2, 0.2))


def _encode(anchors, gt, var):
    """Regression targets of (N, A, 4) matched boxes against (A, 4)
    anchors."""
    eps = _scalar(1e-8, anchors)
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    gw = torch.maximum(gt[..., 2] - gt[..., 0], eps)
    gh = torch.maximum(gt[..., 3] - gt[..., 1], eps)
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    aw_c, ah_c = torch.maximum(aw, eps), torch.maximum(ah, eps)
    tx = (gcx - acx) / aw_c / var[0]
    ty = (gcy - acy) / ah_c / var[1]
    tw = _f64(torch.log, gw / aw_c) / var[2]
    th = _f64(torch.log, gh / ah_c) / var[3]
    return torch.stack([tx, ty, tw, th], -1)


@register_op("MultiBoxTarget", aliases=("_contrib_MultiBoxTarget",))
class MultiBoxTargetOp(OpDef):
    """Match anchors to ground truth, emit regression targets, their mask
    and classification targets (multibox_target-inl.h).

    inputs: anchors (1, A, 4), labels (N, M, 5), cls_preds (N, cls+1, A)
    outputs: loc_target (N, A*4), loc_mask (N, A*4), cls_target (N, A)

    Each anchor takes its best gt (the first on a tie) when their IoU
    reaches ``overlap_threshold``; each valid gt also claims its best
    anchor (the first on a tie; of gts claiming one anchor the highest
    index wins).  With ``negative_mining_ratio > 0`` the unmatched
    anchors ranked highest by ``max(non-background) - background``
    (a stable ranking) are kept as background, ``trunc(ratio * num_pos)``
    of them (at least ``minimum_negative_samples``); the rest read
    ``ignore_label``.  No gradient flows: the backward is zeros."""

    param_cls = MultiBoxTargetParam
    is_loss = True

    def list_arguments(self, params):
        return ["anchor", "label", "cls_pred"]

    def list_outputs(self, params):
        return ["loc_target", "loc_mask", "cls_target"]

    def infer_shape(self, params, in_shapes):
        anchor, label, cls_pred = in_shapes
        A = anchor[1]
        N = label[0]
        return list(in_shapes), [(N, A * 4), (N, A * 4), (N, A)], []

    def infer_dtype(self, params, in_dtypes):
        dt = in_dtypes[0] or np.dtype(np.float32)
        return [dt] * 3, [dt] * 3, []

    def forward(self, params, inputs, aux, train, key):
        with torch.profiler.record_function("multibox_target"):
            return self._forward(params, inputs), []

    def _forward(self, params, inputs):
        anchors = inputs[0][0].detach()                        # (A, 4)
        labels = inputs[1].detach().to(anchors.dtype)          # (N, M, 5)
        cls_preds = inputs[2].detach()                         # (N, C, A)
        var = torch.tensor(params.variances, dtype=anchors.dtype,
                           device=anchors.device)
        N = labels.shape[0]
        A = anchors.shape[0]
        dev = anchors.device
        valid = labels[..., 0] >= 0                            # (N, M)
        gt_boxes = labels[..., 1:5]
        iou = _iou(anchors.expand(N, A, 4), gt_boxes)          # (N, A, M)
        iou = torch.where(valid[:, None, :], iou, _scalar(-1.0, iou))
        best_iou = torch.max(iou, 2).values
        best_gt = torch.argmax(iou, 2)          # the first maximum
        assigned = best_iou >= _scalar(params.overlap_threshold, best_iou)
        # bipartite: each valid gt claims its best anchor; padding rows go
        # to the sentinel column A, dropped
        best_anchor = torch.argmax(iou, 1)                     # (N, M)
        best_anchor = torch.where(valid, best_anchor,
                                  torch.full_like(best_anchor, A))
        claimed_gt = claim_anchors(best_anchor, A)
        claim = claimed_gt >= 0
        gt_idx = torch.where(claim, claimed_gt, best_gt)
        pos = assigned | claim
        matched = torch.gather(gt_boxes, 1,
                               gt_idx[..., None].expand(N, A, 4))
        zero = _scalar(0.0, anchors)
        loc_t = torch.where(pos[..., None], _encode(anchors, matched, var),
                            zero).reshape(N, A * 4)
        loc_m = pos.repeat_interleave(4, 1).to(anchors.dtype)
        cls_gt = torch.gather(labels[..., 0], 1, gt_idx)
        cls_t = torch.where(pos, cls_gt + 1, zero)        # 0 = background
        if params.negative_mining_ratio > 0:
            cp = cls_preds.to(anchors.dtype)
            neg_score = torch.max(cp[:, 1:], 1).values - cp[:, 0]
            neg_score = torch.where(pos, _scalar(-np.inf, neg_score),
                                    neg_score)
            num_pos = pos.sum(1)
            num_neg = torch.clamp_min(
                (params.negative_mining_ratio * num_pos.double()).long(),
                params.minimum_negative_samples)
            order = descending(neg_score)
            rank = torch.empty_like(order).scatter_(
                1, order, torch.arange(A, device=dev).expand(N, A))
            keep_neg = ~pos & (rank < num_neg[:, None])
            cls_t = torch.where(pos | keep_neg, cls_t,
                                _scalar(params.ignore_label, cls_t))
        return [loc_t, loc_m, cls_t]

    def backward(self, params, out_grads, inputs, outputs):
        return [torch.zeros_like(x) for x in inputs]


# -- MultiBoxDetection -------------------------------------------------------
class MultiBoxDetectionParam(Params):
    clip = field(bool, default=True)
    threshold = field(float, default=0.01)
    background_id = field(int, default=0)
    nms_threshold = field(float, default=0.5)
    force_suppress = field(bool, default=False)
    variances = field(tuple_of(float), default=(0.1, 0.1, 0.2, 0.2))
    nms_topk = field(int, default=-1)


def nms_keep(boxes, cls, thresh, force_suppress):
    """Greedy NMS over rows already in score order: ``(N, K)`` bool, a
    row kept when no earlier kept row of its class (any class under
    ``force_suppress``) overlaps it by IoU > ``thresh``.  Rows of class
    < 0 neither survive nor suppress.  One sequential pass over ``i``
    with every image of the batch in one tensor.  Its host range is
    ``nms`` (``MultiBoxTarget``'s is ``multibox_target``), so a profile
    attributes the kernels launched inside."""
    with torch.profiler.record_function("nms"):
        return _nms_keep(boxes, cls, thresh, force_suppress)


def _nms_keep(boxes, cls, thresh, force_suppress):
    K = cls.shape[1]
    iou = _iou(boxes, boxes)                                   # (N, K, K)
    sup = iou > _scalar(thresh, iou)
    if not force_suppress:
        sup &= cls[:, :, None] == cls[:, None, :]
    ar = torch.arange(K, device=cls.device)
    sup &= ar[None, :] > ar[:, None]          # only later rows are killed
    alive = cls >= 0             # an invalid row is dead from the start
    for i in range(K):
        alive &= ~(sup[:, i] & alive[:, i, None])
    return alive


def decode_sorted(params, cls_prob, loc_pred, anchors):
    """Decoded boxes (N, A, 4), foreground class ids (N, A; -1 at or
    below ``threshold``) and scores (N, A; 0 there), in descending score
    order: the rows ``MultiBoxDetection`` runs NMS over."""
    anchors = anchors[0]
    var = torch.tensor(params.variances, dtype=anchors.dtype,
                       device=anchors.device)
    N, A = cls_prob.shape[0], anchors.shape[0]
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    t = loc_pred.reshape(N, A, 4)
    cx = t[..., 0] * var[0] * aw + acx
    cy = t[..., 1] * var[1] * ah + acy
    w = _f64(torch.exp, t[..., 2] * var[2]) * aw
    h = _f64(torch.exp, t[..., 3] * var[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if params.clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    bg = params.background_id
    fg = torch.cat([cls_prob[:, :bg], cls_prob[:, bg + 1:]], 1)
    score = torch.max(fg, 1).values
    best = torch.argmax(fg, 1)                      # the first maximum
    keep = score > _scalar(params.threshold, score)
    cls_id = torch.where(keep, best.float(), _scalar(-1.0, best.float()))
    score = torch.where(keep, score, _scalar(0.0, score))
    order = descending(score)
    return (torch.gather(boxes, 1, order[..., None].expand(N, A, 4)),
            torch.gather(cls_id, 1, order), torch.gather(score, 1, order))


@register_op("MultiBoxDetection", aliases=("_contrib_MultiBoxDetection",))
class MultiBoxDetectionOp(OpDef):
    """Decode predictions and run greedy NMS (multibox_detection-inl.h).

    inputs: cls_prob (N, cls+1, A), loc_pred (N, A*4), anchors (1, A, 4)
    output: (N, A, 6) rows [class_id, score, x1, y1, x2, y2] in score
    order (a stable sort: equal scores keep anchor order); class ids are
    relative to the foreground (the ``background_id`` row removed); a
    score must exceed ``threshold``; class -1 marks suppressed or invalid
    rows.  NMS runs over the top ``nms_topk`` rows."""

    param_cls = MultiBoxDetectionParam
    is_loss = True

    def list_arguments(self, params):
        return ["cls_prob", "loc_pred", "anchor"]

    def infer_shape(self, params, in_shapes):
        cls_prob = in_shapes[0]
        A = in_shapes[2][1]
        return list(in_shapes), [(cls_prob[0], A, 6)], []

    def forward(self, params, inputs, aux, train, key):
        boxes_o, cls_o, score_o = decode_sorted(
            params, *(x.detach() for x in inputs))
        N, A = cls_o.shape
        topk = min(params.nms_topk, A) if params.nms_topk > 0 else A
        alive = torch.zeros((N, A), dtype=torch.bool, device=cls_o.device)
        alive[:, :topk] = nms_keep(boxes_o[:, :topk], cls_o[:, :topk],
                                   params.nms_threshold,
                                   params.force_suppress)
        cls_f = torch.where(alive, cls_o, _scalar(-1.0, cls_o))
        dt = torch.promote_types(torch.float32, boxes_o.dtype)
        out = torch.cat([cls_f[..., None].to(dt), score_o[..., None].to(dt),
                         boxes_o.to(dt)], -1)
        return [out], []

    def backward(self, params, out_grads, inputs, outputs):
        return [torch.zeros_like(x) for x in inputs]
