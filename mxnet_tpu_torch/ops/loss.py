"""Loss heads with explicit backward semantics.

The port of ``mxnet_tpu/ops/loss.py``'s ``SoftmaxOutput`` and
``SoftmaxCELoss``.  Their gradient is that of an implicit loss and, as in
the reference, ignores the head gradient unless ``out_grad=True``:
SoftmaxOutput's backward is ``(softmax(x) - onehot(label)) * grad_scale``
(normalized per ``normalization``) whatever flows in from above.

The registered loss ops of the training frontend are the reference's:
``SoftmaxOutput`` and ``SoftmaxCELoss`` run the functions here; the
regression outputs, ``MakeLoss``, ``BlockGrad``, ``SVMOutput`` and
``softmax_cross_entropy`` declare their backward, run through
``op.apply_op``'s autograd Function; ``CTCLoss`` raises when run
(ROADMAP §A15b).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..param import Params, field
from .op import OpDef, not_ported, register_op, register_simple_op

__all__ = ["SoftmaxOutput", "SoftmaxCELoss"]

_NORMS = ("null", "batch", "valid")


def _minus_onehot(prob, lab):
    """``prob - onehot(lab)`` without materialising the one-hot: labels
    outside [0, nclass) subtract nothing, as ``jax.nn.one_hot`` gives
    them a zero row."""
    inside = (lab >= 0) & (lab < prob.shape[-1])
    grad = prob.clone()
    grad.scatter_add_(-1, torch.where(inside, lab, 0)[:, None],
                      -inside.to(prob.dtype)[:, None])
    return grad


def _normalize(grad, mask, lab, normalization, n_rows):
    if normalization == "valid":
        # the count of labels not ignored (all of them without use_ignore)
        valid = (mask.sum().clamp_min(1).to(grad.dtype) if mask is not None
                 else float(lab.numel()))
        return grad / valid
    if normalization == "batch":
        return grad / n_rows
    return grad


class _SoftmaxOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                preserve_shape, normalization, out_grad, multi_output):
        if multi_output:
            prob = torch.softmax(data, dim=1)
        elif data.dim() > 2 and not preserve_shape:
            prob = torch.softmax(data.reshape(data.shape[0], -1),
                                 dim=-1).reshape(data.shape)
        else:
            prob = torch.softmax(data, dim=-1)
        ctx.save_for_backward(prob, label)
        ctx.args = (grad_scale, ignore_label, use_ignore, normalization,
                    out_grad, multi_output)
        return prob

    @staticmethod
    def backward(ctx, g):
        prob, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, normalization, out_grad, \
            multi_output = ctx.args
        if label.shape == prob.shape:
            # probability labels (soft targets)
            grad = prob - label.to(prob.dtype)
            if out_grad:
                grad = grad * g.to(grad.dtype)
            return (grad * grad_scale,) + (None,) * 8
        if multi_output:
            return (_multi_output_grad(prob, label, g, *ctx.args[:5]),) \
                + (None,) * 8
        lab = label.long().reshape(-1)
        grad = _minus_onehot(prob.reshape(lab.numel(), -1),
                             lab).reshape(prob.shape)
        if out_grad:
            grad = grad * g.to(grad.dtype)
        mask = None
        if use_ignore:
            mask = lab != int(ignore_label)
            grad = grad * mask.reshape(prob.shape[:-1] + (1,)).to(grad.dtype)
        grad = _normalize(grad, mask, lab, normalization, prob.shape[0])
        return (grad * grad_scale,) + (None,) * 8


def _multi_output_grad(prob, label, g, grad_scale, ignore_label, use_ignore,
                       normalization, out_grad):
    """The multi-output backward (softmax over axis 1 of (n, c, d1...)):
    every accepted label layout is read as (n, d1...); the spatial
    extent always divides (null mode), times n in batch mode; valid
    divides by the non-ignored count."""
    spatial_shape = prob.shape[:1] + prob.shape[2:]
    lab = label.long().reshape(spatial_shape)
    nclass = prob.shape[1]
    inside = (lab >= 0) & (lab < nclass)
    grad = prob.clone()
    grad.scatter_add_(1, torch.where(inside, lab, 0).unsqueeze(1),
                      -inside.to(prob.dtype).unsqueeze(1))
    if out_grad:
        grad = grad * g.to(grad.dtype)
    mask = None
    if use_ignore:
        mask = lab != int(ignore_label)
        grad = grad * mask.unsqueeze(1).to(grad.dtype)
    spatial = max(math.prod(prob.shape[2:]), 1)
    if normalization == "valid":
        grad = _normalize(grad, mask, lab, "valid", prob.shape[0])
    elif normalization == "batch":
        grad = grad / (spatial * prob.shape[0])
    else:
        grad = grad / spatial
    return grad * grad_scale


def SoftmaxOutput(data, label, grad_scale=1.0, ignore_label=-1.0,
                  multi_output=False, use_ignore=False,
                  preserve_shape=False, normalization="null",
                  out_grad=False):
    """Softmax forward over the last axis; cross-entropy gradient
    backward, ``(p - onehot) * grad_scale`` divided by the row count
    (``normalization="batch"``) or the count of non-ignored labels
    (``"valid"``), ignoring the head gradient unless ``out_grad``.  A
    label of data's shape is a soft target (gradient ``p - label``).
    ``multi_output`` takes the softmax over axis 1 of (n, c, d1...) data,
    one label per (n, d1...) position."""
    if normalization not in _NORMS:
        raise ValueError(f"SoftmaxOutput: normalization must be "
                         f"null|batch|valid (got {normalization!r})")
    return _SoftmaxOutput.apply(data, label, float(grad_scale),
                                float(ignore_label), bool(use_ignore),
                                bool(preserve_shape), normalization,
                                bool(out_grad), bool(multi_output))


class _SoftmaxCELoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                normalization, out_grad):
        xf = data.float()
        lab = label.long()
        picked = xf.gather(-1, lab.clamp(0, xf.shape[-1] - 1)[:, None])[:, 0]
        loss = torch.logsumexp(xf, dim=-1) - picked
        if use_ignore:
            loss = torch.where(lab == int(ignore_label),
                               torch.zeros((), device=loss.device), loss)
        ctx.save_for_backward(data, label)
        ctx.args = (grad_scale, ignore_label, use_ignore, normalization,
                    out_grad)
        return loss

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, normalization, out_grad = \
            ctx.args
        lab = label.long()
        # recomputed from the logits: no (N, V) residual kept
        grad = _minus_onehot(torch.softmax(data.float(), dim=-1), lab)
        mask = None
        if use_ignore:
            mask = lab != int(ignore_label)
            grad = grad * mask[:, None]
        grad = _normalize(grad, mask, lab, normalization, data.shape[0])
        if out_grad:
            grad = grad * g.to(grad.dtype)[:, None]
        grad = grad * grad_scale
        return (grad.to(data.dtype),) + (None,) * 6


def SoftmaxCELoss(data, label, grad_scale=1.0, ignore_label=-1.0,
                  use_ignore=False, normalization="null", out_grad=False):
    """Per-row negative log-likelihood ``logsumexp(x) - x[label]`` of
    (N, V) logits, in float32; the backward recomputes
    ``softmax(x) - onehot`` from the logits, normalized like
    :func:`SoftmaxOutput`, and ignores the head gradient unless
    ``out_grad``."""
    if data.dim() != 2:
        raise ValueError(f"SoftmaxCELoss: data must be (N, V) logits, "
                         f"got {tuple(data.shape)}")
    if normalization not in _NORMS:
        raise ValueError(f"SoftmaxCELoss: normalization must be "
                         f"null|batch|valid (got {normalization!r})")
    return _SoftmaxCELoss.apply(data, label, float(grad_scale),
                                float(ignore_label), bool(use_ignore),
                                normalization, bool(out_grad))


# -- the registered loss ops of the training frontend ------------------------
# SoftmaxOutput and SoftmaxCELoss run the functions above (autograd
# Functions already); the rest declare ``backward`` and run through
# ``op.apply_op``'s Function.
class SoftmaxOutputParam(Params):
    grad_scale = field(float, default=1.0)
    ignore_label = field(float, default=-1.0)
    multi_output = field(bool, default=False)
    use_ignore = field(bool, default=False)
    preserve_shape = field(bool, default=False)
    normalization = field(str, default="null", enum=("null", "batch", "valid"))
    out_grad = field(bool, default=False,
                     doc="scale the gradient by the incoming output "
                         "gradient (softmax_output-inl.h:132)")


@register_op("SoftmaxOutput", aliases=("Softmax",))
class SoftmaxOutputOp(OpDef):
    """Softmax forward + cross-entropy gradient backward."""

    param_cls = SoftmaxOutputParam
    is_loss = True

    def list_arguments(self, params):
        return ["data", "label"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            raise ValueError("SoftmaxOutput: data shape unknown")
        given = in_shapes[1] if len(in_shapes) > 1 else None
        # label.shape == data.shape: use probability as label
        if given is not None and tuple(given) == tuple(d):
            return [tuple(d), tuple(d)], [tuple(d)], []
        if params.multi_output:
            # data (n, c, d1...), label (n, d1...) (or flattened variants)
            label = (d[0],) + tuple(d[2:])
            n_rest = int(np.prod(d)) // (d[0] * d[1]) if len(d) > 1 else 1
            variants = {label, (d[0], n_rest), tuple(d[:1]) + (1,) + tuple(d[2:])}
            if given is not None and tuple(given) in variants:
                label = tuple(given)
        else:
            label = (d[0],)
        return [tuple(d), label], [tuple(d)], []

    def forward(self, params, inputs, aux, train, key):
        return [SoftmaxOutput(inputs[0], inputs[1], **params.full_dict())], []


class RegressionParam(Params):
    grad_scale = field(float, default=1.0)


def _reg_label_shape(self, params, in_shapes):
    """Label-shape rule of regression_output-inl.h:105-130."""
    d = in_shapes[0]
    if d is None:
        raise ValueError("regression output: data shape unknown")
    d = tuple(d)
    lbl = in_shapes[1]
    if lbl is None:
        lbl = (d[0],) if len(d) == 2 and d[1] == 1 else d
    else:
        lbl = tuple(lbl)
        if (lbl[0] != d[0]
                or int(np.prod(lbl)) != int(np.prod(d))):
            raise ValueError(
                f"regression output: shape inconsistent, provided label "
                f"{lbl}, inferred {d}")
    return [d, lbl], [d], []


@register_op("LinearRegressionOutput")
class LinearRegressionOutputOp(OpDef):
    """Identity forward, (pred - label) backward (regression_output-inl.h)."""

    param_cls = RegressionParam
    is_loss = True

    def list_arguments(self, params):
        return ["data", "label"]

    infer_shape = _reg_label_shape

    def forward(self, params, inputs, aux, train, key):
        return [inputs[0]], []

    def backward(self, params, out_grads, inputs, outputs):
        scale = params.grad_scale / outputs[0].shape[0]
        g = (outputs[0] - inputs[1].reshape(outputs[0].shape)) * scale
        return [g, torch.zeros_like(inputs[1])]


@register_op("MAERegressionOutput")
class MAERegressionOutputOp(LinearRegressionOutputOp):
    def backward(self, params, out_grads, inputs, outputs):
        scale = params.grad_scale / outputs[0].shape[0]
        g = torch.sign(outputs[0] - inputs[1].reshape(outputs[0].shape)) * scale
        return [g, torch.zeros_like(inputs[1])]


@register_op("LogisticRegressionOutput")
class LogisticRegressionOutputOp(OpDef):
    """Sigmoid forward, (sigmoid(x) - label) backward."""

    param_cls = RegressionParam
    is_loss = True

    def list_arguments(self, params):
        return ["data", "label"]

    infer_shape = _reg_label_shape

    def forward(self, params, inputs, aux, train, key):
        return [torch.sigmoid(inputs[0])], []

    def backward(self, params, out_grads, inputs, outputs):
        scale = params.grad_scale / outputs[0].shape[0]
        g = (outputs[0] - inputs[1].reshape(outputs[0].shape)) * scale
        return [g, torch.zeros_like(inputs[1])]


class MakeLossParam(Params):
    grad_scale = field(float, default=1.0)
    valid_thresh = field(float, default=0.0)
    normalization = field(str, default="null", enum=("null", "batch", "valid"))


@register_op("MakeLoss")
class MakeLossOp(OpDef):
    """Turn any symbol into a loss: forward = identity, backward =
    grad_scale (make_loss-inl.h)."""

    param_cls = MakeLossParam
    is_loss = True

    def forward(self, params, inputs, aux, train, key):
        return [inputs[0]], []

    def backward(self, params, out_grads, inputs, outputs):
        x = inputs[0]
        if params.normalization == "valid":
            # grad_scale / #valid at every position: the count
            # normalizes, it does not mask (make_loss-inl.h:84-93)
            valid = torch.clamp_min(
                torch.sum((x > params.valid_thresh).to(x.dtype)), 1.0)
            g = torch.full_like(x, params.grad_scale) / valid
        elif params.normalization == "batch":
            g = torch.full_like(x, params.grad_scale / x.shape[0])
        else:
            g = torch.full_like(x, params.grad_scale)
        return [g]


@register_op("BlockGrad", aliases=("stop_gradient",))
class BlockGradOp(OpDef):
    """Identity forward, zero backward (block_grad-inl.h)."""

    is_loss = True

    def forward(self, params, inputs, aux, train, key):
        return [inputs[0].detach()], []

    def backward(self, params, out_grads, inputs, outputs):
        return [torch.zeros_like(inputs[0])]


class SVMOutputParam(Params):
    margin = field(float, default=1.0)
    regularization_coefficient = field(float, default=1.0)
    use_linear = field(bool, default=False)


@register_op("SVMOutput")
class SVMOutputOp(OpDef):
    """Hinge-loss output layer (svm_output-inl.h)."""

    param_cls = SVMOutputParam
    is_loss = True

    def list_arguments(self, params):
        return ["data", "label"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        return [tuple(d), (d[0],)], [tuple(d)], []

    def forward(self, params, inputs, aux, train, key):
        return [inputs[0]], []

    def backward(self, params, out_grads, inputs, outputs):
        # one-vs-all hinge (src/operator/svm_output.cc:12-48), s_j = +1
        # for the true class and -1 otherwise
        x, label = inputs[0], inputs[1]
        onehot = torch.nn.functional.one_hot(label.long(), x.shape[1]).to(
            x.dtype)
        sign = 2 * onehot - 1
        slack = params.margin - sign * x
        if params.use_linear:
            g = -sign * (slack > 0).to(x.dtype)
        else:
            g = -2 * sign * torch.clamp_min(slack, 0)
        g = g * params.regularization_coefficient
        return [g.to(x.dtype), torch.zeros_like(label)]


class IdentityAttachKLSparseRegParam(Params):
    sparseness_target = field(float, default=0.1)
    penalty = field(float, default=0.001)
    momentum = field(float, default=0.9)


@register_op("IdentityAttachKLSparseReg")
class IdentityAttachKLSparseRegOp(OpDef):
    """Identity with a moving average of the mean activation kept in an
    aux state (identity_attach_KL_sparse_reg-inl.h)."""

    param_cls = IdentityAttachKLSparseRegParam
    is_loss = False

    def list_auxiliary_states(self, params):
        return ["moving_avg"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        return list(in_shapes), [tuple(d)], [(1,)]

    def forward(self, params, inputs, aux, train, key):
        x = inputs[0]
        avg = aux[0]
        if train:
            m = params.momentum
            new_avg = m * avg + (1 - m) * torch.mean(x.detach()).reshape(1)
            return [x], [new_avg]
        return [x], [avg]


class CTCLossParam(Params):
    use_data_lengths = field(bool, default=False)
    use_label_lengths = field(bool, default=False)
    blank_label = field(str, default="first", enum=("first", "last"))
    padding_mask = field(float, default=-1.0)


@register_op("CTCLoss", aliases=("ctc_loss", "WarpCTC", "_contrib_CTCLoss"))
class CTCLossOp(OpDef):
    """The reference's ``CTCLoss`` signature and shape rules; running it
    waits for A15b."""

    param_cls = CTCLossParam
    is_loss = True

    def list_arguments(self, params):
        args = ["data", "label"]
        if params.use_data_lengths:
            args.append("data_lengths")
        if params.use_label_lengths:
            args.append("label_lengths")
        return args

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            raise ValueError("CTCLoss: data shape unknown")
        T, N, C = d
        lab = in_shapes[1] or (N, max(T // 2, 1))
        shapes = [tuple(d), tuple(lab)]
        if params.use_data_lengths:
            shapes.append((N,))
        if params.use_label_lengths:
            shapes.append((N,))
        return shapes, [(N,)], []

    def forward(self, params, inputs, aux, train, key):
        raise not_ported("the CTCLoss op")


def _softmax_cross_entropy(data, label):
    # loss_binary_op-inl.h:35-70: sum_i -log(max(p_i[y_i], 1e-8))
    prob = torch.softmax(data, dim=-1)
    picked = prob.gather(-1, label.long()[:, None])[:, 0]
    return torch.sum(-torch.log(torch.clamp_min(picked, 1e-8))).reshape(1)


def _softmax_cross_entropy_shape(params, in_shapes):
    d, l = in_shapes
    if d is None:
        raise ValueError("softmax_cross_entropy: data shape unknown")
    if len(d) != 2 or (l is not None and (len(l) != 1 or l[0] != d[0])):
        raise ValueError("softmax_cross_entropy: data must be 2D, label 1D "
                         "with matching dim0")
    return [d, (d[0],)], (1,)


def _softmax_cross_entropy_backward(params, out_grads, inputs, outputs):
    # loss_binary_op-inl.h:73-99: data_grad = scale * (softmax - onehot)
    data, label = inputs
    prob = torch.softmax(data, dim=-1)
    scale = out_grads[0].reshape(()).to(prob.dtype)
    return [scale * _minus_onehot(prob, label.long()),
            torch.zeros_like(label)]


register_simple_op("softmax_cross_entropy", _softmax_cross_entropy, nin=2,
                   shape_rule=_softmax_cross_entropy_shape,
                   backward_fn=_softmax_cross_entropy_backward)


class SoftmaxCELossParam(Params):
    grad_scale = field(float, default=1.0)
    ignore_label = field(float, default=-1.0)
    use_ignore = field(bool, default=False)
    normalization = field(str, default="null", enum=("null", "batch", "valid"),
                          doc="gradient normalization, mirroring "
                              "SoftmaxOutputParam so loss='ce' keeps the "
                              "effective gradient scale of loss='softmax'")
    out_grad = field(bool, default=False,
                     doc="scale the gradient by the incoming output "
                         "gradient (loss-layer contract: ignored by "
                         "default, like SoftmaxOutput)")


@register_op("SoftmaxCELoss", aliases=("softmax_ce_loss",))
class SoftmaxCELossOp(OpDef):
    """Fused cross-entropy head: per-position NLL straight from logits,
    the backward recomputing softmax - onehot from them."""

    param_cls = SoftmaxCELossParam
    is_loss = True

    def list_arguments(self, params):
        return ["data", "label"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            raise ValueError("SoftmaxCELoss: data shape unknown")
        if len(d) != 2:
            raise ValueError(
                f"SoftmaxCELoss: data must be (N, V) logits, got {d}")
        return [tuple(d), (d[0],)], [(d[0],)], []

    def forward(self, params, inputs, aux, train, key):
        return [SoftmaxCELoss(inputs[0], inputs[1], **params.full_dict())], []
