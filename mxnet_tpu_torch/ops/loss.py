"""Loss heads with explicit backward semantics.

The port of ``mxnet_tpu/ops/loss.py``'s ``SoftmaxOutput`` and
``SoftmaxCELoss``.  Their gradient is that of an implicit loss and, as in
the reference, ignores the head gradient unless ``out_grad=True``:
SoftmaxOutput's backward is ``(softmax(x) - onehot(label)) * grad_scale``
(normalized per ``normalization``) whatever flows in from above.
"""

from __future__ import annotations

import torch

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
                preserve_shape, normalization, out_grad):
        if data.dim() > 2 and not preserve_shape:
            prob = torch.softmax(data.reshape(data.shape[0], -1),
                                 dim=-1).reshape(data.shape)
        else:
            prob = torch.softmax(data, dim=-1)
        ctx.save_for_backward(prob, label)
        ctx.args = (grad_scale, ignore_label, use_ignore, normalization,
                    out_grad)
        return prob

    @staticmethod
    def backward(ctx, g):
        prob, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, normalization, out_grad = \
            ctx.args
        if label.shape == prob.shape:
            # probability labels (soft targets)
            grad = prob - label.to(prob.dtype)
            if out_grad:
                grad = grad * g.to(grad.dtype)
            return (grad * grad_scale,) + (None,) * 7
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
        return (grad * grad_scale,) + (None,) * 7


def SoftmaxOutput(data, label, grad_scale=1.0, ignore_label=-1.0,
                  multi_output=False, use_ignore=False,
                  preserve_shape=False, normalization="null",
                  out_grad=False):
    """Softmax forward over the last axis; cross-entropy gradient
    backward, ``(p - onehot) * grad_scale`` divided by the row count
    (``normalization="batch"``) or the count of non-ignored labels
    (``"valid"``), ignoring the head gradient unless ``out_grad``.  A
    label of data's shape is a soft target (gradient ``p - label``)."""
    if multi_output:
        raise NotImplementedError(
            "SoftmaxOutput(multi_output=True) is not ported yet "
            "(ROADMAP §A15)")
    if normalization not in _NORMS:
        raise ValueError(f"SoftmaxOutput: normalization must be "
                         f"null|batch|valid (got {normalization!r})")
    return _SoftmaxOutput.apply(data, label, float(grad_scale),
                                float(ignore_label), bool(use_ignore),
                                bool(preserve_shape), normalization,
                                bool(out_grad))


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
