"""Evaluation metrics: the port of ``mxnet_tpu/metric.py``."""

from __future__ import annotations

import numpy as _numpy
import torch
np = None  # rebound below: mx.metric.np is the CustomMetric factory (parity)

from .base import MXNetError
from .ndarray import NDArray
from .registry import Registry

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MAE", "MSE", "RMSE",
           "CrossEntropy", "Loss", "CompositeEvalMetric", "CustomMetric", "np",
           "create"]

METRIC_REGISTRY = Registry("metric")


def _as_np(x):
    return x.asnumpy() if isinstance(x, NDArray) else _numpy.asarray(x)


def check_label_shapes(labels, preds, shape=False):
    if len(labels) != len(preds):
        raise MXNetError(f"label/pred count mismatch {len(labels)} vs {len(preds)}")


class EvalMetric:
    """Base metric with running (sum, count) state (metric.py:14-76).

    Device accumulation (opt-in via :meth:`device_accumulate`): metrics
    that define ``_device_update(label, pred) -> (sum, count)`` — a batch
    contribution on tensors — can keep their running state on the
    device, so the per-batch ``update_metric`` is a few launches instead
    of an ``asnumpy()`` stall.  Host
    ``sum_metric``/``num_inst`` only materialize at sync points: every
    ``frequent`` device updates, and lazily whenever :meth:`get` reads
    the value (so epoch-end logs and Speedometer callbacks are always
    correct)."""

    _device_update = None  # subclasses define (self, label, pred)->(s, n)

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self._device_frequent = 0
        self._dev_state = None
        self._dev_pending = 0
        self.reset()

    def reset(self):
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num
        self._dev_state = None
        self._dev_pending = 0

    def update(self, labels, preds):
        raise NotImplementedError

    # -- device accumulation ------------------------------------------------
    def device_accumulate(self, frequent=50):
        """Opt in to on-device (sum, count) accumulation, syncing to the
        host every ``frequent`` batches.  Returns True when this metric
        supports it (it defines ``_device_update`` and is single-valued);
        unsupported metrics return False and keep the host path.

        ``frequent=0`` (or any falsy value) switches BACK to host
        accumulation — any pending device contributions are folded in
        first, so no data is lost.  ``Module.fit`` sets the mode
        explicitly each run, so a metric instance reused across fits
        follows the current run's path, not a previous run's."""
        if not frequent:
            self._sync_device()
            self._device_frequent = 0
            return False
        if self.num is not None or self._device_update is None:
            return False
        self._device_frequent = max(1, int(frequent))
        return True

    @property
    def device_active(self):
        return self._device_frequent > 0 and self._device_update is not None

    def update_device(self, labels, preds):
        """Add one batch's contribution on the device; host state
        updates only at the sync cadence."""
        ps = [p._data if isinstance(p, NDArray) else torch.as_tensor(p)
              for p in preds]
        dev = ps[0].device if ps else torch.device("cpu")
        ls = [l._data if isinstance(l, NDArray)
              else torch.as_tensor(_numpy.asarray(l)) for l in labels]
        ls = [l.to(dev) for l in ls]
        if self._dev_state is None:
            self._dev_state = (torch.zeros((), device=dev),
                               torch.zeros((), device=dev))
        s, n = self._dev_state
        with torch.no_grad():
            for label, pred in zip(ls, ps):
                ds, dn = self._device_update(label, pred)
                s = s + ds
                n = n + dn
        self._dev_state = (s, n)
        self._dev_pending += 1
        if self._dev_pending >= self._device_frequent:
            self._sync_device()

    def _sync_device(self):
        """Fold the device accumulator into the host running state (the
        only point the metric path touches the host)."""
        if getattr(self, "_dev_state", None) is None:
            self._dev_pending = 0
            return
        s, n = self._dev_state
        self.sum_metric += float(s)
        # device counts are integral by construction; keep num_inst int
        # so host-path and device-path readings agree exactly
        self.num_inst += int(round(float(n)))
        self._dev_state = None
        self._dev_pending = 0

    def get(self):
        if getattr(self, "_dev_pending", 0):
            self._sync_device()
        if self.num is None:
            value = self.sum_metric / self.num_inst if self.num_inst else float("nan")
            return self.name, value
        names = [f"{self.name}_{i}" for i in range(self.num)]
        values = [s / n if n else float("nan")
                  for s, n in zip(self.sum_metric, self.num_inst)]
        return names, values

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            return [(name, value)]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


@METRIC_REGISTRY.register("acc", aliases=("accuracy",))
class Accuracy(EvalMetric):
    def __init__(self):
        super().__init__("accuracy")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _as_np(pred)
            label = _as_np(label).astype(_numpy.int32)
            if pred.ndim > 1:
                pred = _numpy.argmax(pred, axis=-1).astype(_numpy.int32)
            else:
                pred = (pred > 0.5).astype(_numpy.int32)
            label = label.reshape(pred.shape)
            self.sum_metric += float((pred == label).sum())
            self.num_inst += label.size

    def _device_update(self, label, pred):
        if pred.dim() > 1:
            p = torch.argmax(pred, dim=-1).int()
        else:
            p = (pred > 0.5).int()
        l = label.int().reshape(p.shape)
        return (torch.sum(p == l).float(), float(l.numel()))


@METRIC_REGISTRY.register("top_k_accuracy", aliases=("top_k_acc",))
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, **kwargs):
        self.top_k = kwargs.get("top_k", top_k)
        super().__init__(f"top_k_accuracy_{self.top_k}")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            pred = _as_np(pred)
            label = _as_np(label).astype(_numpy.int32)
            topk = _numpy.argsort(pred, axis=-1)[:, -self.top_k:]
            self.sum_metric += float((topk == label[:, None]).any(axis=1).sum())
            self.num_inst += label.shape[0]

    def _device_update(self, label, pred):
        topk = torch.topk(pred, self.top_k, dim=-1).indices
        l = label.int()
        hits = torch.any(topk == l[:, None], dim=1)
        return (torch.sum(hits).float(), float(l.shape[0]))


@METRIC_REGISTRY.register("f1")
class F1(EvalMetric):
    def __init__(self):
        super().__init__("f1")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            pred = _numpy.argmax(_as_np(pred), axis=-1)
            label = _as_np(label).astype(_numpy.int32).reshape(pred.shape)
            tp = float(((pred == 1) & (label == 1)).sum())
            fp = float(((pred == 1) & (label == 0)).sum())
            fn = float(((pred == 0) & (label == 1)).sum())
            precision = tp / (tp + fp) if tp + fp else 0.0
            recall = tp / (tp + fn) if tp + fn else 0.0
            f1 = (2 * precision * recall / (precision + recall)
                  if precision + recall else 0.0)
            self.sum_metric += f1
            self.num_inst += 1

    def _device_update(self, label, pred):
        p = torch.argmax(pred, dim=-1)
        l = label.int().reshape(p.shape)
        tp = torch.sum((p == 1) & (l == 1)).float()
        fp = torch.sum((p == 1) & (l == 0)).float()
        fn = torch.sum((p == 0) & (l == 1)).float()
        zero = torch.zeros((), device=p.device)
        precision = torch.where(tp + fp > 0, tp / (tp + fp), zero)
        recall = torch.where(tp + fn > 0, tp / (tp + fn), zero)
        f1 = torch.where(precision + recall > 0,
                         2 * precision * recall / (precision + recall), zero)
        return f1, 1.0


@METRIC_REGISTRY.register("mae")
class MAE(EvalMetric):
    def __init__(self):
        super().__init__("mae")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            self.sum_metric += float(_numpy.abs(label.reshape(pred.shape) - pred).mean())
            self.num_inst += 1

    def _device_update(self, label, pred):
        err = torch.mean(torch.abs(label.reshape(pred.shape) - pred))
        return err.float(), 1.0


@METRIC_REGISTRY.register("mse")
class MSE(EvalMetric):
    def __init__(self):
        super().__init__("mse")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            self.sum_metric += float(((label.reshape(pred.shape) - pred) ** 2).mean())
            self.num_inst += 1

    def _device_update(self, label, pred):
        err = torch.mean(torch.square(label.reshape(pred.shape) - pred))
        return err.float(), 1.0


@METRIC_REGISTRY.register("rmse")
class RMSE(EvalMetric):
    def __init__(self):
        super().__init__("rmse")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            self.sum_metric += float(
                _numpy.sqrt(((label.reshape(pred.shape) - pred) ** 2).mean()))
            self.num_inst += 1

    def _device_update(self, label, pred):
        err = torch.sqrt(torch.mean(torch.square(label.reshape(pred.shape) - pred)))
        return err.float(), 1.0


@METRIC_REGISTRY.register("ce", aliases=("cross-entropy",))
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_np(label).ravel().astype(_numpy.int64)
            pred = _as_np(pred)
            prob = pred[_numpy.arange(label.shape[0]), label]
            self.sum_metric += float((-_numpy.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]

    def _device_update(self, label, pred):
        l = label.reshape(-1).long()
        prob = pred[torch.arange(l.shape[0], device=pred.device), l]
        return (torch.sum(-torch.log(prob + self.eps)).float(),
                float(l.shape[0]))


@METRIC_REGISTRY.register("loss")
class Loss(EvalMetric):
    """Mean of raw outputs (for MakeLoss-style heads)."""

    def __init__(self):
        super().__init__("loss")

    def update(self, labels, preds):
        for pred in preds:
            pred = _as_np(pred)
            self.sum_metric += float(pred.sum())
            self.num_inst += pred.size

    def _device_update(self, label, pred):
        # Loss ignores labels; the device path still pairs label/pred
        # positionally, matching the host zip() truncation semantics
        return torch.sum(pred).float(), float(pred.numel())


@METRIC_REGISTRY.register("torch")
class Torch(Loss):
    """Mean of external-framework criterion outputs (reference metric.py
    Torch/Caffe: both average the plugin loss op's raw outputs — e.g.
    losses produced through the torch bridge)."""

    def __init__(self, name="torch"):
        super().__init__()
        self.name = name

    def update(self, labels, preds):
        for pred in preds:
            pred = _as_np(pred)
            self.sum_metric += float(pred.mean())
            self.num_inst += 1

    def _device_update(self, label, pred):
        return torch.mean(pred).float(), 1.0


@METRIC_REGISTRY.register("caffe")
class Caffe(Torch):
    def __init__(self):
        super().__init__(name="caffe")


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, **kwargs):
        super().__init__("composite")
        self.metrics = [create(m) if isinstance(m, str) else m
                        for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(metric)

    def get_metric(self, index):
        """Child metric by position (reference metric.py:96)."""
        try:
            return self.metrics[index]
        except IndexError:
            raise ValueError(
                f"Metric index {index} is out of range 0 and "
                f"{len(self.metrics)}") from None

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.extend(n if isinstance(n, list) else [n])
            values.extend(v if isinstance(v, list) else [v])
        return names, values


class CustomMetric(EvalMetric):
    """Metric from a feval(label, pred) function (metric.py CustomMetric)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        name = name or getattr(feval, "__name__", "custom")
        super().__init__(f"custom({name})")
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            reval = self._feval(_as_np(label), _as_np(pred))
            if isinstance(reval, tuple):
                s, n = reval
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy eval function as a metric (metric.py np)."""
    return CustomMetric(numpy_feval, name, allow_extra_outputs)


def create(metric, **kwargs):
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        return CompositeEvalMetric(metrics=[create(m, **kwargs) for m in metric])
    return METRIC_REGISTRY.get(metric)(**kwargs)
