"""BaseModule: the high-level train/predict template, the port of
``mxnet_tpu/module/base_module.py``: ``fit``, ``score``, ``predict``,
``forward_backward``, ``train_step``, parameter get/set and
``save_params``/``load_params`` over the abstract interface (bind /
init_params / init_optimizer / forward / backward / update /
update_metric) that Module implements.  ``fit`` runs the classic loop;
the reference's single-dispatch fused step is ROADMAP §A18.
"""

from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from .. import ndarray as nd
from .. import telemetry
from ..base import MXNetError
from ..callback import BatchEndParam
from ..initializer import Uniform

__all__ = ["BaseModule"]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # ------------------------------------------------------------------ #
    # abstract interface                                                  #
    # ------------------------------------------------------------------ #
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    @property
    def data_names(self):
        raise NotImplementedError

    @property
    def output_names(self):
        raise NotImplementedError

    @property
    def data_shapes(self):
        raise NotImplementedError

    @property
    def label_shapes(self):
        raise NotImplementedError

    @property
    def output_shapes(self):
        raise NotImplementedError

    @property
    def symbol(self):
        return self._symbol

    # ------------------------------------------------------------------ #
    # composite operations                                                #
    # ------------------------------------------------------------------ #
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def train_step(self, data_batch):
        """One forward+backward+optimizer step.  Subclasses with a
        fused single-dispatch program (Module) override; the default is
        the classic two-phase loop.  Returns True when fused."""
        self.forward_backward(data_batch)
        self.update()
        return False

    def _select_fused(self):
        """Fused-train-step object when this module supports the
        single-dispatch path, else None (ROADMAP §A18: none yet)."""
        return None

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Evaluate on a data iterator (base_module.py score)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("module must be binded and initialized")
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric)
                for cb in _as_list(batch_end_callback):
                    cb(param)
        if score_end_callback is not None:
            param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                  eval_metric=eval_metric)
            for cb in _as_list(score_end_callback):
                cb(param)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Forward over an iterator, collecting outputs (base_module.py
        predict; strips pad rows like the reference)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("module must be binded and initialized")
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - pad] for out in self.get_outputs()]
            output_list.append(outputs)
        if not output_list:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                if len(out) != num_outputs:
                    raise MXNetError("inconsistent output count across batches")
            merged = [nd.concatenate([out[i] for out in output_list])
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """Train (reference base_module.py:288 fit)."""
        if num_epoch is None:
            raise MXNetError("num_epoch must be specified")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        # telemetry handles resolved once per fit() call (no-op objects
        # when MXTPU_TELEMETRY is unset — the disabled-path contract)
        tel_batches = telemetry.counter(
            "mxtpu_fit_batches_total", "batches processed by fit()")
        tel_epochs = telemetry.counter(
            "mxtpu_fit_epochs_total", "epochs completed by fit()")
        tel_epoch_secs = telemetry.histogram(
            "mxtpu_fit_epoch_seconds", "wall time per epoch",
            buckets=(1.0, 5.0, 15.0, 60.0, 300.0, 1800.0, 7200.0))
        tel_phase = telemetry.histogram(
            "mxtpu_fit_phase_seconds", "per-batch fit-loop phase time",
            ("phase",))
        ph_data = tel_phase.labels(phase="data_wait")
        ph_fwbw = tel_phase.labels(phase="forward_backward")
        ph_update = tel_phase.labels(phase="update")
        ph_metric = tel_phase.labels(phase="update_metric")

        # metrics accumulate on the host (the reference's device
        # accumulation serves its fused step, ROADMAP §A18); explicit, so
        # a metric reused from another fit follows this one's path
        eval_metric.device_accumulate(0)

        for epoch in range(begin_epoch, num_epoch):
            # perf_counter, not time.time(): NTP slews/steps make the
            # wall clock non-monotonic, so "Time cost=" lines could jump
            tic = time.perf_counter()
            eval_metric.reset()
            data_iter = iter(train_data)
            nbatch = 0
            while True:
                t0 = time.perf_counter()
                with telemetry.span("fit.data_wait"):
                    data_batch = next(data_iter, None)
                if data_batch is None:
                    break
                ph_data.observe(time.perf_counter() - t0)
                if monitor is not None:
                    monitor.tic()
                t0 = time.perf_counter()
                with telemetry.span("fit.forward_backward"):
                    self.forward_backward(data_batch)
                ph_fwbw.observe(time.perf_counter() - t0)
                t0 = time.perf_counter()
                with telemetry.span("fit.update"):
                    self.update()
                ph_update.observe(time.perf_counter() - t0)
                t0 = time.perf_counter()
                with telemetry.span("fit.update_metric"):
                    self.update_metric(eval_metric, data_batch.label)
                ph_metric.observe(time.perf_counter() - t0)
                tel_batches.inc()
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                          eval_metric=eval_metric)
                    for cb in _as_list(batch_end_callback):
                        cb(param)
                nbatch += 1
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            epoch_secs = time.perf_counter() - tic
            tel_epochs.inc()
            tel_epoch_secs.observe(epoch_secs)
            if telemetry.enabled():
                # enclosing epoch span (same perf_counter clock as the
                # per-phase spans, so it nests around them in the trace)
                telemetry.tracer().add_complete(
                    "fit.epoch", tic, time.perf_counter(),
                    {"epoch": epoch, "batches": nbatch})
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, epoch_secs)

            arg_params, aux_params = self.get_params()
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_params, aux_params)

            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name, val)
            train_data.reset()

    # -- checkpointing -----------------------------------------------------
    def save_params(self, fname):
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def load_params(self, fname):
        save_dict = nd.load(fname)
        arg_params, aux_params = {}, {}
        for k, value in save_dict.items():
            tp, name = k.split(":", 1)
            if tp == "arg":
                arg_params[name] = value
            elif tp == "aux":
                aux_params[name] = value
            else:
                raise MXNetError(f"invalid param file {fname}")
        self.set_params(arg_params, aux_params)

    def install_monitor(self, mon):
        raise NotImplementedError


def _as_list(obj):
    if isinstance(obj, (list, tuple)):
        return obj
    return [obj]
