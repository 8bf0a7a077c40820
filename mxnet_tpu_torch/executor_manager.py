"""Legacy data-parallel executor manager: the port of
``mxnet_tpu/executor_manager.py`` (MXNet's executor_manager.py:276-424).

``DataParallelExecutorManager`` is the engine FeedForward-era training
loops drove directly: stage a batch, run forward/backward on the
executors, aggregate metrics, and copy weights back.  It is a thin
adapter over the Module-era ``DataParallelExecutorGroup``
(``module/executor_group.py``), with ``sym_gen`` bucketing backed by
shared-memory executor binding (``shared_group``).  It runs on one
device; more contexts raise, naming ROADMAP §A18.
"""

from __future__ import annotations

import logging

from .io import DataDesc
from .module.executor_group import (DataParallelExecutorGroup,
                                    _split_input_slice)
from .ops.op import not_ported

__all__ = ["DataParallelExecutorManager", "_split_input_slice"]


class DataParallelExecutorManager:
    """Helper managing the executors of data-parallel training (MXNet's
    executor_manager.py:276), here over one context.

    Parameters mirror the reference: ``symbol``, ``ctx`` (device list),
    ``train_data`` (provides shapes + batch size), the name lists, an
    optional ``work_load_list``, and ``sym_gen`` for bucketing.
    """

    def __init__(self, symbol, ctx, train_data, arg_names, param_names,
                 aux_names, work_load_list=None, logger=None, sym_gen=None):
        if logger is None:
            logger = logging
        num_device = len(ctx)
        if num_device != 1:
            raise not_ported(f"a DataParallelExecutorManager over "
                             f"{num_device} contexts", "A18")
        logger.info("Start training with %s", str(ctx))
        if work_load_list is None:
            work_load_list = [1] * num_device
        if not isinstance(work_load_list, list) or \
                len(work_load_list) != num_device:
            raise ValueError("Invalid settings for work load.")
        self.arg_names = arg_names
        self.param_names = param_names
        self.aux_names = aux_names
        self.ctx = ctx
        self._work_load_list = work_load_list
        self._logger = logger

        self._data_shapes = list(train_data.provide_data)
        self._label_shapes = list(train_data.provide_label or [])
        self.execgrp = self._bind(symbol)
        # the slices the group actually computes for compute fan-out
        # (derived from provide_data layouts) are THE slices
        self.slices = self.execgrp.slices
        self.symbol = symbol
        self.sym_gen = sym_gen
        self.curr_execgrp = self.execgrp
        self._pending_batch = None
        if self.sym_gen is not None:
            self.execgrp_bucket = {
                train_data.default_bucket_key: self.execgrp}

    def _bind(self, symbol, data_shapes=None, label_shapes=None,
              shared_group=None):
        return DataParallelExecutorGroup(
            symbol, self.ctx, self._work_load_list,
            data_shapes or self._data_shapes,
            label_shapes if label_shapes is not None else self._label_shapes,
            self.param_names, for_training=True, inputs_need_grad=False,
            shared_group=shared_group, logger=self._logger)

    def install_monitor(self, monitor):
        """Install monitor on all executors (reference :332-338)."""
        if self.sym_gen is not None:
            raise NotImplementedError(
                "Monitoring is not implemented for bucketing")
        self.execgrp.install_monitor(monitor)

    def set_params(self, arg_params, aux_params):
        """Push parameter/aux values into every executor (:340-353)."""
        self.execgrp.set_params(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        """Device -> host master copy, averaged over devices (:355-374).
        Updates the passed NDArray dicts in place."""
        self.execgrp.get_params(arg_params, aux_params)

    @property
    def param_arrays(self):
        """Per-parameter lists of per-device arrays (:376-380)."""
        return self.execgrp.param_arrays

    @property
    def grad_arrays(self):
        return self.execgrp.grad_arrays

    @property
    def aux_arrays(self):
        return self.execgrp.aux_arrays

    def load_data_batch(self, data_batch):
        """Stage a batch; with ``sym_gen``, lazily bind the batch's
        bucket sharing memory with the default bucket (:393-410)."""
        if self.sym_gen is not None:
            key = data_batch.bucket_key
            if key not in self.execgrp_bucket:
                symbol = self.sym_gen(key)
                provide = [DataDesc(*d) if not isinstance(d, DataDesc)
                           else d for d in data_batch.provide_data]
                provide_l = [DataDesc(*l) if not isinstance(l, DataDesc)
                             else l
                             for l in (data_batch.provide_label or [])]
                self.execgrp_bucket[key] = self._bind(
                    symbol, provide, provide_l, shared_group=self.execgrp)
            self.curr_execgrp = self.execgrp_bucket[key]
        else:
            self.curr_execgrp = self.execgrp
        # the group snapshots the arrays (the reference copies to device
        # at load): buffer-recycling pipelines can't leak mutations
        self.curr_execgrp.load_data_batch(data_batch)
        self._pending_batch = data_batch

    def forward(self, is_train=False):
        """Forward on the current executor group (:412-414) over the
        batch staged by ``load_data_batch``."""
        if self._pending_batch is None:
            raise ValueError("call load_data_batch before forward")
        self.curr_execgrp.forward(is_train=is_train)

    def backward(self):
        self.curr_execgrp.backward()

    def update_metric(self, metric, labels):
        self.curr_execgrp.update_metric(metric, labels)
