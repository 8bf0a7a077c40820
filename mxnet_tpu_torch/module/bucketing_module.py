"""BucketingModule: variable-length training via per-bucket executors,
the port of ``mxnet_tpu/module/bucketing_module.py``.

``sym_gen(bucket_key)`` returns (symbol, data_names, label_names); one
Module per bucket key is bound lazily with ``shared_module=`` the default
bucket's, so every bucket's parameter and auxiliary arrays are the
default bucket's storage (an update through any bucket is seen by all)
and its optimizer is the default bucket's (update counts and states are
one).  A bound BucketingModule may share its parameters and optimizer
with another one (``bind(shared_module=)``, beyond MXNet's, as the
reference).
"""

from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise ValueError("default_bucket_key must be set")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._work_load_list = work_load_list
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        return self._curr_module.symbol

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        sym, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        sym, _, _ = self._call_sym_gen(self._default_bucket_key)
        return sym.list_outputs()

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        return self._curr_module.output_shapes

    def _call_sym_gen(self, bucket_key):
        return self._sym_gen(bucket_key)

    # -- bind / switch -----------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self._buckets = {}
            self.binded = False
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if shared_module is not None and not isinstance(shared_module,
                                                        BucketingModule):
            raise MXNetError(
                "shared_module for BucketingModule must itself be a "
                "BucketingModule")
        if shared_module is not None and not (shared_module.binded
                                              and shared_module.params_initialized):
            raise MXNetError(
                "shared_module must be binded and params-initialized")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        sym, data_names, label_names = self._call_sym_gen(self._default_bucket_key)
        # external sharing (beyond MXNet, which asserts
        # shared_module is None here — bucketing_module.py:176): a
        # train/eval BucketingModule pair shares one set of parameter
        # arrays and one optimizer through the default-bucket Module;
        # each bucket bound later inherits the sharing via switch_bucket
        shared_default = (
            shared_module._buckets[shared_module._default_bucket_key]
            if shared_module is not None else None)
        module = Module(sym, data_names, label_names, logger=self.logger,
                        context=self._context,
                        work_load_list=self._work_load_list)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    force_rebind=False, shared_module=shared_default,
                    grad_req=grad_req)
        self.binded = True
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module
        if shared_module is not None:
            self.params_initialized = True
        if module.optimizer_initialized:
            self._shared_optimizer_source = module
            self.optimizer_initialized = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Switch to (lazily binding) the bucket's module, sharing params
        with the default bucket (MXNet's bucketing_module.py:195).
        As in MXNet, binding a NEW bucket requires init_params to
        have run (Module.bind's shared_module contract)."""
        if not self.binded:
            raise MXNetError("call bind before switch_bucket")
        if bucket_key not in self._buckets:
            sym, data_names, label_names = self._call_sym_gen(bucket_key)
            module = Module(sym, data_names, label_names, logger=self.logger,
                            context=self._context,
                            work_load_list=self._work_load_list)
            module.bind(data_shapes, label_shapes, self._curr_module.for_training,
                        self._curr_module.inputs_need_grad, force_rebind=False,
                        shared_module=self._buckets[self._default_bucket_key])
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    # -- params ------------------------------------------------------------
    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init)
        self.params_initialized = True

    def get_params(self):
        return self._curr_module.get_params()

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        self._shared_optimizer_source = self._curr_module
        self.optimizer_initialized = True

    def _propagate_optimizer(self, module):
        """Reuse the one optimizer/updater/kvstore across bucket modules so
        update counts and state are shared."""
        module.borrow_optimizer(self._shared_optimizer_source)

    # -- compute -----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        """Switches bucket based on data_batch.bucket_key."""
        if data_batch.bucket_key is not None:
            self.switch_bucket(data_batch.bucket_key,
                               data_batch.provide_data,
                               data_batch.provide_label)
            if self.optimizer_initialized and not self._curr_module.optimizer_initialized:
                self._propagate_optimizer(self._curr_module)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        # bucket modules ALIAS one set of parameter arrays and one dirty
        # flag (shared_exec wiring in switch_bucket -> Module.bind ->
        # simple_bind), so the update is visible to every bucket without
        # a propagation copy — the same single-copy semantics as the
        # shared executor memory of MXNet (executor_group.py:439-533)
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        for module in self._buckets.values():
            module.install_monitor(mon)
