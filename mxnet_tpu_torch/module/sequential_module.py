"""SequentialModule: a chain of modules executed back to back, the port
of ``mxnet_tpu/module/sequential_module.py``.

``add(module, take_labels=, auto_wiring=)``; forward feeds each module's
outputs as the next module's data (renamed to its data names under
``auto_wiring``), backward chains the input gradients back.
"""

from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from ..io import DataBatch
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None

    def add(self, module, **kwargs):
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def data_names(self):
        if self._modules:
            return self._modules[0].data_names
        return []

    @property
    def output_names(self):
        if self._modules:
            return self._modules[-1].output_names
        return []

    @property
    def data_shapes(self):
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._modules[-1].output_shapes

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if shared_module is not None:
            # beyond MXNet (which asserts None here,
            # sequential_module.py:217): share layer-by-layer with a
            # structurally identical SequentialModule
            if not isinstance(shared_module, SequentialModule):
                raise MXNetError(
                    "shared_module for SequentialModule must itself be a "
                    "SequentialModule")
            if len(shared_module._modules) != len(self._modules):
                raise MXNetError(
                    "shared_module must contain the same number of "
                    f"sub-modules ({len(shared_module._modules)} vs "
                    f"{len(self._modules)})")
            if not (shared_module.binded and shared_module.params_initialized):
                raise MXNetError(
                    "shared_module must be binded and params-initialized")
        if not self._modules:
            raise MXNetError("add modules first")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = label_shapes

        my_data_shapes = data_shapes
        anybody_ever_needs_label = False
        for i_layer, (meta, module) in enumerate(zip(self._metas, self._modules)):
            meta_take_labels = meta.get(self.META_TAKE_LABELS, False)
            if meta_take_labels:
                my_label_shapes = label_shapes
                anybody_ever_needs_label = True
            else:
                my_label_shapes = None
            my_inputs_need_grad = for_training and (inputs_need_grad or i_layer > 0)
            if meta.get(self.META_AUTO_WIRING, False):
                data_names = module.data_names
                my_data_shapes = [(new_name, shape[1]) for new_name, shape in
                                  zip(data_names, my_data_shapes)]
            module.bind(data_shapes=my_data_shapes, label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=my_inputs_need_grad,
                        force_rebind=force_rebind,
                        shared_module=(shared_module._modules[i_layer]
                                       if shared_module is not None else None),
                        grad_req=grad_req)
            my_data_shapes = module.output_shapes
        if not anybody_ever_needs_label:
            self._label_shapes = None
        self.binded = True
        if shared_module is not None:
            self.params_initialized = True
            if shared_module.optimizer_initialized:
                self.optimizer_initialized = True

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        for module in self._modules:
            module.init_params(initializer=initializer, arg_params=arg_params,
                               aux_params=aux_params,
                               allow_missing=allow_missing,
                               force_init=force_init)
        # check no duplicated names
        self.params_initialized = True

    def get_params(self):
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        batch = DataBatch(data_batch.data, data_batch.label, data_batch.pad,
                          data_batch.index)
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i < len(self._modules) - 1:
                batch = DataBatch(module.get_outputs(), data_batch.label,
                                  data_batch.pad, data_batch.index)

    def backward(self, out_grads=None):
        for i, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        for module in self._modules:
            module.install_monitor(mon)
