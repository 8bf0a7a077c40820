"""Module: the single-symbol training module, the port of
``mxnet_tpu/module/module.py``.

A Module owns an executor group over one context (``gpu(0)`` unless
given; more than one raises, naming ROADMAP §A18), master parameters on
the CPU, and the local update path (``model._update_params``).
``train_step`` takes the classic forward / backward / update loop:
``_select_fused`` returns None with the reason ``"not_ported"`` (the
reference's single-dispatch fused step is §A18), which changes the
summation order of nothing but the update.
"""

from __future__ import annotations

import logging

from .. import context as ctx_mod
from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError
from ..initializer import Uniform
from ..model import (_create_kvstore, _update_params, load_checkpoint,
                     save_checkpoint)
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=None, work_load_list=None,
                 fixed_param_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = [ctx_mod.current_context()]
        if isinstance(context, ctx_mod.Context):
            context = [context]
        if len(context) != 1:
            raise NotImplementedError(
                f"a Module over {len(context)} contexts is not ported yet "
                "(ROADMAP §A18)")
        self._context = context
        self._work_load_list = work_load_list or [1] * len(context)
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])

        arg_names = symbol.list_arguments()
        self._param_names = [n for n in arg_names
                             if n not in self._data_names
                             and n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()

        self._arg_params = None
        self._aux_params = None
        # dirty = device arrays newer than the CPU master dicts.  Held
        # in a one-element list so modules sharing one set of params
        # (shared_module) share ONE flag: an update through any of them
        # makes get_params on all of them resync
        self._dirty_ref = [False]
        self._exec_group = None
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._fused_reason = None

    @property
    def _params_dirty(self):
        return self._dirty_ref[0]

    @_params_dirty.setter
    def _params_dirty(self, value):
        self._dirty_ref[0] = value

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._exec_group.data_shapes

    @property
    def label_shapes(self):
        return self._exec_group.label_shapes

    @property
    def output_shapes(self):
        _, out_shapes, _ = self._symbol.infer_shape(
            **{d.name: d.shape for d in self.data_shapes})
        return list(zip(self._output_names, out_shapes))

    # -- bind --------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self._exec_group = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        shared_group = None
        arg_params = aux_params = None
        if shared_module is not None:
            # the reference requires both (module.py:260-261); an
            # uninitialized donor would let two modules write divergent
            # random inits into the SAME aliased arrays.  Validate (and
            # sync a dirty donor) BEFORE mutating any state so a raise
            # leaves this module cleanly unbound
            if not (shared_module.binded and shared_module.params_initialized):
                raise MXNetError(
                    "shared_module must be binded and params-initialized")
            missing = [n for n in self._param_names + self._aux_names
                       if n not in shared_module._arg_params
                       and n not in shared_module._aux_params]
            if missing:
                raise MXNetError(
                    f"shared_module does not hold parameters {missing}: "
                    "every param/aux of a sharing module must exist in "
                    "the donor (the shared master dicts would otherwise "
                    "have no entry to sync them into)")
            shared_module.get_params()   # device->master sync if dirty
            shared_group = shared_module._exec_group
            arg_params = shared_module._arg_params
            aux_params = shared_module._aux_params
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list, data_shapes,
            label_shapes, self._param_names, for_training, inputs_need_grad,
            shared_group=shared_group, logger=self.logger,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req)
        if shared_module is not None:
            # share the master param dicts AND the dirty flag (reference
            # module.py:285-288) — both modules see every update.  Every
            # param/aux array ALIASES the donor's (simple_bind raises on
            # any name/shape/dtype/ctx mismatch and the donor-coverage
            # check above rejects extras), so no set_params push is
            # needed — the aliased arrays already hold the live values
            self.params_initialized = True
            self._arg_params = arg_params
            self._aux_params = aux_params
            self._dirty_ref = shared_module._dirty_ref
        elif self._arg_params is not None:
            # params from a previous bind/init: push into new executors
            self._exec_group.set_params(self._arg_params, self._aux_params)
        if shared_module is not None and shared_module.optimizer_initialized:
            self.borrow_optimizer(shared_module)

    def borrow_optimizer(self, shared_module):
        """Share the optimizer/updater/kvstore of an already-initialized
        module so update counts and state are one (reference
        module.py:362-370)."""
        if not shared_module.optimizer_initialized:
            raise MXNetError("optimizer of shared_module is not initialized")
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    # -- params ------------------------------------------------------------
    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        if self._arg_params is None:
            # master copies live on the CPU, as the reference's (whose
            # default context is the CPU)
            self._arg_params = {
                name: nd.zeros(exe_arr.shape, ctx=ctx_mod.cpu(),
                               dtype=exe_arr.dtype)
                for name, exe_arr in zip(
                    self._param_names,
                    [self._exec_group.execs[0].arg_dict[n]
                     for n in self._param_names])}
            self._aux_params = {
                name: nd.zeros(exe_arr.shape, ctx=ctx_mod.cpu(),
                               dtype=exe_arr.dtype)
                for name, exe_arr in zip(
                    self._aux_names,
                    [self._exec_group.execs[0].aux_dict[n]
                     for n in self._aux_names])}

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                cache_arr = cache[name]
                if cache_arr is not arr:
                    arr[:] = cache_arr
            elif not allow_missing and initializer is None:
                raise MXNetError(f"{name} is not presented")
            elif initializer is not None:
                initializer(name, arr)

        for name, arr in sorted(self._arg_params.items()):
            _impl(name, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(name, arr, aux_params)

        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def get_params(self):
        if not (self.binded and self.params_initialized):
            raise MXNetError("module must be binded and initialized")
        if self._params_dirty:
            self._sync_params_from_devices()
        return self._arg_params, self._aux_params

    def _sync_params_from_devices(self):
        """Device -> CPU master copy (reference module.py:472)."""
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if not (self.binded and self.params_initialized):
            raise MXNetError("module must be binded and initialized")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring")
            return
        (kvstore, update_on_kvstore) = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        if isinstance(optimizer, str):
            batch_size = self._exec_group.batch_size
            idx2name = dict(enumerate(self._param_names))
            optimizer_params = dict(optimizer_params)
            # default rescale to 1/global-batch; explicit user value wins
            optimizer_params.setdefault("rescale_grad", 1.0 / batch_size)
            optimizer = opt.create(
                optimizer, param_idx2name=idx2name, sym=self._symbol,
                **optimizer_params)
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True

    # -- fused train step --------------------------------------------------
    def _select_fused(self):
        """The single-dispatch fused step is ROADMAP §A18: always None,
        with the reason ``"not_ported"``, so ``train_step`` takes the
        classic loop."""
        self._fused_reason = "not_ported"
        return None

    def train_step(self, data_batch):
        """One forward+backward+update on the classic loop; returns
        False (no fused path ran)."""
        self._select_fused()
        return super().train_step(data_batch)

    # -- compute -----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("module must be binded and initialized")
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("module must be binded and initialized")
        self._exec_group.backward(out_grads)

    def update(self):
        """Apply the optimizer to every parameter's gradient (reference
        module.py:403 / model.py:98-115)."""
        if not (self.binded and self.params_initialized
                and self.optimizer_initialized):
            raise MXNetError("module not fully initialized")
        self._params_dirty = True
        _update_params(self._exec_group.param_arrays,
                       self._exec_group.grad_arrays,
                       updater=self._updater,
                       num_device=len(self._context),
                       kvstore=self._kvstore)

    def get_outputs(self, merge_multi_context=True):
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        if not self.binded:
            raise MXNetError("call bind first")
        self._exec_group.install_monitor(mon)

    # -- checkpoint --------------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._symbol.save(f"{prefix}-symbol.json")
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
        if save_optimizer_states:
            import pickle

            with open(f"{prefix}-{epoch:04d}.states", "wb") as f:
                f.write(pickle.dumps(self._updater.states))

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod
