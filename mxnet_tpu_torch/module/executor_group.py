"""Executor group: the port of ``mxnet_tpu/module/executor_group.py``.

The reference slices each batch across device contexts and keeps one
bound executor a device.  The port binds one context: a group over more
than one raises, naming ROADMAP §A18 (the reference reduces their
gradients through a kvstore).  The rest (layouts' batch axes, the
shared-group memory sharing of ``simple_bind``, staged batches,
per-input gradients) is the reference's.
"""

from __future__ import annotations

import numpy as np

from .. import ndarray as nd
from ..base import MXNetError
from ..io import DataDesc

__all__ = ["DataParallelExecutorGroup"]


def _split_input_slice(batch_size, work_load_list):
    """Slice ranges per device, weighted by workload
    (reference executor_manager.py:15-50)."""
    total = sum(work_load_list)
    if batch_size < len(work_load_list):
        raise MXNetError("batch size smaller than device count")
    slices = []
    start = 0
    for i, load in enumerate(work_load_list):
        if i == len(work_load_list) - 1:
            end = batch_size
        else:
            end = start + int(round(batch_size * load / total))
        slices.append(slice(start, end))
        start = end
    return slices


def _merge_multi_context(outputs):
    """Concatenate per-device outputs along the batch axis
    (reference executor_group.py:52)."""
    return [nd.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
            for parts in outputs]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad, shared_group=None,
                 logger=None, fixed_param_names=None, grad_req="write"):
        if len(contexts) != 1:
            raise NotImplementedError(
                f"an executor group over {len(contexts)} contexts "
                f"{[str(c) for c in contexts]} is not ported yet "
                "(ROADMAP §A18)")
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload or [1] * len(contexts)
        self.param_names = list(param_names)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.execs = []
        self.shared_group = shared_group
        if shared_group is not None and list(shared_group.contexts) != list(
                contexts):
            # silent partial sharing (some executors aliased, others
            # fresh) would leave the extras training on stale weights;
            # the reference's _bind_ith_exec likewise requires matching
            # device lists
            raise MXNetError(
                f"shared_group contexts {shared_group.contexts} do not "
                f"match this group's contexts {contexts}")

        self.grad_req = {}
        for name in self.arg_names:
            if name in self.param_names:
                self.grad_req[name] = (
                    "null" if not for_training or name in self.fixed_param_names
                    else grad_req)
            elif inputs_need_grad and any(name == d[0] for d in data_shapes):
                self.grad_req[name] = grad_req
            else:
                self.grad_req[name] = "null"

        self.bind_exec(data_shapes, label_shapes)

    # -- binding -----------------------------------------------------------
    @staticmethod
    def _batch_axis(desc):
        """Batch ('N') axis of one input from its layout; -1 = no batch
        axis, the input is replicated whole to every device (reference
        executor_group.py:193 major_axis)."""
        return DataDesc.get_batch_axis(getattr(desc, "layout", None))

    def decide_slices(self, data_shapes):
        """Batch-axis slicing honoring per-input layouts
        (reference executor_group.py:193): every input with a batch axis
        must agree on the batch size; axis -1 inputs are not sliced."""
        self.batch_axes = {}
        batch_size = None
        for desc in data_shapes:
            axis = self._batch_axis(desc)
            self.batch_axes[desc.name] = axis
            if axis == -1:
                continue
            b = desc.shape[axis]
            if batch_size is None:
                batch_size = b
            elif b != batch_size:
                raise MXNetError(
                    f"all data must share one batch size: {desc.name} has "
                    f"shape {desc.shape} (axis {axis}) vs batch {batch_size}"
                    "; give no-batch-axis inputs a layout without 'N' "
                    "via mx.io.DataDesc")
        if batch_size is None:
            raise MXNetError("at least one input needs a batch axis")
        self.batch_size = batch_size
        self.slices = _split_input_slice(batch_size, self.workload)

    def _sliced_shape(self, shape, islice, axis=0):
        if axis == -1:
            return tuple(shape)
        shape = list(shape)
        shape[axis] = islice.stop - islice.start
        return tuple(shape)

    @staticmethod
    def _slice_along(arr, islice, axis):
        if axis == -1:
            return arr
        if axis == 0:
            return arr[islice]
        return arr[(slice(None),) * axis + (islice,)]

    def bind_exec(self, data_shapes, label_shapes):
        self.data_shapes = [DataDesc(*d) if not isinstance(d, DataDesc) else d
                            for d in data_shapes]
        self.label_shapes = ([DataDesc(*l) if not isinstance(l, DataDesc) else l
                              for l in label_shapes] if label_shapes else [])
        self.decide_slices(self.data_shapes + self.label_shapes)
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [l.name for l in self.label_shapes]
        self.execs = []
        for i, ctx in enumerate(self.contexts):
            islice = self.slices[i]
            shapes = {d.name: self._sliced_shape(d.shape, islice,
                                                 self.batch_axes[d.name])
                      for d in self.data_shapes + self.label_shapes}
            # memory sharing across bound groups (reference
            # _bind_ith_exec shared_exec, executor_group.py:439-533):
            # the i-th executor of the shared group donates its
            # matching param/grad/aux arrays
            shared_exec = (self.shared_group.execs[i]
                           if self.shared_group is not None
                           and i < len(self.shared_group.execs) else None)
            exe = self.symbol.simple_bind(ctx, grad_req=self.grad_req,
                                          shared_exec=shared_exec, **shapes)
            self.execs.append(exe)

    # -- params ------------------------------------------------------------
    def set_params(self, arg_params, aux_params, allow_extra=False):
        for exe in self.execs:
            exe.copy_params_from(arg_params, aux_params,
                                 allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """Copy params back to CPU dicts (reference: averages over devices
        to wash out any drift)."""
        for name in self.param_names:
            arrs = [exe.arg_dict[name] for exe in self.execs]
            weight = sum(a.asnumpy() for a in arrs) / len(arrs)
            arg_params[name][:] = weight
        for name in self.aux_names:
            arrs = [exe.aux_dict[name] for exe in self.execs]
            aux = sum(a.asnumpy() for a in arrs) / len(arrs)
            aux_params[name][:] = aux

    # -- compute -----------------------------------------------------------
    def load_data_batch(self, data_batch):
        """Stage a batch for a bare ``forward`` (reference
        executor_group load_data_batch).  Arrays are SNAPSHOTTED — the
        reference copies to device at load, so a data pipeline that
        recycles its batch buffers between load and forward must not
        leak the mutation into training (same contract as
        DataParallelExecutorManager.load_data_batch)."""
        from ..io import DataBatch as _DataBatch

        def _snap(arrs):
            return [a.copy() if hasattr(a, "copy") else np.array(a)
                    for a in (arrs or [])]

        self._staged_batch = _DataBatch(
            _snap(data_batch.data), _snap(data_batch.label),
            data_batch.pad, data_batch.index)

    def forward(self, data_batch=None, is_train=None):
        if data_batch is None:
            data_batch = getattr(self, "_staged_batch", None)
            if data_batch is None:
                raise MXNetError("no batch: pass one or load_data_batch first")
        else:
            # "bare forward re-runs the last batch" must mean the MOST
            # RECENT one, however it arrived
            self._staged_batch = data_batch
        if is_train is None:
            is_train = self.for_training
        data = data_batch.data
        labels = data_batch.label or []
        for i, exe in enumerate(self.execs):
            islice = self.slices[i]
            for name, arr in zip(self.data_names, data):
                exe.arg_dict[name][:] = self._slice_along(
                    arr, islice, self.batch_axes[name])
            for name, arr in zip(self.label_names, labels):
                if name in exe.arg_dict:
                    exe.arg_dict[name][:] = self._slice_along(
                        arr, islice, self.batch_axes[name])
            exe.forward(is_train=is_train)

    def get_outputs(self, merge_multi_context=True):
        outputs = [[exe.outputs[i] for exe in self.execs]
                   for i in range(len(self.execs[0].outputs))]
        if merge_multi_context:
            return _merge_multi_context(outputs)
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        grads = [[exe.grad_dict[name] for exe in self.execs]
                 for name in self.data_names]
        if not merge_multi_context:
            return grads
        merged = []
        for name, parts in zip(self.data_names, grads):
            axis = self.batch_axes[name]
            if len(parts) == 1:
                merged.append(parts[0])
            elif axis == -1:
                # replicated input: every device saw the whole array, so
                # per-device gradients sum (not concatenate)
                total = parts[0]
                for p in parts[1:]:
                    total = total + p
                merged.append(total)
            else:
                merged.append(nd.concatenate(parts, axis=axis))
        return merged

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to call backward")
        for i, exe in enumerate(self.execs):
            if out_grads is None:
                exe.backward()
            else:
                islice = self.slices[i]
                exe.backward([g[islice] for g in out_grads])

    def update_metric(self, eval_metric, labels):
        if (getattr(eval_metric, "device_active", False)
                and len(self.execs) == 1
                and len(labels) == len(self.execs[0].outputs)):
            # device-side accumulation: no asnumpy stall.  Pairing must
            # be positional 1:1 (the host kernels zip the same way)
            eval_metric.update_device(labels, self.execs[0].outputs)
            return
        # labels pair positionally with the bound label names; extra
        # labels beyond the bound names (incl. the bound-without-labels
        # case) slice along axis 0
        axes = [self.batch_axes.get(n, 0)
                for n in self.label_names[:len(labels)]]
        axes += [0] * (len(labels) - len(axes))
        for i, exe in enumerate(self.execs):
            islice = self.slices[i]
            labels_slice = [self._slice_along(label, islice, axis)
                            for axis, label in zip(axes, labels)]
            eval_metric.update(labels_slice, exe.outputs)

    @property
    def grad_arrays(self):
        """Per-param list of per-device gradient NDArrays; fixed params
        (grad_req null) have no gradient buffer and yield None, which
        the updater paths skip (reference model.py:98-115 contract)."""
        return [[exe.grad_dict.get(name) for exe in self.execs]
                for name in self.param_names]

    @property
    def param_arrays(self):
        return [[exe.arg_dict[name] for exe in self.execs]
                for name in self.param_names]

    @property
    def aux_arrays(self):
        return [[exe.aux_dict[name] for exe in self.execs]
                for name in self.aux_names]

    def install_monitor(self, mon):
        for exe in self.execs:
            mon.install(exe)
