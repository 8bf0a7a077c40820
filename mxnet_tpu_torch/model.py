"""Training-loop plumbing of Module: the port of ``mxnet_tpu/model.py``'s
``_create_kvstore``, ``_update_params`` and the two-artifact checkpoint
(``save_checkpoint``/``load_checkpoint``: ``prefix-symbol.json`` +
``prefix-####.params`` in the reference's formats, so checkpoints cross
between the packages in both directions).

One device needs no kvstore: ``_create_kvstore`` returns ``(None,
False)`` for it, and every kvstore (several devices, a ``dist_*`` or a
``KVStore`` object) raises, naming ROADMAP §A18.  ``FeedForward`` is
the reference's estimator over ``module.Module``.
"""

from __future__ import annotations

import logging
import os
import threading

import numpy as np

from . import context as ctx_mod
from . import io as io_mod
from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError
from .initializer import Uniform
from .ops.op import not_ported

__all__ = ["FeedForward", "save_checkpoint", "load_checkpoint"]


def _create_kvstore(kvstore, num_device, arg_params):
    """Select kvstore + update placement (reference model.py:39-76): one
    device and a local kvstore (or none) need none; anything else is
    ROADMAP §A18."""
    if kvstore is None or (isinstance(kvstore, str) and num_device == 1
                           and "dist" not in kvstore):
        return None, False
    raise not_ported(f"kvstore={kvstore!r} over {num_device} device(s)",
                     "A18")


def _update_params(param_arrays, grad_arrays, updater, num_device, kvstore=None):
    """Run the local updater on each parameter's gradient (reference
    model.py:98-115, one device)."""
    if kvstore:
        raise not_ported("a kvstore", "A18")
    for index, pair in enumerate(zip(param_arrays, grad_arrays)):
        arg_list, grad_list = pair
        if grad_list[0] is None:
            continue
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updater(index * num_device + k, g, w)


_async_saves = []
_async_errors = []
_async_saves_lock = threading.Lock()


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    async_save=False, snapshot_owned=False):
    """Two-artifact checkpoint: ``prefix-symbol.json`` +
    ``prefix-####.params`` (reference model.py:318-347).

    ``async_save`` gives orbax-style semantics: the device->host snapshot
    is taken synchronously (the checkpoint reflects this exact step), the
    disk write runs on a background thread into a temp file that is
    atomically renamed on completion, so training never waits on storage
    and a crash mid-write cannot leave a torn checkpoint.  Call
    ``wait_checkpoints()`` (or exit the process cleanly) before relying
    on the file.

    ``snapshot_owned=True`` declares the passed arrays are fresh copies
    the caller will not mutate (e.g. ShardedTrainer.get_params output),
    skipping the defensive per-array copy — avoids a second full host
    copy of large models."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    param_name = f"{prefix}-{epoch:04d}.params"
    if not async_save:
        nd.save(param_name, save_dict)
        logging.info('Saved checkpoint to "%s"', param_name)
        return
    # synchronous snapshot: values are pinned to host numpy NOW (copy=True
    # — np.asarray would alias caller-owned numpy arrays that training
    # keeps mutating in place), so later updates can't leak into the file
    if snapshot_owned:
        snapshot = save_dict
    else:
        snapshot = {k: (v.copyto(ctx_mod.cpu()) if hasattr(v, "copyto")
                        else np.array(v, copy=True))
                    for k, v in save_dict.items()}

    stage_async_write(
        param_name, lambda tmp: nd.save(tmp, snapshot),
        on_done=lambda: logging.info('Saved checkpoint (async) to "%s"',
                                     param_name))


def stage_async_write(path, writer, on_done=None):
    """Stage an ATOMIC background file write tracked by
    :func:`wait_checkpoints`: ``writer(tmp_path)`` produces the file,
    which is renamed over ``path`` only on success; failures are
    recorded per path and re-raised at wait time.  Shared by
    FeedForward/Module checkpoints and ShardedTrainer checkpoints."""

    def _write():
        # pid + thread id: two concurrent in-process saves to the same
        # path must not share (and tear) a temp file
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            writer(tmp)
            os.replace(tmp, path)
            if on_done is not None:
                on_done()
        except BaseException as e:
            try:
                os.remove(tmp)
            except OSError:
                pass
            with _async_saves_lock:
                _async_errors.append((path, e))
            # surfaced by wait_checkpoints(); re-raising here would only
            # trip threading.excepthook as an unhandled thread error
            logging.warning("async checkpoint write failed for %r: %r",
                            path, e)

    t = threading.Thread(target=_write, daemon=False,
                         name=f"ckpt-{os.path.basename(path)}")
    t.start()  # start BEFORE registering: a pre-start thread is not
    with _async_saves_lock:  # alive and a concurrent prune would drop it
        _async_saves[:] = [x for x in _async_saves if x.is_alive()]
        _async_saves.append(t)


def wait_checkpoints():
    """Block until all in-flight async checkpoint writes are on disk.
    Raises the first failure (disk full etc.) instead of silently
    reporting success over a missing epoch."""
    with _async_saves_lock:
        pending = list(_async_saves)
        _async_saves.clear()
    for t in pending:
        t.join()
    with _async_saves_lock:
        errors, _async_errors[:] = list(_async_errors), []
    if errors:
        name, err = errors[0]
        raise MXNetError(
            f"async checkpoint write failed for {name!r}: {err!r}") from err


def load_checkpoint(prefix, epoch):
    """Load (symbol, arg_params, aux_params) (reference model.py:350-384);
    the parameters are NDArrays on the CPU."""
    symbol = sym_mod.load(f"{prefix}-symbol.json")
    save_dict = nd.load(f"{prefix}-{epoch:04d}.params", ctx=ctx_mod.cpu())
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


class FeedForward:
    """The sklearn-style estimator (MXNet's model.py:386 FeedForward),
    over the Module API as the reference's: ``fit``, ``predict``,
    ``score``, ``save``, ``load`` and ``create`` with its constructor's
    surface.  Numpy inputs become ``NDArrayIter``s of
    ``numpy_batch_size`` rows (shuffled, ``roll_over``, for training);
    ``epoch_size`` is kept and, as in the reference, unused: an epoch is
    one pass over the data."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=Uniform(0.01), numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        self.symbol = symbol
        if ctx is None:
            ctx = [ctx_mod.current_context()]
        elif isinstance(ctx, ctx_mod.Context):
            ctx = [ctx]
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None

    # -- helpers -----------------------------------------------------------
    def _init_iter(self, X, y, is_train):
        if isinstance(X, io_mod.DataIter):
            return X
        X = np.asarray(X)
        if y is not None:
            y = np.asarray(y)
        batch_size = min(self.numpy_batch_size, X.shape[0])
        if is_train:
            if y is None:
                raise ValueError("y is required for training")
            return io_mod.NDArrayIter(X, y, batch_size, shuffle=True,
                                      last_batch_handle="roll_over")
        return io_mod.NDArrayIter(X, y, batch_size, shuffle=False)

    def _get_module(self, data):
        from .module import Module

        data_names = [d[0] for d in data.provide_data]
        label_names = [l[0] for l in data.provide_label]
        return Module(self.symbol, data_names=data_names,
                      label_names=label_names, context=self.ctx)

    # -- public API --------------------------------------------------------
    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        data = self._init_iter(X, y, is_train=True)
        if eval_data is not None and not isinstance(eval_data, io_mod.DataIter):
            ex, ey = eval_data
            eval_data = self._init_iter(np.asarray(ex), np.asarray(ey), False)
        self._module = self._get_module(data)
        opt_params = dict(self.kwargs)
        self._module.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                         epoch_end_callback=epoch_end_callback,
                         batch_end_callback=batch_end_callback,
                         kvstore=kvstore, optimizer=self.optimizer,
                         optimizer_params=opt_params,
                         eval_end_callback=eval_end_callback,
                         eval_batch_end_callback=eval_batch_end_callback,
                         initializer=self.initializer,
                         arg_params=self.arg_params, aux_params=self.aux_params,
                         allow_missing=True, begin_epoch=self.begin_epoch,
                         num_epoch=self.num_epoch, monitor=monitor)
        self.arg_params, self.aux_params = self._module.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        data = self._init_iter(X, None, is_train=False)
        if self._module is None or not self._module.binded:
            self._module = self._get_module(data)
            self._module.bind(data.provide_data, data.provide_label,
                              for_training=False)
            self._module.set_params(self.arg_params, self.aux_params or {},
                                    allow_missing=True)
        out = self._module.predict(data, num_batch=num_batch, reset=reset)
        if isinstance(out, list):
            return [o.asnumpy() for o in out]
        return out.asnumpy()

    def score(self, X, y=None, eval_metric="acc", num_batch=None, reset=True):
        data = self._init_iter(X, y, is_train=False)
        if self._module is None or not self._module.binded:
            self._module = self._get_module(data)
            self._module.bind(data.provide_data, data.provide_label,
                              for_training=False)
            self._module.set_params(self.arg_params, self.aux_params or {},
                                    allow_missing=True)
        res = self._module.score(data, eval_metric, num_batch=num_batch,
                                 reset=reset)
        return res[0][1]

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=Uniform(0.01), eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
