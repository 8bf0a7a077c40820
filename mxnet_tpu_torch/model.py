"""Training-loop plumbing of Module: the port of ``mxnet_tpu/model.py``'s
``_create_kvstore``, ``_update_params`` and the two-artifact checkpoint
(``save_checkpoint``/``load_checkpoint``: ``prefix-symbol.json`` +
``prefix-####.params`` in the reference's formats, so checkpoints cross
between the packages in both directions).

One device needs no kvstore: ``_create_kvstore`` returns ``(None,
False)`` for it, and every kvstore (several devices, a ``dist_*`` or a
``KVStore`` object) raises, naming ROADMAP §A18.  ``FeedForward`` waits
for A15b.
"""

from __future__ import annotations

import logging
import os
import threading

import numpy as np

from . import context as ctx_mod
from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError
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
    """The reference's sklearn-style estimator; waits for A15b."""

    def __init__(self, *args, **kwargs):
        raise not_ported("model.FeedForward")
