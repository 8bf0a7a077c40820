"""Training callbacks: the port's copy of ``mxnet_tpu/callback.py``."""

from __future__ import annotations

import logging
import math
import time

__all__ = ["do_checkpoint", "module_checkpoint", "Speedometer", "ProgressBar",
           "log_train_metric", "BatchEndParam",
           "LogValidationMetricsCallback"]


class BatchEndParam:
    """Callback payload (callback.py namedtuple equivalent)."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def do_checkpoint(prefix, period=1, async_save=False):
    """Epoch-end checkpoint callback (callback.py:11-32).  With
    ``async_save`` the disk write happens on a background thread
    (model.save_checkpoint async contract) so epochs don't stall on
    storage."""
    from .model import save_checkpoint

    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux,
                            async_save=async_save)

    return _callback


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def log_train_metric(period, auto_reset=False):
    """Log metric every ``period`` batches (callback.py:35-57)."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class Speedometer:
    """samples/sec logging (callback.py:61-103) — the reference's
    throughput harness, kept as the benchmark metric surface."""

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.last_speed = None

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                # perf_counter, not time.time(): an NTP step between
                # ticks would report garbage samples/sec (same fix as
                # the fit loop's epoch clock)
                speed = self.frequent * self.batch_size / (
                    time.perf_counter() - self.tic)
                self.last_speed = speed
                if param.eval_metric is not None:
                    for name, value in param.eval_metric.get_name_value():
                        logging.info(
                            "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\tTrain-%s=%f",
                            param.epoch, count, speed, name, value)
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                                 param.epoch, count, speed)
                self.tic = time.perf_counter()
        else:
            self.init = True
            self.tic = time.perf_counter()


class ProgressBar:
    """ASCII progress bar (callback.py ProgressBar)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    """Log eval metrics at epoch end (reference callback.py:127-136);
    pass as ``eval_end_callback`` to ``fit``."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f",
                         param.epoch, name, value)
