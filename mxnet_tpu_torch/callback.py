"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``):
``do_checkpoint`` and ``module_checkpoint`` (epoch end),
``log_train_metric`` and ``Speedometer`` (batch end, on the
``BatchEndParam`` that ``fit`` passes).

``Speedometer`` waits for the device (``mx.nd.waitall``) before it reads
the clock at the start and end of each window, so its samples/s is what
the device completed, not the rate at which the host queued work.
"""
from __future__ import annotations

import logging
import time

__all__ = ["do_checkpoint", "module_checkpoint", "log_train_metric",
           "Speedometer"]


def _log_metric(prefix_fmt, prefix_args, metric, reset=False):
    for name, value in metric.get_name_value():
        logging.info(prefix_fmt + "\tTrain-%s=%f",
                     *(prefix_args + (name, value)))
    if reset:
        metric.reset()


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback: ``mod.save_checkpoint(prefix, epoch + 1,
    save_optimizer_states)`` every ``period`` epochs; resume with
    ``Module.load(prefix, epoch, load_optimizer_states=True)`` or
    ``Module.load_latest``."""
    period = max(1, int(period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback writing ``(symbol, arg_params, aux_params)``
    as a checkpoint of epoch ``iter_no + 1`` every ``period`` epochs."""
    from .model import save_checkpoint
    period = max(1, int(period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the training metric every ``period``
    batches."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            _log_metric("Iter[%d] Batch[%d]", (param.epoch, param.nbatch),
                        param.eval_metric, reset=auto_reset)
    return _callback


class Speedometer:
    """Batch-end callback logging samples/s (and the running metric,
    which it then resets) every ``frequent`` batches."""

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self._window_start = None
        self._prev_nbatch = 0

    def __call__(self, param):
        from . import ndarray as nd
        if param.nbatch < self._prev_nbatch:
            self._window_start = None   # a new epoch opens a new window
        self._prev_nbatch = param.nbatch
        if self._window_start is None:
            nd.waitall()
            self._window_start = time.time()
            return
        if param.nbatch % self.frequent != 0:
            return
        nd.waitall()
        speed = self.frequent * self.batch_size / max(
            1e-12, time.time() - self._window_start)
        if param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                             "\tTrain-%s=%f", param.epoch, param.nbatch,
                             speed, name, value)
            param.eval_metric.reset()
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, param.nbatch, speed)
        self._window_start = time.time()
