"""The module API contract and the training loop (counterpart of
``mxnet_tpu/module/base_module.py``): ``fit`` and ``score`` on top of
``bind`` / ``init_params`` / ``init_optimizer`` / ``forward`` /
``backward`` / ``update``, which concrete modules provide."""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod

__all__ = ["BaseModule", "BatchEndParam"]


def _as_list(obj):
    if obj is None:
        return []
    return obj if isinstance(obj, list) else [obj]


class BatchEndParam:
    """What a batch-end callback receives."""

    def __init__(self, epoch, nbatch, eval_metric, locals):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


class BaseModule:
    """A trainable computation with bound shapes, parameters and
    optimizer state."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    def forward_backward(self, data_batch):
        """``forward(is_train=True)`` then ``backward`` on one batch."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params=None, allow_missing=False,
                   force_init=True):
        """Assign parameter values directly (``init_params`` without an
        initializer)."""
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0):
        """``eval_metric`` over ``eval_data``, forward only; returns
        ``[(name, value)]``."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            for callback in _as_list(batch_end_callback):
                callback(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=None))
        return eval_metric.get_name_value()

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None):
        """Train: bind, initialise parameters and optimizer, then per
        epoch one ``forward_backward`` + ``update`` + metric update per
        batch, the callbacks, and a score on ``eval_data``."""
        assert num_epoch is not None, "please specify number of epochs"
        from ..initializer import Uniform
        if initializer is None:
            initializer = Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = metric_mod.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            for nbatch, data_batch in enumerate(train_data):
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                for callback in _as_list(batch_end_callback):
                    callback(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals()))
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            arg_params_, aux_params_ = self.get_params()
            for callback in _as_list(epoch_end_callback):
                callback(epoch, self.symbol, arg_params_, aux_params_)
            if eval_data:
                res = self.score(eval_data, validation_metric,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()
