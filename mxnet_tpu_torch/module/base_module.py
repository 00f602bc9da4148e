"""The module API contract and the training loop (counterpart of
``mxnet_tpu/module/base_module.py``): ``fit``, ``score``,
``iter_predict`` and ``predict`` on top of ``bind`` / ``init_params`` /
``init_optimizer`` / ``forward`` / ``backward`` / ``update``, which
concrete modules provide.  A ``BucketingModule`` switches to each
batch's bucket in ``prepare`` and ``forward``, so the same loops drive
it over batches of several buckets, and an ``eval_data`` of other
buckets than the training data's."""
from __future__ import annotations

import logging
import time

import numpy as np

from .. import metric as metric_mod
from .. import ndarray as nd

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

    def prepare(self, data_batch):
        """Get ready for ``data_batch`` before its forward (a
        ``BucketingModule`` binds its bucket); nothing here."""

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
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """``eval_metric`` over ``eval_data`` (the first ``num_batch``
        batches), forward only; returns ``[(name, value)]``."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            for callback in _as_list(batch_end_callback):
                callback(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=None))
            actual_num_batch += 1
        for callback in _as_list(score_end_callback):
            callback(BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=None))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs, batch_index, batch)`` for each batch of a
        forward-only pass, the padding rows stripped."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            yield ([out[0:out.shape[0] - pad] for out in self.get_outputs()],
                   nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs of a forward-only pass over ``eval_data`` (an
        iterator, or an NDArray or numpy array that is wrapped in an
        ``NDArrayIter``), the padding rows stripped.  With
        ``merge_batches`` each output's batches are concatenated: one
        NDArray for a one-output net unless ``always_output_list``, else
        a list; without it, a list of each batch's outputs."""
        if isinstance(eval_data, (nd.NDArray, np.ndarray)):
            from ..io.io import NDArrayIter
            eval_data = NDArrayIter(eval_data)
        output_list = [[out.copy() for out in outputs] for outputs, _, _ in
                       self.iter_predict(eval_data, num_batch, reset)]
        if not output_list or not merge_batches:
            return output_list
        num_outputs = len(output_list[0])
        merged = [nd.concatenate([out[i] for out in output_list])
                  for i in range(num_outputs)]
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """Train: bind, initialise parameters and optimizer, then per
        epoch one ``forward_backward`` + ``update`` + metric update per
        batch, the callbacks, and a score on ``eval_data``.  A
        ``monitor`` is installed after the bind, armed before each
        batch (``tic``) and printed after its update (``toc_print``)."""
        assert num_epoch is not None, "please specify number of epochs"
        from ..initializer import Uniform
        if initializer is None:
            initializer = Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
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
                if monitor is not None:
                    monitor.tic()
                self.prepare(data_batch)
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
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
