"""Module: a symbol trained on one device (counterpart of
``mxnet_tpu/module/module.py``, with the reference's classic
executor-group semantics: ``forward_backward`` fills the gradients and
``update`` steps the optimizer on the host side of each parameter).

``init_params`` takes ``arg_params`` as NDArrays or numpy arrays, which
is how weights cross from the JAX package; ``save_checkpoint`` and
``load`` read and write the reference's checkpoint files
(``prefix-symbol.json`` and ``prefix-NNNN.params``), so a checkpoint
moves between the packages in both directions.

Without a context the module runs on ``cuda:0`` and raises when there is
no GPU; pass ``context=cpu()`` for the plain versions on the host.
"""
from __future__ import annotations

import logging

import torch

from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError
from ..context import default_device
from ..initializer import InitDesc, Uniform
from ..io.io import DataDesc
from ..symbol import load as load_symbol
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module", "load_checkpoint"]


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint written by
    either package's ``save_checkpoint``."""
    symbol = load_symbol("%s-symbol.json" % prefix)
    arg_params, aux_params = {}, {}
    for k, value in nd.load("%s-%04d.params" % (prefix, epoch)).items():
        kind, name = k.split(":", 1)
        if kind == "arg":
            arg_params[name] = value
        elif kind == "aux":
            aux_params[name] = value
        else:
            raise MXNetError("invalid param file key %r" % k)
    return symbol, arg_params, aux_params


def _as_data_desc(x):
    if hasattr(x, "name"):
        return x
    if isinstance(x, (list, tuple)) and len(x) == 2:
        return DataDesc(x[0], x[1])
    raise MXNetError("cannot interpret %r as DataDesc" % (x,))


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, fixed_param_names=None):
        super().__init__(logger=logger)
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise MXNetError("the port's Module runs on one device, "
                                 "got %d contexts" % len(context))
            context = context[0]
        self._context = default_device(context)
        self._symbol = symbol
        arg_names = symbol.list_arguments()
        self._data_names = list(data_names or [])
        self._label_names = [n for n in (label_names or [])
                             if n in arg_names]
        for name in self._data_names:
            if name not in arg_names:
                raise ValueError("data name %r is not an argument of the "
                                 "symbol" % name)
        input_names = self._data_names + self._label_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._params_dirty = False
        self._optimizer = None
        self._updater = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    # -- checkpointing -----------------------------------------------------
    @staticmethod
    def load(prefix, epoch, **kwargs):
        """A Module over a checkpoint's symbol, with its parameters;
        ``bind`` it before use."""
        sym, args, _ = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod.params_initialized = True
        return mod

    def save_checkpoint(self, prefix, epoch):
        """Write ``prefix-symbol.json`` and ``prefix-NNNN.params``."""
        self._symbol.save("%s-symbol.json" % prefix)
        self.save_params("%s-%04d.params" % (prefix, epoch))

    def save_params(self, fname):
        """Parameters under the ``arg:``/``aux:`` key convention."""
        arg_params, _ = self.get_params()
        nd.save(fname, {"arg:%s" % k: v for k, v in arg_params.items()})

    # -- properties --------------------------------------------------------
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
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return [(n, o.shape) for n, o in
                zip(self._output_names, self._exec_group.get_outputs())]

    # -- params ------------------------------------------------------------
    def get_params(self):
        """``(arg_params, aux_params)`` as host NDArrays."""
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._arg_params = {
                n: nd.array(a._data) for n, a in
                zip(self._param_names, self._exec_group.param_arrays)}
            self._params_dirty = False
        return self._arg_params, {}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        """Parameters from ``arg_params`` (NDArrays or numpy arrays) where
        given, else drawn by ``initializer``."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None and (arg_params is None or not force_init):
            initializer = Uniform(0.01)
        if self._arg_params is None:
            self._arg_params = {
                n: nd.zeros(a.shape, dtype=str(a.dtype)) for n, a in
                zip(self._param_names, self._exec_group.param_arrays)}
        attrs = self._symbol.attr_dict()
        for name, arr in self._arg_params.items():
            if arg_params is not None and name in arg_params:
                arr[:] = arg_params[name]
            elif not allow_missing and arg_params is not None and \
                    initializer is None:
                raise MXNetError("%s is not presented" % name)
            elif initializer is not None:
                initializer(InitDesc(name, attrs.get(name)), arr)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params)

    # -- binding -----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, grad_req="write"):
        if force_rebind:
            self.binded = False
            self._exec_group = None
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = [_as_data_desc(x) for x in data_shapes]
        self._label_shapes = [_as_data_desc(x) for x in label_shapes or []
                              if _as_data_desc(x).name in self._label_names]
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._data_shapes,
            self._label_shapes, self._param_names, for_training,
            inputs_need_grad, self._fixed_param_names, grad_req)
        self.binded = True
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params)

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Create the optimizer; ``rescale_grad`` defaults to
        ``1/batch_size``.  On one device the ``local``/``device`` kvstores
        do nothing, as in the reference."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring")
            return
        kv_type = getattr(kvstore, "type", kvstore)
        if kv_type not in (None, "local", "device"):
            raise MXNetError("kvstore %r is not ported yet; the port trains "
                             "on one device with kvstore None, 'local' or "
                             "'device'" % (kv_type,))
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault(
                "rescale_grad", 1.0 / self._exec_group.batch_size)
            optimizer = opt.create(
                optimizer, sym=self._symbol,
                param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        elif not isinstance(optimizer, opt.Optimizer):
            raise MXNetError("optimizer must be a name or an Optimizer")
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True

    # -- computation -------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads)

    def update(self):
        """One optimizer step on every parameter that has a gradient."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        for index, (weight, grad) in enumerate(zip(
                self._exec_group.param_arrays,
                self._exec_group.grad_arrays)):
            if grad is not None:
                self._updater(index, grad, weight)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs()

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    @property
    def device(self):
        return torch.device(self._context)
