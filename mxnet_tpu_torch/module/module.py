"""Module: a symbol trained on one device (counterpart of
``mxnet_tpu/module/module.py``, with the reference's classic
executor-group semantics: ``forward_backward`` fills the gradients and
``update`` steps the optimizer on the host side of each parameter).

``init_params`` takes ``arg_params`` and ``aux_params`` as NDArrays or
numpy arrays, which is how weights and BatchNorm's moving statistics
cross from the JAX package; ``save_checkpoint`` and ``load`` read and
write the reference's checkpoint files (``prefix-symbol.json`` and
``prefix-NNNN.params``, with ``arg:`` and ``aux:`` keys, and with
``save_optimizer_states`` ``prefix-NNNN.states``, the pickled v2
envelope of :mod:`..optimizer`, numpy arrays only), so a checkpoint and
its optimizer state move between the packages in both directions.
``reshape`` rebinds to new input shapes over the same parameter,
gradient and auxiliary arrays; ``get_input_grads`` returns the data
gradients of a module bound with ``inputs_need_grad``.

``bind(shared_module=)`` binds over another bound module's parameter,
gradient and auxiliary arrays themselves (a ``BucketingModule``'s
buckets), and ``borrow_optimizer`` takes its optimizer and updater, so
every bucket steps one set of tensors with one optimizer state keyed by
parameter index.  ``state_names`` are inputs that are neither data nor
parameters (an RNN's carried state: ``get_states`` / ``set_states``);
``install_monitor`` hands a :class:`~mxnet_tpu_torch.monitor.Monitor`
the executor's outputs and arguments.

Without a context the module runs on ``cuda:0`` and raises when there is
no GPU; pass ``context=cpu()`` for the plain versions on the host.

``compute_dtype='bfloat16'`` trains in mixed precision, as the
reference's ``Module(compute_dtype=...)``: the parameters, their
gradients, the optimizer state, ``get_params`` and checkpoints stay
float32, and every step casts the parameters to bf16 for the forward
and backward (kernels and products in bf16; the outputs bf16).  The
reference applies it on its fused path and its executor-group path;
the port has the executor-group path only (the reference's
``MXNET_MODULE_FUSED=0``).
"""
from __future__ import annotations

import logging
import os

import torch

from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError, atomic_write
from ..context import cpu, default_device
from ..initializer import InitDesc, Uniform
from ..io.io import DataDesc
from ..model import (join_params, latest_checkpoint, load_checkpoint,
                     split_params)
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


def _as_data_desc(x):
    if hasattr(x, "name"):
        return x
    if isinstance(x, (list, tuple)) and len(x) == 2:
        return DataDesc(x[0], x[1])
    raise MXNetError("cannot interpret %r as DataDesc" % (x,))


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, fixed_param_names=None, compute_dtype=None,
                 state_names=None):
        super().__init__(logger=logger)
        self._compute_dtype = compute_dtype
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
        self._state_names = list(state_names or [])
        for kind, names in (("data", self._data_names),
                            ("state", self._state_names)):
            for name in names:
                if name not in arg_names:
                    raise ValueError("%s name %r is not an argument of the "
                                     "symbol" % (kind, name))
        input_names = self._data_names + self._label_names + \
            self._state_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._fixed_param_names = list(fixed_param_names or [])
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._updater = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        self._preload_opt_states = None

    # -- checkpointing -----------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a checkpoint's symbol, with its parameters;
        ``bind`` it before use.  With ``load_optimizer_states`` the
        checkpoint's ``.states`` file is restored by ``init_optimizer``;
        a checkpoint saved without one is refused here."""
        states = "%s-%04d.states" % (prefix, epoch)
        if load_optimizer_states and not os.path.exists(states):
            raise MXNetError(
                "checkpoint epoch %d under %r has no optimizer states (%s "
                "missing); load with load_optimizer_states=False, or save "
                "with save_optimizer_states=True" % (epoch, prefix, states))
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = states
        return mod

    @staticmethod
    def load_latest(prefix, load_optimizer_states=False, **kwargs):
        """``(module, epoch)`` of the newest checkpoint under ``prefix``,
        or None when there is none yet (train from epoch 0 then)."""
        epoch = latest_checkpoint(prefix)
        if epoch is None:
            return None
        return Module.load(prefix, epoch, load_optimizer_states,
                           **kwargs), epoch

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Write ``prefix-symbol.json`` and ``prefix-NNNN.params``, and
        ``prefix-NNNN.states`` when asked."""
        self._symbol.save("%s-symbol.json" % prefix)
        self.save_params("%s-%04d.params" % (prefix, epoch))
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    def save_params(self, fname):
        """Parameters under the ``arg:``/``aux:`` key convention."""
        nd.save(fname, join_params(*self.get_params()))

    def load_params(self, fname):
        """Set the parameters from a file written by ``save_params`` (of
        either package)."""
        self.set_params(*split_params(nd.load(fname), fname))

    def save_optimizer_states(self, fname):
        """Write the optimizer's state and update counters (the pickled
        v2 envelope, numpy arrays only) atomically to ``fname``."""
        assert self.optimizer_initialized
        with atomic_write(fname, "wb") as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Restore what ``save_optimizer_states`` (of either package)
        wrote."""
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

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
    def state_names(self):
        return self._state_names

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
            group = self._exec_group
            self._arg_params = {
                n: nd.array(a._data, ctx=cpu()) for n, a in
                zip(self._param_names, group.param_arrays)}
            self._aux_params = {
                n: nd.array(a._data, ctx=cpu()) for n, a in
                zip(group.aux_names, group.aux_arrays)}
            self._params_dirty = False
        return self._arg_params, self._aux_params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        """Parameters and auxiliary states from ``arg_params`` /
        ``aux_params`` (NDArrays or numpy arrays) where given, else
        drawn by ``initializer`` (which sets ``moving_var`` to 1 and
        ``moving_mean`` to 0 by their names)."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None and (arg_params is None or not force_init):
            initializer = Uniform(0.01)
        group = self._exec_group
        if self._arg_params is None:
            self._arg_params = {
                n: nd.zeros(a.shape, cpu(), dtype=str(a.dtype)) for n, a in
                zip(self._param_names, group.param_arrays)}
        if self._aux_params is None:
            self._aux_params = {
                n: nd.zeros(a.shape, cpu(), dtype=str(a.dtype)) for n, a in
                zip(group.aux_names, group.aux_arrays)}
        attrs = self._symbol.attr_dict()
        for name, arr in self._arg_params.items():
            if arg_params is not None and name in arg_params:
                arr[:] = arg_params[name]
            elif not allow_missing and arg_params is not None and \
                    initializer is None:
                raise MXNetError("%s is not presented" % name)
            elif initializer is not None:
                initializer(InitDesc(name, attrs.get(name)), arr)
        for name, arr in self._aux_params.items():
            if aux_params is not None and name in aux_params:
                arr[:] = aux_params[name]
            elif initializer is not None:
                initializer(InitDesc(name, attrs.get(name)), arr)
        self.params_initialized = True
        self._params_dirty = False
        group.set_params(self._arg_params, self._aux_params)

    # -- binding -----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the executor group; with ``shared_module`` (bound, its
        parameters initialized) over that module's parameter, gradient
        and auxiliary arrays, whose values this module then has."""
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
        shared_group = None
        if shared_module is not None:
            assert shared_module.binded and \
                shared_module.params_initialized
            shared_group = shared_module._exec_group
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._data_shapes,
            self._label_shapes, self._param_names, for_training,
            inputs_need_grad, self._fixed_param_names, grad_req,
            self._compute_dtype, shared_group, self._state_names)
        self.binded = True
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self._params_dirty = True
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind to new input shapes, keeping the parameters, their
        gradients, the auxiliary states and the optimizer's state."""
        assert self.binded
        self._data_shapes = [_as_data_desc(x) for x in data_shapes]
        self._label_shapes = [_as_data_desc(x) for x in label_shapes or []
                              if _as_data_desc(x).name in self._label_names]
        self._exec_group.reshape(self._data_shapes, self._label_shapes)
        self._params_dirty = True

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
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Step with ``shared_module``'s optimizer and updater (one state
        for both, keyed by parameter index: the parameters must be the
        same names in the same order)."""
        assert shared_module.optimizer_initialized
        if shared_module._param_names != self._param_names:
            raise MXNetError("borrow_optimizer: the modules' parameters "
                             "differ (%s vs %s); the updater's state is "
                             "keyed by their index" % (
                                 self._param_names,
                                 shared_module._param_names))
        self._optimizer = shared_module._optimizer
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    # -- computation -------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        """A train forward updates the auxiliary states on the device."""
        assert self.binded and self.params_initialized
        if is_train or (is_train is None and self.for_training):
            self._params_dirty = True
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

    def get_input_grads(self, merge_multi_context=True):
        """The data inputs' gradients of the last ``backward``, in
        ``data_names`` order (bind with ``inputs_need_grad=True``)."""
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads()

    def get_states(self, merge_multi_context=True):
        """The ``state_names`` arrays."""
        assert self.binded and self.params_initialized
        return self._exec_group.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        """Set the ``state_names`` arrays from ``states`` or the scalar
        ``value``."""
        assert self.binded and self.params_initialized
        self._exec_group.set_states(states, value)

    def install_monitor(self, mon):
        """Report this module's executor to ``mon`` (a ``Monitor``)."""
        assert self.binded
        self._exec_group.install_monitor(mon)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    @property
    def device(self):
        return torch.device(self._context)
