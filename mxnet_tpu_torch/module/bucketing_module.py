"""BucketingModule: one symbol a bucket key, trained as one model
(counterpart of ``mxnet_tpu/module/bucketing_module.py``).

``sym_gen(bucket_key)`` gives ``(symbol, data_names, label_names)``; the
default bucket's :class:`Module` is bound by ``bind``, and each other
bucket's on the first batch that carries its key (``switch_bucket``),
with ``shared_module`` set to the default bucket's: every bucket's
executor holds the same parameter, gradient and auxiliary tensors, so
an update through one bucket is what the next reads and nothing is
copied on a switch.  The optimizer and its updater are the default
bucket's, borrowed by every other bucket (``Module.borrow_optimizer``):
one optimizer state keyed by parameter index, as in the reference.

On the fused route (``MXNET_MODULE_FUSED``, the default) the default
bucket's ``init_optimizer`` builds a trainer, and every other bucket
adopts it (``Module._adopt_fused_from``): a trainer a bucket, each with
its own step program, over one set of parameters, optimizer state and
moving statistics (``share_state_with``).  A bucket first seen while
the pool is fused joins it when it is switched to.  A bucket that
cannot share the trainer, a monitor, or an explicit
``forward``/``backward`` on any bucket takes the whole group off the
fused route (``_handle_defuse``): the state goes to the shared executor
arrays and one host updater, and the group goes on there, on the shared
bind and ``borrow_optimizer`` described above.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._monitor = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    # -- properties --------------------------------------------------------
    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    # -- params ------------------------------------------------------------
    def get_params(self):
        """The shared parameters and auxiliary states, as host
        NDArrays, read afresh through the current bucket's module: its
        own cached copy may predate another bucket's updates."""
        assert self.binded and self.params_initialized
        self._curr_module._params_dirty = True
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init)
        self._params_dirty = False
        self.params_initialized = True

    # -- binding -----------------------------------------------------------
    def _module(self, bucket_key):
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        module = Module(symbol, data_names, label_names, logger=self.logger,
                        context=self._context,
                        fixed_param_names=self._fixed_param_names,
                        state_names=self._state_names)
        module._on_defuse = self._handle_defuse
        return module

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket's module to ``data_shapes`` (the
        iterator's ``provide_data``: its default bucket's)."""
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        module = self._module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module current, binding it over the
        default bucket's tensors when the key is new."""
        assert self.binded, "call bind before switching bucket"
        default = self._buckets[self._default_bucket_key]
        if bucket_key not in self._buckets:
            module = self._module(bucket_key)
            module.bind(data_shapes, label_shapes,
                        self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False, shared_module=default)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            self._buckets[bucket_key] = module
        module = self._buckets[bucket_key]
        if module is not default and not module.optimizer_initialized \
                and default.optimizer_initialized:
            self._join(module, default)
        self._curr_module = module
        self._curr_bucket_key = bucket_key

    @staticmethod
    def _join(module, default):
        """Give a bucket the default bucket's optimizer: its trainer's
        pool on the fused route, else its updater.  A bucket that cannot
        share the trainer gets the trainer's current parameters in its
        (shared) executor arrays and stays out until its ``update``
        takes the group off the fused route."""
        if default._fused is None:
            module.borrow_optimizer(default)
        elif not module._adopt_fused_from(default):
            default._sync_params_from_devices()
            module._exec_group.set_params(default._arg_params,
                                          default._aux_params)

    def prepare(self, data_batch):
        """Bind the batch's bucket before its forward."""
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The default bucket's optimizer, which every bucket borrows."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        default = self._buckets[self._default_bucket_key]
        default.init_optimizer(kvstore, optimizer, optimizer_params,
                               force_init=force_init)
        for mod in self._buckets.values():
            if mod is not default:
                self._join(mod, default)
        self.optimizer_initialized = True

    # -- computation -------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self.prepare(data_batch)
        self._curr_module.forward(data_batch, is_train=is_train)

    def forward_backward(self, data_batch):
        assert self.binded and self.params_initialized
        self.prepare(data_batch)
        self._curr_module.forward_backward(data_batch)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        """The current bucket's update; a bucket outside the default's
        fused pool first takes the whole group off the fused route."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        module = self._curr_module
        if not module.optimizer_initialized:
            default = self._buckets[self._default_bucket_key]
            if default._fused is not None:
                default._defuse("bucket %r cannot share the fused trainer"
                                % (self._curr_bucket_key,))
            module.borrow_optimizer(default)
        module.update()

    def _handle_defuse(self, source):
        """One bucket left the fused pool: every bucket leaves with it,
        onto ``source``'s host updater (``source`` has written the
        shared state to the executor arrays every bucket holds)."""
        for mod in self._buckets.values():
            if mod is source or mod._fused is None:
                continue
            mod._fused = None
            mod._fused_disabled = True
            mod._fused_stash = None
            mod._fused_batch = mod._fused_outputs = None
            mod._optimizer = source._optimizer
            mod._updater = source._updater
            mod.optimizer_initialized = source.optimizer_initialized

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context)

    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        self._curr_module.set_states(states, value)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        """Report every bucket's executor, and each later bucket's when
        it is bound, to ``mon``."""
        assert self.binded
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)
