"""The executor group of a Module (counterpart of
``mxnet_tpu/module/executor_group.py``), for one device: it binds one
executor, loads batches into it, and exposes the parameter and gradient
arrays the optimizer updates and the auxiliary states (BatchNorm's
moving statistics) that a train forward updates.  Splitting a batch
over several devices is later work.

``compute_dtype`` threads the module's mixed-precision policy into the
executor; the labels keep their master dtype, as in the reference, and
so do the arguments the graph reads only as indices
(:meth:`Symbol.list_index_arguments`: token ids into ``Embedding``),
where the reference rounds them to the compute dtype.

A group bound with a ``shared_group`` (a bucket of a
``BucketingModule``) holds the shared group's parameter, gradient and
auxiliary arrays themselves, not copies, wherever the shapes agree: an
update through one bucket is what the next bucket reads.  The batch size
is the data's size along the batch axis of its ``layout`` (``TN``
batches carry it on axis 1).  ``state_names`` are inputs the caller
carries from batch to batch (``get_states`` / ``set_states``).
"""
from __future__ import annotations

from ..io.io import DataDesc

__all__ = ["DataParallelExecutorGroup"]


def _batch_size(data_shapes):
    desc = data_shapes[0]
    return desc.shape[DataDesc.get_batch_axis(getattr(desc, "layout",
                                                      None))]


class DataParallelExecutorGroup:
    """One executor on ``context``.  ``grad_req`` applies to the
    parameters (``null`` for fixed ones, and for all when not training);
    data inputs get gradients only with ``inputs_need_grad``."""

    def __init__(self, symbol, context, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 fixed_param_names=(), grad_req="write", compute_dtype=None,
                 shared_group=None, state_names=()):
        self.symbol = symbol
        self.context = context
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes or []
        self.data_names = [d.name for d in data_shapes]
        self.label_names = [d.name for d in self.label_shapes]
        self.state_names = list(state_names or [])
        self.batch_size = _batch_size(data_shapes)
        self.grad_req = {}
        for k in symbol.list_arguments():
            if k in param_names:
                self.grad_req[k] = ("null" if k in fixed_param_names or
                                    not for_training else grad_req)
            elif k in self.data_names:
                self.grad_req[k] = grad_req if inputs_need_grad else "null"
            else:
                self.grad_req[k] = "null"
        self.executor = symbol.simple_bind(
            context, grad_req=self.grad_req, compute_dtype=compute_dtype,
            keep_dtype=self.label_names + symbol.list_index_arguments(),
            **self._shapes(data_shapes, self.label_shapes))
        self.aux_names = symbol.list_auxiliary_states()
        if shared_group is not None:
            self._share(shared_group.executor)
        self._arrays()

    def _share(self, src):
        """Take ``src``'s parameter, gradient and auxiliary arrays in
        place of this executor's own where the shapes agree."""
        ex = self.executor
        names = ex._arg_names
        sargs, sgrads = src.arg_dict, src.grad_dict
        for i, name in enumerate(names):
            if name not in self.param_names or name not in sargs or \
                    sargs[name].shape != ex.arg_arrays[i].shape:
                continue
            ex.arg_arrays[i] = sargs[name]
            if ex.grad_arrays[i] is not None and name in sgrads:
                ex.grad_arrays[i] = sgrads[name]
        saux = src.aux_dict
        for i, name in enumerate(ex._aux_names):
            if name in saux and saux[name].shape == ex.aux_arrays[i].shape:
                ex.aux_arrays[i] = saux[name]

    @staticmethod
    def _shapes(data_shapes, label_shapes):
        return {d.name: tuple(d.shape)
                for d in list(data_shapes) + list(label_shapes)}

    def _arrays(self):
        args = self.executor.arg_dict
        self.param_arrays = [args[n] for n in self.param_names]
        self.aux_arrays = self.executor.aux_arrays

    def reshape(self, data_shapes, label_shapes):
        """Rebind to new input shapes: the executor's arrays whose shapes
        stay (the parameters, their gradients, the auxiliary states) are
        shared, the others made anew."""
        label_shapes = list(label_shapes or [])
        if data_shapes == self.data_shapes and \
                label_shapes == self.label_shapes:
            return
        self.executor = self.executor.reshape(
            partial_shaping=True, **self._shapes(data_shapes, label_shapes))
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self.batch_size = _batch_size(data_shapes)
        self._arrays()

    @property
    def grad_arrays(self):
        """Gradient arrays in ``param_names`` order (None when a
        parameter takes none)."""
        grads = self.executor.grad_dict
        return [grads.get(n) for n in self.param_names]

    def set_params(self, arg_params, aux_params=None):
        self.executor.copy_params_from(arg_params, aux_params,
                                       allow_extra_params=True)

    def _load(self, names, arrays):
        args = self.executor.arg_dict
        for name, arr in zip(names, arrays or []):
            if name in args:
                args[name][:] = arr

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        self._load(self.data_names, data_batch.data)
        self._load(self.label_names, data_batch.label)
        self.executor.forward(is_train=is_train)

    def backward(self, out_grads=None):
        self.executor.backward(out_grads)

    def get_outputs(self):
        return self.executor.outputs

    def get_input_grads(self):
        """The data inputs' gradients, in ``data_names`` order."""
        assert self.inputs_need_grad
        grads = self.executor.grad_dict
        return [grads[n] for n in self.data_names]

    def get_states(self, merge_multi_context=True):
        """The ``state_names`` arrays, in that order."""
        args = self.executor.arg_dict
        return [args[name] for name in self.state_names]

    def set_states(self, states=None, value=None):
        """Set the ``state_names`` arrays from ``states`` (one value
        each) or fill them with the scalar ``value``."""
        args = self.executor.arg_dict
        if states is not None:
            assert value is None, "only one of states/value"
            for name, v in zip(self.state_names, states):
                args[name][:] = v
        else:
            assert value is not None, "one of states/value required"
            for name in self.state_names:
                args[name][:] = value

    def install_monitor(self, mon):
        mon.install(self.executor)

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.executor.outputs)
