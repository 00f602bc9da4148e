"""The executor group of a Module (counterpart of
``mxnet_tpu/module/executor_group.py``), for one device: it binds one
executor, loads batches into it, and exposes the parameter and gradient
arrays the optimizer updates.  Splitting a batch over several devices
is later work."""
from __future__ import annotations

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup:
    """One executor on ``context``.  ``grad_req`` applies to the
    parameters (``null`` for fixed ones, and for all when not training);
    data inputs get gradients only with ``inputs_need_grad``."""

    def __init__(self, symbol, context, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 fixed_param_names=(), grad_req="write"):
        self.symbol = symbol
        self.context = context
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes or []
        self.data_names = [d.name for d in data_shapes]
        self.label_names = [d.name for d in self.label_shapes]
        self.batch_size = data_shapes[0].shape[0]
        self.grad_req = {}
        for k in symbol.list_arguments():
            if k in param_names:
                self.grad_req[k] = ("null" if k in fixed_param_names or
                                    not for_training else grad_req)
            elif k in self.data_names:
                self.grad_req[k] = grad_req if inputs_need_grad else "null"
            else:
                self.grad_req[k] = "null"
        shapes = {d.name: tuple(d.shape)
                  for d in list(data_shapes) + self.label_shapes}
        self.executor = symbol.simple_bind(context, grad_req=self.grad_req,
                                           **shapes)
        args = self.executor.arg_dict
        self.param_arrays = [args[n] for n in param_names]

    @property
    def grad_arrays(self):
        """Gradient arrays in ``param_names`` order (None when a
        parameter takes none)."""
        grads = self.executor.grad_dict
        return [grads.get(n) for n in self.param_names]

    def set_params(self, arg_params):
        self.executor.copy_params_from(arg_params, allow_extra_params=True)

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

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.executor.outputs)
