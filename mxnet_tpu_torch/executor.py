"""Executor: a symbol bound to arrays on one device (counterpart of
``mxnet_tpu/executor.py``).

``forward`` evaluates the graph's ops in topological order on the bound
tensors.  A train-mode forward records the autograd graph from fresh
leaves over the arguments that take gradients; ``backward`` runs
``torch.autograd`` back to those leaves and writes (``grad_req='write'``)
or adds (``'add'``) into ``grad_dict``.  Without ``out_grads`` each
output gets a cotangent of ones, an expanded scalar that costs no
memory; a loss head (SoftmaxOutput) ignores it either way.  The residuals
of the train forward live in the autograd graph until ``backward``
frees them.  None of the reference's jit, segment or donation machinery
has a counterpart here: PyTorch runs eagerly.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["Executor"]


class Executor:
    def __init__(self, symbol, ctx, args, grads, reqs):
        self._symbol = symbol
        self._ctx = torch.device(ctx)
        self._arg_names = symbol.list_arguments()
        self._output_names = symbol.list_outputs()
        if len(args) != len(self._arg_names):
            raise MXNetError("bind: expected %d args, got %d"
                             % (len(self._arg_names), len(args)))
        self.arg_arrays = list(args)
        self.grad_req = dict(reqs)
        self.grad_arrays = [grads.get(n) for n in self._arg_names]
        self._diff_idx = [i for i, n in enumerate(self._arg_names)
                          if self.grad_req.get(n, "null") != "null"
                          and self.grad_arrays[i] is not None]
        self._nodes = symbol._nodes()
        arg_order = {n: i for i, n in enumerate(self._arg_names)}
        self._var_idx = {id(n): arg_order[n.name] for n in self._nodes
                         if n.is_variable}
        self._heads = [(id(n), oi) for n, oi in symbol._outputs]
        self.outputs = []
        self._train = None   # (outputs with autograd history, leaves)

    def _evaluate(self, arg_vals):
        vals = {}
        for node in self._nodes:
            if node.is_variable:
                vals[(id(node), 0)] = arg_vals[self._var_idx[id(node)]]
                continue
            ins = [vals[(id(n), oi)] for n, oi in node.inputs]
            out = node.op.fcompute(node.attrs, *ins)
            vals[(id(node), 0)] = out
        return [vals[k] for k in self._heads]

    def forward(self, is_train=False, **kwargs):
        """Evaluate the graph; ``kwargs`` copy new values into named
        arguments first.  Returns the output NDArrays."""
        for k, v in kwargs.items():
            if k not in self._arg_names:
                raise MXNetError("unknown argument %r in forward" % k)
            self.arg_arrays[self._arg_names.index(k)][:] = v
        arg_vals = [a._data for a in self.arg_arrays]
        self._train = None
        if is_train:
            leaves = {i: arg_vals[i].detach().requires_grad_(True)
                      for i in self._diff_idx}
            for i, t in leaves.items():
                arg_vals[i] = t
            with torch.enable_grad():
                outs = self._evaluate(arg_vals)
            self._train = (outs, leaves)
        else:
            with torch.no_grad():
                outs = self._evaluate(arg_vals)
        self.outputs = [NDArray(o.detach()) for o in outs]
        return self.outputs

    def backward(self, out_grads=None):
        """Gradients of the last train-mode forward into ``grad_dict``."""
        if self._train is None:
            raise MXNetError("backward called without a forward"
                             "(is_train=True) before it")
        outs, leaves = self._train
        self._train = None
        if out_grads is None:
            out_grads = [None] * len(outs)
        elif isinstance(out_grads, (NDArray, torch.Tensor)):
            out_grads = [out_grads]
        cots = []
        for o, g in zip(outs, out_grads):
            if g is None:
                cots.append(torch.ones((), dtype=o.dtype,
                                       device=o.device).expand(o.shape))
            else:
                g = g._data if isinstance(g, NDArray) else torch.as_tensor(g)
                cots.append(g.to(device=o.device, dtype=o.dtype))
        idx = list(leaves)
        grads = torch.autograd.grad(outs, [leaves[i] for i in idx], cots,
                                    allow_unused=True)
        for i, g in zip(idx, grads):
            gbuf = self.grad_arrays[i]
            if g is None:
                g = torch.zeros_like(gbuf._data)
            if self.grad_req[self._arg_names[i]] == "add":
                gbuf._data = gbuf._data + g
            else:
                gbuf._data = g
        return [self.grad_arrays[i] for i in self._diff_idx]

    @property
    def arg_dict(self):
        return dict(zip(self._arg_names, self.arg_arrays))

    @property
    def grad_dict(self):
        return {n: g for n, g in zip(self._arg_names, self.grad_arrays)
                if g is not None}

    @property
    def aux_dict(self):
        """Auxiliary states by name; no op of the port has any."""
        return {}

    def copy_params_from(self, arg_params, allow_extra_params=False):
        """Copy named values into the bound argument arrays."""
        for name, arr in arg_params.items():
            if name in self._arg_names:
                self.arg_arrays[self._arg_names.index(name)][:] = arr
            elif not allow_extra_params:
                raise MXNetError("Found name %r not in arguments" % name)
