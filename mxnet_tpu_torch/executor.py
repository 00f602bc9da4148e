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

Auxiliary states (BatchNorm's moving statistics) are bound arrays of
their own (``aux_arrays``, ``aux_dict``) that take no gradient.  A
stateful node (``OpDef.fstateful``) gets its states after its
arguments, with whether the forward trains and the generator of the
executor's device (:func:`mxnet_tpu_torch.random.generator`), which the
sampling ops draw from too; the new values a train-mode forward
returns are copied into the aux arrays in place, outside autograd, once
the graph is evaluated.

``compute_dtype`` (``'bfloat16'``) runs the graph in mixed precision, as
the reference's does: the bound argument and gradient arrays stay in
their master dtype (fp32), each floating argument not named in
``keep_dtype`` is cast to the compute dtype on entry to every forward,
after the fp32 leaves are made, so the cast's backward hands fp32
gradients to ``grad_dict``; the outputs stay in the compute dtype.
Floating auxiliary states enter in the compute dtype too, and their
new values are cast back to the aux arrays' own dtype before the write
(the reference's ``_cast_aux`` / ``_uncast_aux``).

An init op whose ``shape`` holds a 0 (``begin_state``'s ``(0, H)``
zeros of an RNN cell) takes the shape that inference over the bound
arguments gives its output (:func:`shape_overrides`), and an init op
with no ``ctx`` makes its array on the executor's device.  With a
monitor callback (:meth:`set_monitor_callback`) each forward hands it
every node's outputs, named ``<node>_<output>``, in topological order;
without one the forward runs no monitoring code.
"""
from __future__ import annotations

import torch

from . import random as _random
from .base import MXNetError
from .context import default_device
from .ndarray import NDArray, _torch_dtype

__all__ = ["Executor", "shape_overrides"]


def shape_overrides(symbol, known_shapes, device=None):
    """``{id(node): attrs}`` for the init ops that need other attributes
    than they were built with: a 0 in ``shape`` replaced by the shape
    inferred from ``known_shapes`` (``{argument name: shape}``), and
    ``ctx`` set to ``device`` where it is None."""
    from .symbol import infer_node_shapes
    hints = None
    overrides = {}
    for node in symbol._nodes():
        if node.is_variable:
            continue
        attrs = node.attrs
        shape = attrs.get("shape")
        if shape is not None and 0 in shape and "ctx" in attrs:
            if hints is None:
                hints = infer_node_shapes(symbol, dict(known_shapes))
            hint = hints.get((id(node), 0))
            if hint is not None and 0 not in hint:
                attrs = dict(attrs, shape=tuple(hint))
        if device is not None and "ctx" in attrs and attrs["ctx"] is None:
            attrs = dict(attrs, ctx=device)
        if attrs is not node.attrs:
            overrides[id(node)] = attrs
    return overrides


class Executor:
    def __init__(self, symbol, ctx, args, grads, reqs, compute_dtype=None,
                 keep_dtype=(), aux=()):
        self._symbol = symbol
        self._ctx = default_device(ctx)
        self._compute_dtype = (_torch_dtype(compute_dtype)
                               if compute_dtype else None)
        self._keep_dtype = frozenset(keep_dtype)
        self._arg_names = symbol.list_arguments()
        self._output_names = symbol.list_outputs()
        if len(args) != len(self._arg_names):
            raise MXNetError("bind: expected %d args, got %d"
                             % (len(self._arg_names), len(args)))
        self.arg_arrays = list(args)
        self._aux_names = symbol.list_auxiliary_states()
        if len(aux) != len(self._aux_names):
            raise MXNetError("bind: expected %d auxiliary states, got %d"
                             % (len(self._aux_names), len(aux)))
        self.aux_arrays = list(aux)
        self.grad_req = dict(reqs)
        self.grad_arrays = [grads.get(n) for n in self._arg_names]
        self._diff_idx = [i for i, n in enumerate(self._arg_names)
                          if self.grad_req.get(n, "null") != "null"
                          and self.grad_arrays[i] is not None]
        self._nodes = symbol._nodes()
        # variable node -> its index in the arguments followed by the
        # auxiliary states
        order = {n: i for i, n in enumerate(self._arg_names +
                                            self._aux_names)}
        self._var_idx = {id(n): order[n.name] for n in self._nodes
                         if n.is_variable}
        self._heads = [(id(n), oi) for n, oi in symbol._outputs]
        self._attrs = shape_overrides(
            symbol, {n: a.shape for n, a in zip(self._arg_names,
                                                self.arg_arrays)},
            self._ctx)
        self.outputs = []
        self._train = None   # (outputs with autograd history, leaves)
        self._monitor_cb = None

    def _evaluate(self, var_vals, is_train, tap=None):
        """The heads' values, and the auxiliary states' new values (by
        index into ``aux_arrays``; the topologically last writer of a
        shared state wins) from the arguments followed by the auxiliary
        states.  ``tap(node, outs)`` sees each op node's outputs."""
        vals, new_aux = {}, {}
        nargs = len(self._arg_names)
        gen = None
        attrs = self._attrs
        for node in self._nodes:
            if node.is_variable:
                vals[(id(node), 0)] = var_vals[self._var_idx[id(node)]]
                continue
            ins = [vals[(id(n), oi)] for n, oi in node.inputs]
            op, na = node.op, node.num_args()
            if gen is None and op.needs_rng and (is_train or
                                                 op.rng_at_eval):
                gen = _random.generator(self._ctx)
            outs, upd = op.apply(attrs.get(id(node), node.attrs), ins[:na],
                                 ins[na:], is_train, gen)
            for (an, _), u in zip(node.aux_inputs(), upd):
                new_aux[self._var_idx[id(an)] - nargs] = u
            for oi, o in enumerate(outs):
                vals[(id(node), oi)] = o
            if tap is not None:
                tap(node, outs)
        return [vals[k] for k in self._heads], new_aux

    def set_monitor_callback(self, callback):
        """Call ``callback(name, NDArray)`` after each forward for every
        op node's outputs (``<node>_<output>``), in topological order."""
        self._monitor_cb = callback

    def _monitor_tap(self):
        """A ``tap`` that keeps each output under its monitor name, and
        the list it fills; (None, None) without a monitor."""
        if self._monitor_cb is None:
            return None, None
        records = []

        def tap(node, outs):
            for nm, o in zip(node.op.outputs(node.attrs), outs):
                records.append(("%s_%s" % (node.name, nm), o))
        return tap, records

    def _cast_aux(self, vals):
        cdt = self._compute_dtype
        if cdt is None:
            return vals
        return [v.to(cdt) if v.is_floating_point() else v for v in vals]

    def _write_aux(self, new_aux):
        """Copy a train forward's new auxiliary values into the aux
        arrays, in place and in each array's own dtype."""
        with torch.no_grad():
            for i, u in new_aux.items():
                buf = self.aux_arrays[i]._data
                if u is not buf:
                    buf.copy_(u.detach())

    def _cast_args(self, vals):
        """The compute dtype's view of the arguments: every floating one
        not in ``keep_dtype`` cast (differentiably) to ``compute_dtype``."""
        cdt = self._compute_dtype
        if cdt is None:
            return vals
        return [v.to(cdt) if v.is_floating_point() and v.dtype != cdt and
                name not in self._keep_dtype else v
                for name, v in zip(self._arg_names, vals)]

    def forward(self, is_train=False, **kwargs):
        """Evaluate the graph; ``kwargs`` copy new values into named
        arguments first.  Returns the output NDArrays."""
        for k, v in kwargs.items():
            if k not in self._arg_names:
                raise MXNetError("unknown argument %r in forward" % k)
            self.arg_arrays[self._arg_names.index(k)][:] = v
        arg_vals = [a._data for a in self.arg_arrays]
        aux_vals = self._cast_aux([a._data for a in self.aux_arrays])
        self._train = None
        tap, records = self._monitor_tap()
        if is_train:
            leaves = {i: arg_vals[i].detach().requires_grad_(True)
                      for i in self._diff_idx}
            for i, t in leaves.items():
                arg_vals[i] = t
            with torch.enable_grad():
                outs, new_aux = self._evaluate(
                    self._cast_args(arg_vals) + aux_vals, True, tap)
            self._train = (outs, leaves)
            self._write_aux(new_aux)
        else:
            with torch.no_grad():
                outs, _ = self._evaluate(
                    self._cast_args(arg_vals) + aux_vals, False, tap)
        self.outputs = [NDArray(o.detach()) for o in outs]
        for nm, o in records or ():
            self._monitor_cb(nm, NDArray(o.detach()))
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
        # an output that depends on no argument with a gradient (a
        # comparison, an index, a data variable among get_internals'
        # outputs) sends nothing back
        pairs = [(o, g) for o, g in zip(outs, out_grads) if o.requires_grad]
        outs = [o for o, _ in pairs]
        cots = []
        for o, g in pairs:
            if g is None:
                cots.append(torch.ones((), dtype=o.dtype,
                                       device=o.device).expand(o.shape))
            else:
                g = g._data if isinstance(g, NDArray) else torch.as_tensor(g)
                cots.append(g.to(device=o.device, dtype=o.dtype))
        idx = list(leaves)
        grads = torch.autograd.grad(outs, [leaves[i] for i in idx], cots,
                                    allow_unused=True) if outs else \
            [None] * len(idx)
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
        """Auxiliary states by name."""
        return dict(zip(self._aux_names, self.aux_arrays))

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor at the input shapes ``kwargs``: arguments,
        gradients and auxiliary states whose shapes stay are shared with
        this one, the others are zeros.  An argument not named in
        ``kwargs`` may change shape only with ``partial_shaping``.
        ``allow_up_sizing`` is MXNet's, and has nothing to allow here:
        no memory pool is shared, so any size is allocated anew."""
        from . import ndarray as nd
        arg_shapes, _, aux_shapes = self._symbol.infer_shape_partial(
            **kwargs)

        def _same_or_new(cur, shape, name=None):
            if shape is None or tuple(shape) == cur.shape:
                return cur
            if name is not None and not (partial_shaping or name in kwargs):
                raise MXNetError("argument %s changes shape without "
                                 "partial_shaping" % name)
            return nd.zeros(shape, self._ctx, dtype=str(cur.dtype))

        args, grads = [], {}
        for name, cur, g, shape in zip(self._arg_names, self.arg_arrays,
                                       self.grad_arrays, arg_shapes):
            args.append(_same_or_new(cur, shape, name))
            if g is not None:
                grads[name] = _same_or_new(g, shape)
        aux = [_same_or_new(cur, shape)
               for cur, shape in zip(self.aux_arrays, aux_shapes)]
        return Executor(self._symbol, self._ctx, args, grads, self.grad_req,
                        self._compute_dtype, self._keep_dtype, aux)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy named values into the bound argument and auxiliary
        arrays."""
        for params, names, arrays in ((arg_params, self._arg_names,
                                       self.arg_arrays),
                                      (aux_params or {}, self._aux_names,
                                       self.aux_arrays)):
            for name, arr in params.items():
                if name in names:
                    arrays[names.index(name)][:] = arr
                elif not allow_extra_params:
                    raise MXNetError("Found name %r not in %s" % (
                        name, "arguments" if names is self._arg_names
                        else "auxiliary states"))
