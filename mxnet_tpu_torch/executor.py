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
(the reference's ``_cast_aux`` / ``_uncast_aux``).  The walk over the
nodes and this cast rule are :func:`evaluate`, which the data-parallel
trainer's step program (``parallel/spmd.py``) runs too.

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

__all__ = ["Executor", "evaluate", "ones_cotangent", "shape_overrides",
           "write_aux"]


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


def evaluate(nodes, heads, attrs, values, is_train, device, rng=None,
             compute_dtype=None, keep_dtype=frozenset(), tap=None):
    """Evaluate a symbol's nodes (``symbol._nodes()``) in topological
    order.

    ``values`` maps each variable's name (arguments and auxiliary
    states) to its tensor.  Under ``compute_dtype`` every floating one
    not named in ``keep_dtype`` enters cast to it, differentiably, so
    the cast's backward hands gradients back in the master dtype.
    ``attrs`` is :func:`shape_overrides`' map.  Ops that draw take
    ``rng``, or else the generator of ``device``
    (:func:`mxnet_tpu_torch.random.generator`).  ``tap(node, outs)``
    sees each op node's outputs.  Returns the values of ``heads``
    (``(id(node), output index)``) and ``{aux name: new value}``; the
    topologically last writer of a shared state wins."""
    vals, new_aux = {}, {}
    gen = rng
    for node in nodes:
        if node.is_variable:
            v = values[node.name]
            # a QuantizedWeight (int8 serving) passes through untouched
            if compute_dtype is not None and \
                    isinstance(v, torch.Tensor) and v.is_floating_point() \
                    and v.dtype != compute_dtype \
                    and node.name not in keep_dtype:
                v = v.to(compute_dtype)
            vals[(id(node), 0)] = v
            continue
        ins = [vals[(id(n), oi)] for n, oi in node.inputs]
        op, na = node.op, node.num_args()
        # Dropout draws in training only, the samplers always
        if gen is None and op.needs_rng and (is_train or op.rng_at_eval):
            gen = _random.generator(device)
        outs, upd = op.apply(attrs.get(id(node), node.attrs), ins[:na],
                             ins[na:], is_train, gen)
        for (an, _), u in zip(node.aux_inputs(), upd):
            new_aux[an.name] = u
        for oi, o in enumerate(outs):
            vals[(id(node), oi)] = o
        if tap is not None:
            tap(node, outs)
    return [vals[k] for k in heads], new_aux


def write_aux(bufs, new_aux):
    """Copy a train forward's new auxiliary values into the tensors
    ``bufs`` (``{aux name: tensor}``), in place, outside autograd and in
    each tensor's own dtype."""
    with torch.no_grad():
        for name, u in new_aux.items():
            buf = bufs[name]
            if u is not buf:
                buf.copy_(u.detach())


def ones_cotangent(out):
    """A cotangent of ones for ``out``: an expanded scalar, which costs
    no memory."""
    return torch.ones((), dtype=out.dtype, device=out.device).expand(
        out.shape)


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
        self._heads = [(id(n), oi) for n, oi in symbol._outputs]
        self._attrs = shape_overrides(
            symbol, {n: a.shape for n, a in zip(self._arg_names,
                                                self.arg_arrays)},
            self._ctx)
        self.outputs = []
        self._train = None   # (outputs with autograd history, leaves)
        self._monitor_cb = None

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

    def forward(self, is_train=False, **kwargs):
        """Evaluate the graph; ``kwargs`` copy new values into named
        arguments first.  Returns the output NDArrays."""
        for k, v in kwargs.items():
            if k not in self._arg_names:
                raise MXNetError("unknown argument %r in forward" % k)
            self.arg_arrays[self._arg_names.index(k)][:] = v
        arg_vals = [a._data for a in self.arg_arrays]
        aux_bufs = {n: a._data for n, a in zip(self._aux_names,
                                               self.aux_arrays)}
        self._train = None
        tap, records = self._monitor_tap()
        if is_train:
            leaves = {i: arg_vals[i].detach().requires_grad_(True)
                      for i in self._diff_idx}
            for i, t in leaves.items():
                arg_vals[i] = t
        values = dict(zip(self._arg_names, arg_vals))
        values.update(aux_bufs)
        with torch.set_grad_enabled(is_train):
            outs, new_aux = evaluate(
                self._nodes, self._heads, self._attrs, values, is_train,
                self._ctx, compute_dtype=self._compute_dtype,
                keep_dtype=self._keep_dtype, tap=tap)
        if is_train:
            self._train = (outs, leaves)
            write_aux(aux_bufs, new_aux)
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
                cots.append(ones_cotangent(o))
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
