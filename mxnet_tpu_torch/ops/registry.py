"""Operator registry of the port (counterpart of
``mxnet_tpu/ops/registry.py``).

Every operator is one :class:`OpDef`: a forward function
``fcompute(attrs, *tensors)`` on ``torch.Tensor``s, its argument names,
typed attributes parsed from Python values or the strings a symbol's
JSON holds, and shape inference for ``simple_bind``.  An op with
auxiliary states or train-mode behaviour (BatchNorm, Dropout, rrelu)
has ``fstateful(attrs, inputs, aux, is_train, generator) -> (outputs,
new_aux)`` in its place and names its states in ``aux_states``
(``moving_mean``, ``moving_var``): they come after the arguments among
a node's inputs, take no gradient, and their shapes come from
``infer_shape``.  ``needs_rng`` marks an op that draws random numbers:
the sampling ops get a ``generator=`` keyword in ``fcompute``, a
stateful op its ``generator`` argument (a ``torch.Generator`` on the
device the op runs on, :func:`mxnet_tpu_torch.random.generator`);
``rng_at_eval`` says whether it also draws outside training (the
samplers do, Dropout does not).  :meth:`OpDef.apply` is the one entry
both the executor and ``imperative_invoke`` call.  Gradients are not
registered: the executor differentiates ``fcompute`` with
``torch.autograd``, and ops whose backward is not the derivative of
their forward (SoftmaxOutput) or runs a kernel (the norms, attention)
wrap an ``autograd.Function``.  ``key_var_num_args`` names the
attribute that counts a variadic op's inputs (``Concat``'s
``num_args``); ``outputs`` and ``num_outputs`` may be functions of the
attributes (``SliceChannel``, ``topk(ret_typ='both')``); ``infer_type``
gives the result dtypes where they are not the inputs'.  An op may
compute more outputs than it shows (``num_outputs``): ``mutate`` pairs
``(out_idx, arg_idx)`` name
the extra outputs the imperative plane writes back into state inputs
(the optimizer updates' momentum and moments, the reference's
FMutateInputs).  ``index_inputs`` names the arguments an op reads as
integer indices (``Embedding``'s ``data``): a graph argument read only
there keeps its master dtype under a module's ``compute_dtype``.  The
attribute parsing, naming and inference rules are copied from the
reference, which keeps them free of JAX.
"""
from __future__ import annotations

import ast

import numpy as np

from ..base import MXNetError

__all__ = ["OpDef", "register", "register_alias", "get_op", "list_ops",
           "AttrSpec", "Int", "Float", "Bool", "Str", "Shape", "Dtype",
           "IntOrNone", "FloatTuple", "unify_shapes", "elemwise_shape_infer",
           "elemwise_type_infer"]

_OP_REGISTRY: dict = {}


# ---------------------------------------------------------------------------
# Typed attribute parsing (the reference's dmlc-parameter equivalent)
# ---------------------------------------------------------------------------
def _parse_bool(v):
    if isinstance(v, str):
        return v.lower() in ("1", "true", "yes", "on")
    return bool(v)


def _parse_shape(v):
    if v is None:
        return None
    if isinstance(v, str):
        v = ast.literal_eval(v)
    if isinstance(v, (int, np.integer)):
        return (int(v),)
    return tuple(int(x) for x in v)


def _parse_int_or_none(v):
    if v is None or v == "None":
        return None
    return int(v)


def _parse_float_tuple(v):
    if v is None:
        return None
    if isinstance(v, str):
        v = ast.literal_eval(v)
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


def _parse_dtype(v):
    """A dtype's name.  ``'bfloat16'`` (or ``NDArray.dtype`` of a bf16
    array) passes as it is: numpy names it only where ``ml_dtypes`` is
    imported."""
    if v is None or v == "None":
        return None
    if v == "bfloat16":
        return "bfloat16"
    return np.dtype(v).name


class AttrSpec:
    __slots__ = ("parse", "default", "required")

    def __init__(self, parse, default, required):
        self.parse = parse
        self.default = default
        self.required = required


def Int(default=None, required=False):
    return AttrSpec(int, default, required)


def Float(default=None, required=False):
    return AttrSpec(float, default, required)


def Bool(default=False, required=False):
    return AttrSpec(_parse_bool, default, required)


def Str(default=None, required=False):
    return AttrSpec(str, default, required)


def Shape(default=None, required=False):
    return AttrSpec(_parse_shape, default, required)


def Dtype(default=None, required=False):
    return AttrSpec(_parse_dtype, default, required)


def IntOrNone(default=None):
    return AttrSpec(_parse_int_or_none, default, False)


def FloatTuple(default=None, required=False):
    return AttrSpec(_parse_float_tuple, default, required)


# ---------------------------------------------------------------------------
# OpDef
# ---------------------------------------------------------------------------
class OpDef:
    """A registered operator."""

    def __init__(self, name, fcompute=None, fstateful=None, attrs=None,
                 arguments=("data",), outputs=("output",), aux_states=(),
                 infer_shape=None, infer_type=None,
                 infer_shape_backward=None, num_outputs=1,
                 key_var_num_args=None, needs_rng=False, rng_at_eval=None,
                 mutate=(), index_inputs=(), doc=""):
        self.name = name
        self.fcompute = fcompute
        self.fstateful = fstateful
        self.attr_specs = dict(attrs or {})
        self._arguments = arguments
        self._outputs = outputs
        self._aux_states = aux_states
        self._infer_shape = infer_shape
        self._infer_type = infer_type
        self._infer_shape_backward = infer_shape_backward
        self._num_outputs = num_outputs
        # the attribute holding a variadic op's input count (Concat:
        # num_args); its arguments are then <first name>0, 1, ...
        self.key_var_num_args = key_var_num_args
        self.needs_rng = needs_rng
        # draws at inference too (the samplers); Dropout does not
        self.rng_at_eval = needs_rng if rng_at_eval is None else rng_at_eval
        # ((out_idx, arg_idx), ...): outputs written back into inputs
        self.mutate = tuple(mutate)
        # argument names read as integer indices, never cast
        self.index_inputs = frozenset(index_inputs)
        self.doc = doc

    def parse_attrs(self, raw):
        """Parse raw kwargs (Python values or strings) into a typed
        dict; keys starting with ``__`` are symbol annotations and pass
        by."""
        out = {}
        for k, spec in self.attr_specs.items():
            if k in raw:
                v = raw[k]
                out[k] = spec.parse(v) if v is not None else None
            elif spec.required:
                raise MXNetError("op %s: required attribute %r missing"
                                 % (self.name, k))
            else:
                out[k] = spec.default
        unknown = {k for k in set(raw) - set(self.attr_specs)
                   if not k.startswith("__")}
        if unknown:
            raise MXNetError("op %s: unknown attributes %s"
                             % (self.name, sorted(unknown)))
        return out

    def serialize_attrs(self, attrs):
        """Typed attrs -> the string dict of the JSON graph format."""
        out = {}
        for k, v in attrs.items():
            if v is None:
                continue
            if isinstance(v, bool):
                out[k] = "True" if v else "False"
            else:
                out[k] = str(v)
        return out

    def arguments(self, attrs):
        args = self._arguments
        if callable(args):
            return list(args(attrs))
        if self.key_var_num_args is not None:
            base = args[0] if args else "arg"
            return ["%s%d" % (base, i)
                    for i in range(int(attrs[self.key_var_num_args]))]
        return list(args)

    def outputs(self, attrs):
        outs = self._outputs
        return list(outs(attrs)) if callable(outs) else list(outs)

    def num_outputs(self, attrs):
        n = self._num_outputs
        return int(n(attrs)) if callable(n) else int(n)

    def aux_states(self, attrs):
        aux = self._aux_states
        return list(aux(attrs)) if callable(aux) else list(aux)

    def infer_shape(self, attrs, in_shapes):
        """``(in_shapes, out_shapes, aux_shapes)``; entries may stay None
        when underdetermined."""
        if self._infer_shape is None:
            return elemwise_shape_infer(self, attrs, in_shapes)
        ins, outs, aux = self._infer_shape(attrs, list(in_shapes))
        return list(ins), list(outs), list(aux)

    def infer_type(self, attrs, in_types):
        """``(in_types, out_types, aux_types)`` as dtype names; by
        default every output and auxiliary state takes the first known
        input's dtype."""
        if self._infer_type is None:
            return elemwise_type_infer(self, attrs, in_types)
        ins, outs, aux = self._infer_type(attrs, list(in_types))
        return list(ins), list(outs), list(aux)

    def apply(self, attrs, inputs, aux=(), is_train=False, generator=None):
        """Run the op: ``(outputs, new_aux)``, both tuples (``new_aux``
        empty for an op without auxiliary states)."""
        if self.fstateful is not None:
            outs, new_aux = self.fstateful(attrs, tuple(inputs), tuple(aux),
                                           is_train, generator)
            return _as_tuple(outs), _as_tuple(new_aux)
        if self.needs_rng:
            return _as_tuple(self.fcompute(attrs, *inputs,
                                           generator=generator)), ()
        return _as_tuple(self.fcompute(attrs, *inputs)), ()

    def infer_shape_backward(self, attrs, out_shapes, in_shapes):
        """Known output shapes back into inputs: elementwise ops unify
        every input with the output, others keep what they have."""
        if self._infer_shape_backward is not None:
            return self._infer_shape_backward(attrs, list(out_shapes),
                                              list(in_shapes))
        if self._infer_shape is None:
            known = None
            for s in list(out_shapes) + list(in_shapes):
                if s is not None:
                    known = unify_shapes(known, s)
            return [known] * len(in_shapes)
        return list(in_shapes)

    def __repr__(self):
        return "OpDef(%s)" % self.name


# ---------------------------------------------------------------------------
# Default inference helpers
# ---------------------------------------------------------------------------
def unify_shapes(a, b, where=""):
    """Merge two partially known shapes; a 0 dimension is a wildcard."""
    if a is None:
        return tuple(b) if b is not None else None
    if b is None:
        return tuple(a)
    if len(a) != len(b):
        raise MXNetError("incompatible shapes %s vs %s %s" % (a, b, where))
    out = []
    for da, db in zip(a, b):
        if da == 0:
            out.append(db)
        elif db == 0 or da == db:
            out.append(da)
        else:
            raise MXNetError("incompatible shapes %s vs %s %s"
                             % (a, b, where))
    return tuple(out)


def elemwise_shape_infer(op, attrs, in_shapes):
    """All inputs and outputs share one (broadcast-free) shape."""
    shape = None
    for s in in_shapes:
        shape = unify_shapes(shape, s, "(op %s)" % op.name)
    ins = [shape if s is None else unify_shapes(s, shape)
           for s in in_shapes]
    return ins, [shape] * op.num_outputs(attrs), []


def elemwise_type_infer(op, attrs, in_types):
    """Every input, output and auxiliary state takes the first known
    input's dtype."""
    known = [t for t in in_types if t is not None]
    t = known[0] if known else None
    return [t if x is None else x for x in in_types], \
        [t] * op.num_outputs(attrs), [t] * len(op.aux_states(attrs))


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


# ---------------------------------------------------------------------------
# Registration
# ---------------------------------------------------------------------------
def register(name, fcompute=None, **kwargs):
    """Register an op under ``name``."""
    if name in _OP_REGISTRY:
        raise MXNetError("op %s already registered" % name)
    op = OpDef(name, fcompute, **kwargs)
    _OP_REGISTRY[name] = op
    return op


def register_alias(name, alias):
    _OP_REGISTRY[alias] = _OP_REGISTRY[name]


def get_op(name):
    op = _OP_REGISTRY.get(name)
    if op is None:
        raise MXNetError("operator %r is not registered in the port"
                         % name)
    return op


def list_ops():
    return sorted(_OP_REGISTRY)
