"""Operator registry of the port (counterpart of
``mxnet_tpu/ops/registry.py``).

Every operator is one :class:`OpDef`: a forward function
``fcompute(attrs, *tensors)`` on ``torch.Tensor``s, its argument names,
typed attributes parsed from Python values or the strings a symbol's
JSON holds, and shape inference for ``simple_bind``.  Gradients are not
registered: the executor differentiates ``fcompute`` with
``torch.autograd``, and ops whose backward is not the derivative of
their forward (SoftmaxOutput) or runs a kernel (the norms, attention)
wrap an ``autograd.Function``.  The attribute parsing, naming and
inference rules are copied from the reference, which keeps them free of
JAX.
"""
from __future__ import annotations

import ast

import numpy as np

from ..base import MXNetError

__all__ = ["OpDef", "register", "register_alias", "get_op", "list_ops",
           "AttrSpec", "Int", "Float", "Bool", "Str", "Shape", "Dtype",
           "unify_shapes", "elemwise_shape_infer"]

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


def _parse_dtype(v):
    if v is None or v == "None":
        return None
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


# ---------------------------------------------------------------------------
# OpDef
# ---------------------------------------------------------------------------
class OpDef:
    """A registered operator."""

    def __init__(self, name, fcompute, attrs=None, arguments=("data",),
                 outputs=("output",), infer_shape=None,
                 infer_shape_backward=None, doc=""):
        self.name = name
        self.fcompute = fcompute
        self.attr_specs = dict(attrs or {})
        self._arguments = arguments
        self._outputs = outputs
        self._infer_shape = infer_shape
        self._infer_shape_backward = infer_shape_backward
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
        return list(args(attrs)) if callable(args) else list(args)

    def outputs(self, attrs):
        return list(self._outputs)

    def num_outputs(self, attrs):
        return len(self._outputs)

    def infer_shape(self, attrs, in_shapes):
        """``(in_shapes, out_shapes, aux_shapes)``; entries may stay None
        when underdetermined."""
        if self._infer_shape is None:
            return elemwise_shape_infer(self, attrs, in_shapes)
        ins, outs, aux = self._infer_shape(attrs, list(in_shapes))
        return list(ins), list(outs), list(aux)

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


# ---------------------------------------------------------------------------
# Registration
# ---------------------------------------------------------------------------
def register(name, fcompute, **kwargs):
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
