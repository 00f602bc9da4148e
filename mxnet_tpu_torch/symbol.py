"""Symbol: the symbolic graph frontend of the port (counterpart of
``mxnet_tpu/symbol.py``).

A graph is a Python DAG of :class:`_Node` objects, each an op of
:mod:`.ops.registry` with typed attributes, or a variable.  Composition,
auto-naming (``fullyconnected0``, ...), ``list_arguments`` /
``list_outputs`` / ``list_auxiliary_states``, ``infer_shape``,
``attr_dict`` and the JSON format are the reference's, so a graph
written by ``mxnet_tpu``'s ``Symbol.tojson`` loads here and the reverse.
``bind`` / ``simple_bind`` return an :class:`~.executor.Executor`.
"""
from __future__ import annotations

import ast
import json
import sys
import threading

import numpy as np

from . import ops as _ops  # noqa: F401  (registers every op)
from .base import MXNetError
from .ops.registry import get_op, list_ops, unify_shapes

__all__ = ["Symbol", "Variable", "load", "load_json", "NameManager"]


class NameManager:
    """Automatic node names: one counter per op type, per thread."""

    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return "%s%d" % (hint, n)

    def __enter__(self):
        self._old_manager = getattr(NameManager._current, "value", None)
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._current.value = self._old_manager

    @staticmethod
    def current():
        cur = getattr(NameManager._current, "value", None)
        if cur is None:
            cur = NameManager._current.value = NameManager()
        return cur


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "extra_attrs")

    def __init__(self, op, name, attrs, inputs, extra_attrs=None):
        self.op = op            # OpDef, or None for a variable
        self.name = name
        self.attrs = attrs      # typed dict (parsed)
        self.inputs = inputs    # list of (node, out_idx)
        self.extra_attrs = dict(extra_attrs or {})  # __shape__, __lr_mult__

    @property
    def is_variable(self):
        return self.op is None


def _topo_sort(head_nodes):
    """Post-order DFS over the DAG (stable, iterative)."""
    order, seen = [], set()
    stack = [(n, False) for n in reversed(head_nodes)]
    while stack:
        node, expanded = stack.pop()
        if id(node) in seen:
            continue
        if expanded:
            seen.add(id(node))
            order.append(node)
        else:
            stack.append((node, True))
            for inp, _ in reversed(node.inputs):
                if id(inp) not in seen:
                    stack.append((inp, False))
    return order


class Symbol:
    """An output list over the graph: a list of (node, out_idx)."""

    __slots__ = ("_outputs",)

    def __init__(self, outputs):
        self._outputs = list(outputs)

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __len__(self):
        return len(self._outputs)

    def _nodes(self):
        return _topo_sort([n for n, _ in self._outputs])

    def list_arguments(self):
        """Input arguments (data variables and parameters), in
        topological order."""
        return [n.name for n in self._nodes() if n.is_variable]

    def list_outputs(self):
        """Output names (``<node>_<output>``)."""
        names = []
        for node, oi in self._outputs:
            if node.is_variable:
                names.append(node.name)
            else:
                names.append("%s_%s" % (node.name,
                                        node.op.outputs(node.attrs)[oi]))
        return names

    def list_auxiliary_states(self):
        """Auxiliary states; no op of the port has any yet."""
        return []

    def attr_dict(self):
        """{node name: {attr: value}} for every node in the graph."""
        ret = {}
        for node in self._nodes():
            d = dict(node.extra_attrs)
            if node.op is not None:
                d.update(node.op.serialize_attrs(node.attrs))
            if d:
                ret[node.name] = d
        return ret

    # -- arithmetic sugar ---------------------------------------------------
    def __add__(self, other):
        if isinstance(other, Symbol):
            return _invoke("elemwise_add", [self, other], {})
        return _invoke("_plus_scalar", [self], {"scalar": float(other)})

    def __radd__(self, other):
        return self.__add__(other)

    # -- inference ---------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from known input
        shapes (positional in ``list_arguments`` order or by keyword);
        raises when an argument stays unknown."""
        res = self.infer_shape_partial(*args, **kwargs)
        missing = [n for n, s in zip(self.list_arguments(), res[0])
                   if s is None]
        if missing:
            raise MXNetError("cannot fully infer shapes; unknown for "
                             "arguments: %s" % missing)
        return res

    def infer_shape_partial(self, *args, **kwargs):
        """Like :meth:`infer_shape`; unknown shapes come back as None."""
        known = {nm: tuple(s) for nm, s in zip(self.list_arguments(), args)
                 if s is not None}
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})
        return _infer_shapes(self, known)

    # -- serialization ------------------------------------------------------
    def tojson(self):
        """The graph in the reference's JSON format."""
        nodes = self._nodes()
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes, arg_nodes = [], []
        for i, n in enumerate(nodes):
            if n.is_variable:
                arg_nodes.append(i)
                jnodes.append({"op": "null", "name": n.name,
                               "attrs": dict(n.extra_attrs), "inputs": []})
            else:
                attrs = n.op.serialize_attrs(n.attrs)
                attrs.update(n.extra_attrs)
                jnodes.append({
                    "op": n.op.name, "name": n.name, "attrs": attrs,
                    "inputs": [[nid[id(x)], oi, 0] for x, oi in n.inputs]})
        heads = [[nid[id(n)], oi, 0] for n, oi in self._outputs]
        return json.dumps({"nodes": jnodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": [], "heads": heads,
                           "attrs": {"mxnet_tpu_version": "0.1"}}, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- binding ------------------------------------------------------------
    def simple_bind(self, ctx, grad_req="write", type_dict=None, **kwargs):
        """Infer every argument's shape from the given input shapes,
        allocate arguments and gradients on ``ctx`` and bind."""
        from . import ndarray as nd
        from .executor import Executor
        arg_shapes, _, _ = self.infer_shape(**kwargs)
        arg_names = self.list_arguments()
        type_dict = type_dict or {}
        args = [nd.zeros(s, ctx, dtype=type_dict.get(n, "float32"))
                for n, s in zip(arg_names, arg_shapes)]
        reqs = _grad_reqs(arg_names, grad_req)
        grads = {n: nd.zeros(s, ctx, dtype=type_dict.get(n, "float32"))
                 for n, s in zip(arg_names, arg_shapes)
                 if reqs.get(n, "null") != "null"}
        return Executor(self, ctx, args, grads, reqs)

    def bind(self, ctx, args, args_grad=None, grad_req="write"):
        """Bind caller-provided argument arrays (a list in
        ``list_arguments`` order or a dict by name)."""
        from .executor import Executor
        arg_names = self.list_arguments()
        if isinstance(args, dict):
            args = [args[n] for n in arg_names]
        if isinstance(args_grad, dict):
            grads = dict(args_grad)
        elif args_grad is None:
            grads = {}
        else:
            grads = {n: g for n, g in zip(arg_names, args_grad)
                     if g is not None}
        return Executor(self, ctx, list(args), grads,
                        _grad_reqs(arg_names, grad_req))

    def __repr__(self):
        return "<Symbol %s>" % (self.name or self.list_outputs())


def _grad_reqs(arg_names, grad_req):
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    return dict(grad_req)


# ---------------------------------------------------------------------------
# Shape inference: forward propagation plus write-back of filled inputs,
# iterated to a fixpoint (the role of nnvm's InferShape)
# ---------------------------------------------------------------------------
def _infer_shapes(symbol, known):
    nodes = symbol._nodes()
    node_out = {}   # (node id, out_idx) -> shape
    var_val = {}    # node id -> shape of a variable
    for n in nodes:
        if n.is_variable:
            v = known.get(n.name)
            if v is None and "__shape__" in n.extra_attrs:
                v = tuple(ast.literal_eval(n.extra_attrs["__shape__"]))
            var_val[id(n)] = v

    for _ in range(4):
        changed = False
        for n in nodes:
            if n.is_variable:
                node_out[(id(n), 0)] = var_val[id(n)]
                continue
            in_vals = [node_out.get((id(i), oi)) for i, oi in n.inputs]
            ins, outs, _ = n.op.infer_shape(n.attrs, in_vals)
            cur = [node_out.get((id(n), oi)) for oi in range(len(outs))]
            merged_outs = [unify_shapes(a, b) for a, b in zip(cur, outs)]
            back = n.op.infer_shape_backward(n.attrs, merged_outs, ins)
            ins = [unify_shapes(a, b) for a, b in zip(ins, back)]
            for (inp, oi), v in zip(n.inputs, ins):
                if v is None:
                    continue
                v = tuple(v)
                if inp.is_variable:
                    merged = unify_shapes(var_val.get(id(inp)), v)
                    if merged != var_val.get(id(inp)):
                        var_val[id(inp)] = merged
                        changed = True
                prev = node_out.get((id(inp), oi))
                merged = unify_shapes(prev, v)
                if merged != prev:
                    node_out[(id(inp), oi)] = merged
                    changed = True
            for oi, v in enumerate(outs):
                if v is not None:
                    prev = node_out.get((id(n), oi))
                    merged = unify_shapes(prev, tuple(v))
                    if merged != prev:
                        node_out[(id(n), oi)] = merged
                        changed = True
        if not changed:
            break
    arg_res = [var_val.get(id(n)) for n in nodes if n.is_variable]
    out_res = [node_out.get((id(n), oi)) for n, oi in symbol._outputs]
    return arg_res, out_res, []


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------
def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, **kwargs):
    """A variable symbol."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attr = dict(attr or {})
    if shape is not None:
        attr["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        attr["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attr["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        attr["__dtype__"] = np.dtype(dtype).name
    if init is not None:
        attr["__init__"] = init if isinstance(init, str) else init.dumps()
    for k, v in kwargs.items():
        attr["__%s__" % k] = str(v)
    return Symbol([(_Node(None, name, {}, [], attr), 0)])


def _invoke(op_name, sym_inputs, raw_attrs, name=None):
    """A node applying ``op_name`` to symbol inputs; missing inputs
    become variables named ``<node>_<argument>``."""
    op = get_op(op_name)
    extra = {k: str(v) for k, v in raw_attrs.items() if k.startswith("__")}
    attrs = op.parse_attrs({k: v for k, v in raw_attrs.items()
                            if not k.startswith("__")})
    name = NameManager.current().get(name, op_name.lower().lstrip("_"))
    inputs = []
    for i, nm in enumerate(op.arguments(attrs)):
        if i < len(sym_inputs) and sym_inputs[i] is not None:
            s = sym_inputs[i]
            if len(s._outputs) != 1:
                raise MXNetError(
                    "op %s input %s: composite symbol with %d outputs used "
                    "as a single input" % (op_name, nm, len(s._outputs)))
            inputs.append(s._outputs[0])
        else:
            inputs.append(Variable("%s_%s" % (name, nm))._outputs[0])
    node = _Node(op, name, attrs, inputs, extra)
    return Symbol([(node, i) for i in range(op.num_outputs(attrs))])


def load_json(json_str):
    """Rebuild a Symbol from its JSON (this package's or the
    reference's)."""
    data = json.loads(json_str)
    nodes = []
    for jn in data["nodes"]:
        attrs = jn.get("attrs", jn.get("attr", jn.get("param", {}))) or {}
        if jn["op"] == "null":
            nodes.append(_Node(None, jn["name"], {}, [], attrs))
            continue
        op = get_op(jn["op"])
        extra = {k: v for k, v in attrs.items() if k.startswith("__")}
        parsed = op.parse_attrs({k: v for k, v in attrs.items()
                                 if not k.startswith("__")})
        inputs = [(nodes[i], oi) for i, oi, *_ in jn["inputs"]]
        nodes.append(_Node(op, jn["name"], parsed, inputs, extra))
    heads = data.get("heads") or [[len(nodes) - 1, 0, 0]]
    return Symbol([(nodes[i], oi) for i, oi, *_ in heads])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


# ---------------------------------------------------------------------------
# One function per registered op: ``symbol.FullyConnected(data, ...)``
# ---------------------------------------------------------------------------
def _make_sym_func(op_name):
    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None) or {}
        op = get_op(op_name)
        sym_kwargs = {k: v for k, v in kwargs.items()
                      if isinstance(v, Symbol)}
        raw_attrs = {k: v for k, v in kwargs.items()
                     if not isinstance(v, Symbol)}
        inputs = [a for a in args if isinstance(a, Symbol)]
        if sym_kwargs:
            arg_names = op.arguments(op.parse_attrs(raw_attrs))
            inputs += [sym_kwargs.get(nm) for nm in arg_names[len(inputs):]]
        raw_attrs.update(attr)
        return _invoke(op_name, inputs, raw_attrs, name=name)

    fn.__name__ = op_name
    fn.__doc__ = get_op(op_name).doc or "%s symbol." % op_name
    return fn


def _init_symbol_module():
    mod = sys.modules[__name__]
    for op_name in list_ops():
        if not hasattr(mod, op_name):
            setattr(mod, op_name, _make_sym_func(op_name))


_init_symbol_module()
