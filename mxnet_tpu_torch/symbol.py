"""Symbol: the symbolic graph frontend of the port (counterpart of
``mxnet_tpu/symbol.py``).

A graph is a Python DAG of :class:`_Node` objects, each an op of
:mod:`.ops.registry` with typed attributes, or a variable.  Composition,
auto-naming (``fullyconnected0``, ...), ``list_arguments`` /
``list_outputs`` / ``list_auxiliary_states``, ``infer_shape`` /
``infer_type``, ``attr_dict`` / ``list_attr``, ``get_internals``,
indexing an output (``sym[0]``, ``sym['fc1_output']``), ``Group``, the
arithmetic operators (``+ - * / **`` and unary ``-`` between Symbols,
through ``elemwise_*`` / ``_power``, or with a scalar on either side,
through the ``*_scalar`` ops) and the JSON format are the reference's,
so a graph written by ``mxnet_tpu``'s ``Symbol.tojson`` loads here and
the reverse.  A variadic op (``Concat``, ``add_n``) takes its inputs
positionally and counts them into its ``num_args``; an op with several
outputs (``SliceChannel``, ``topk(ret_typ='both')``) gives a Symbol of
that many outputs.  An op's auxiliary states (BatchNorm's
``moving_mean`` and ``moving_var``) are variables too, named
``<node>_<state>`` unless given, and follow its arguments among the
node's inputs, as in the reference's graph and JSON; a variable that
feeds only such slots is listed by :meth:`Symbol.list_auxiliary_states`
and not by :meth:`Symbol.list_arguments`.  ``bind`` / ``simple_bind``
return an :class:`~.executor.Executor`.
"""
from __future__ import annotations

import ast
import json
import sys
import threading

import numpy as np

from . import ops as _ops  # noqa: F401  (registers every op)
from .attribute import AttrScope
from .base import MXNetError
from .ops.registry import get_op, list_ops, unify_shapes

__all__ = ["Symbol", "Variable", "Group", "load", "load_json",
           "NameManager"]


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

    def num_args(self):
        return len(self.op.arguments(self.attrs)) if self.op else 0

    def arg_inputs(self):
        return self.inputs[:self.num_args()]

    def aux_inputs(self):
        return self.inputs[self.num_args():]


def _aux_ids(nodes):
    """Ids of the variables that feed only auxiliary-state slots."""
    aux, arg = set(), set()
    for n in nodes:
        if not n.is_variable:
            aux.update(id(i) for i, _ in n.aux_inputs())
            arg.update(id(i) for i, _ in n.arg_inputs())
    return aux - arg


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

    def __getitem__(self, index):
        """Output ``index`` (a position or an output name) as a
        Symbol of its own."""
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("output %r not found" % index)
            index = names.index(index)
        return Symbol([self._outputs[index]])

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def _nodes(self):
        return _topo_sort([n for n, _ in self._outputs])

    def list_arguments(self):
        """Input arguments (data variables and parameters), in
        topological order."""
        nodes = self._nodes()
        aux = _aux_ids(nodes)
        return [n.name for n in nodes if n.is_variable and id(n) not in aux]

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

    def list_index_arguments(self):
        """Arguments that every reader takes as integer indices (an
        op's ``index_inputs``, such as ``Embedding``'s ``data``) and no
        output returns as they are."""
        readers = {}   # argument name -> [index read?]
        for node in self._nodes():
            if node.is_variable:
                continue
            names = node.op.arguments(node.attrs)
            for pos, (inp, _oi) in enumerate(node.inputs):
                if inp.is_variable:
                    readers.setdefault(inp.name, []).append(
                        pos < len(names) and
                        names[pos] in node.op.index_inputs)
        heads = {n.name for n, _ in self._outputs if n.is_variable}
        return [n for n in self.list_arguments()
                if n not in heads and readers.get(n) and all(readers[n])]

    def list_auxiliary_states(self):
        """Auxiliary states (BatchNorm's moving statistics): buffers
        that take no gradient, in topological order."""
        nodes = self._nodes()
        aux = _aux_ids(nodes)
        return [n.name for n in nodes if id(n) in aux]

    def get_internals(self):
        """A Symbol whose outputs are every node's outputs, variables
        included, in topological order (``fc1_output``, ...)."""
        outs = []
        for node in self._nodes():
            n = 1 if node.is_variable else node.op.num_outputs(node.attrs)
            outs.extend((node, i) for i in range(n))
        return Symbol(outs)

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

    def list_attr(self):
        """The head node's own attributes, with the ``__key__`` wrapping
        stripped."""
        return {k[2:-2] if k.startswith("__") and k.endswith("__") else k: v
                for k, v in self._outputs[0][0].extra_attrs.items()}

    # -- arithmetic sugar ---------------------------------------------------
    def _binary(self, op_name, scalar_op_name, other):
        if isinstance(other, Symbol):
            return _invoke(op_name, [self, other], {})
        return _invoke(scalar_op_name, [self], {"scalar": float(other)})

    def __add__(self, other):
        return self._binary("elemwise_add", "_plus_scalar", other)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return self._binary("elemwise_sub", "_minus_scalar", other)

    def __rsub__(self, other):
        return _invoke("_rminus_scalar", [self], {"scalar": float(other)})

    def __mul__(self, other):
        return self._binary("elemwise_mul", "_mul_scalar", other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        return self._binary("elemwise_div", "_div_scalar", other)

    def __rtruediv__(self, other):
        return _invoke("_rdiv_scalar", [self], {"scalar": float(other)})

    def __pow__(self, other):
        return self._binary("_power", "_power_scalar", other)

    def __neg__(self):
        return _invoke("negative", [self], {})

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
        return _infer_pass(self, known, "shape")

    def infer_type(self, *args, **kwargs):
        """``(arg_types, out_types, aux_types)`` as dtype names from
        known input dtypes (positional or by keyword); unknown ones
        come back as None."""
        known = {nm: _dtype_name(t)
                 for nm, t in zip(self.list_arguments(), args)
                 if t is not None}
        known.update({k: _dtype_name(v) for k, v in kwargs.items()
                      if v is not None})
        return _infer_pass(self, known, "type")

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
    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    compute_dtype=None, keep_dtype=(), **kwargs):
        """Infer every argument's shape from the given input shapes,
        allocate arguments, gradients and auxiliary states on ``ctx``
        and bind;
        ``compute_dtype`` and ``keep_dtype`` as :class:`Executor`'s (the
        arrays stay in their own dtypes, float32 by default)."""
        from . import ndarray as nd
        from .executor import Executor
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_names = self.list_arguments()
        type_dict = type_dict or {}
        args = [nd.zeros(s, ctx, dtype=type_dict.get(n, "float32"))
                for n, s in zip(arg_names, arg_shapes)]
        reqs = _grad_reqs(arg_names, grad_req)
        grads = {n: nd.zeros(s, ctx, dtype=type_dict.get(n, "float32"))
                 for n, s in zip(arg_names, arg_shapes)
                 if reqs.get(n, "null") != "null"}
        aux = [nd.zeros(s, ctx, dtype=type_dict.get(n, "float32"))
               for n, s in zip(self.list_auxiliary_states(), aux_shapes)]
        return Executor(self, ctx, args, grads, reqs, compute_dtype,
                        keep_dtype, aux)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, compute_dtype=None, keep_dtype=()):
        """Bind caller-provided argument arrays (a list in
        ``list_arguments`` order or a dict by name) and auxiliary states
        (the same, in ``list_auxiliary_states`` order); ``compute_dtype``
        and ``keep_dtype`` as :class:`Executor`'s."""
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
        if isinstance(aux_states, dict):
            aux_states = [aux_states[n] for n in self.list_auxiliary_states()]
        return Executor(self, ctx, list(args), grads,
                        _grad_reqs(arg_names, grad_req), compute_dtype,
                        keep_dtype, list(aux_states or []))

    def __repr__(self):
        return "<Symbol %s>" % (self.name or self.list_outputs())


def _grad_reqs(arg_names, grad_req):
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    return dict(grad_req)


def _dtype_name(t):
    """A dtype (a name, numpy's, or bf16's stand-in) as its name."""
    return "bfloat16" if str(t) == "bfloat16" else np.dtype(t).name


# ---------------------------------------------------------------------------
# Shape and type inference: forward propagation plus write-back of
# filled inputs, iterated to a fixpoint (the role of nnvm's InferShape
# and InferType)
# ---------------------------------------------------------------------------
def _merge(kind, prev, v):
    """Two partial results in one: shapes unify (0 is a wildcard), a
    known type stays."""
    if kind == "shape":
        return unify_shapes(prev, v)
    return prev if prev is not None else v


def _infer_pass(symbol, known, kind, with_nodes=False):
    nodes = symbol._nodes()
    node_out = {}   # (node id, out_idx) -> shape or type
    var_val = {}    # node id -> shape or type of a variable
    attr_key = "__shape__" if kind == "shape" else "__dtype__"
    for n in nodes:
        if n.is_variable:
            v = known.get(n.name)
            if v is None and attr_key in n.extra_attrs:
                v = n.extra_attrs[attr_key]
                if kind == "shape":
                    v = tuple(ast.literal_eval(v))
            var_val[id(n)] = v

    def fix(v):
        return tuple(v) if kind == "shape" else v

    for _ in range(4):
        changed = False
        for n in nodes:
            if n.is_variable:
                node_out[(id(n), 0)] = var_val[id(n)]
                continue
            nargs = n.num_args()
            in_vals = [node_out.get((id(i), oi))
                       for i, oi in n.inputs[:nargs]]
            if kind == "shape":
                ins, outs, aux = n.op.infer_shape(n.attrs, in_vals)
                cur = [node_out.get((id(n), oi)) for oi in range(len(outs))]
                merged_outs = [unify_shapes(a, b) for a, b in zip(cur, outs)]
                back = n.op.infer_shape_backward(n.attrs, merged_outs, ins)
                ins = [unify_shapes(a, b) for a, b in zip(ins, back)]
            else:
                ins, outs, aux = n.op.infer_type(n.attrs, in_vals)
            for (inp, oi), v in zip(n.inputs, list(ins) + list(aux)):
                if v is None:
                    continue
                v = fix(v)
                if inp.is_variable:
                    merged = _merge(kind, var_val.get(id(inp)), v)
                    if merged != var_val.get(id(inp)):
                        var_val[id(inp)] = merged
                        changed = True
                prev = node_out.get((id(inp), oi))
                merged = _merge(kind, prev, v)
                if merged != prev:
                    node_out[(id(inp), oi)] = merged
                    changed = True
            for oi, v in enumerate(outs):
                if v is not None:
                    prev = node_out.get((id(n), oi))
                    merged = _merge(kind, prev, fix(v))
                    if merged != prev:
                        node_out[(id(n), oi)] = merged
                        changed = True
        if not changed:
            break
    aux_ids = _aux_ids(nodes)
    arg_res = [var_val.get(id(n)) for n in nodes
               if n.is_variable and id(n) not in aux_ids]
    aux_res = [var_val.get(id(n)) for n in nodes if id(n) in aux_ids]
    out_res = [node_out.get((id(n), oi)) for n, oi in symbol._outputs]
    if with_nodes:
        return arg_res, out_res, aux_res, node_out
    return arg_res, out_res, aux_res


def infer_node_shapes(symbol, known):
    """Every node's output shapes, ``{(id(node), out_idx): shape}``, from
    the known input shapes ``{name: shape}``: where an init op's
    ``shape`` holds a 0 (a wildcard, as ``begin_state``'s ``(0, H)``),
    its entry is what its consumers made of it."""
    return _infer_pass(symbol, known, "shape", with_nodes=True)[3]


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------
def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, **kwargs):
    """A variable symbol; the current :class:`AttrScope`'s attributes
    are its own under ``attr``'s."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attr = AttrScope.current().get(attr)
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


def Group(symbols):
    """One Symbol whose outputs are the given symbols' outputs, in
    order."""
    return Symbol([o for s in symbols for o in s._outputs])


def _invoke(op_name, sym_inputs, raw_attrs, name=None, aux_syms=()):
    """A node applying ``op_name`` to symbol inputs and auxiliary states
    (``aux_syms``); missing ones become variables named
    ``<node>_<argument>`` / ``<node>_<state>``.  A variadic op counts
    its inputs into ``key_var_num_args`` unless the caller set it."""
    op = get_op(op_name)
    if op.key_var_num_args and op.key_var_num_args not in raw_attrs:
        raw_attrs = dict(raw_attrs)
        raw_attrs[op.key_var_num_args] = len(sym_inputs)
    extra = {k: str(v) for k, v in raw_attrs.items() if k.startswith("__")}
    attrs = op.parse_attrs({k: v for k, v in raw_attrs.items()
                            if not k.startswith("__")})
    name = NameManager.current().get(name, op_name.lower().lstrip("_"))
    extra = AttrScope.current().get(extra)
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
    for i, nm in enumerate(op.aux_states(attrs)):
        s = aux_syms[i] if i < len(aux_syms) else None
        inputs.append((s if s is not None else
                       Variable("%s_%s" % (name, nm)))._outputs[0])
    node = _Node(op, name, attrs, inputs, extra)
    return Symbol([(node, i) for i in range(op.num_outputs(attrs))])


def zeros(shape, dtype="float32", **kwargs):
    """A symbol of zeros of ``shape``; a 0 in it is resolved at bind
    from the graph around it."""
    return _invoke("_zeros", [], {"shape": shape, "dtype": dtype}, **kwargs)


def ones(shape, dtype="float32", **kwargs):
    """A symbol of ones of ``shape``, as :func:`zeros`."""
    return _invoke("_ones", [], {"shape": shape, "dtype": dtype}, **kwargs)


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
        aux = []
        if sym_kwargs:
            if op.key_var_num_args and op.key_var_num_args not in raw_attrs:
                raw_attrs[op.key_var_num_args] = len(inputs) + len(sym_kwargs)
            parsed = op.parse_attrs(raw_attrs)
            arg_names = op.arguments(parsed)
            inputs += [sym_kwargs.get(nm) for nm in arg_names[len(inputs):]]
            aux = [sym_kwargs.get(nm) for nm in op.aux_states(parsed)]
        raw_attrs.update(attr)
        return _invoke(op_name, inputs, raw_attrs, name=name, aux_syms=aux)

    fn.__name__ = op_name
    fn.__doc__ = get_op(op_name).doc or "%s symbol." % op_name
    return fn


def _init_symbol_module():
    mod = sys.modules[__name__]
    for op_name in list_ops():
        if not hasattr(mod, op_name):
            setattr(mod, op_name, _make_sym_func(op_name))


_init_symbol_module()
