"""What the op-library parity files (``tests/test_torch_ops_*.py``)
share, and the coverage of the port's registry.

Each parity case feeds the same numpy inputs, made from a seed, to an
op of ``mxnet_tpu`` (CPU) and of the port (CPU), both through ``mx.nd``,
and compares the numpy results, dtype names and shapes too:

* ``EXACT``: bit-equal (integer, bool, index, shape-only and ordering
  ops, and the IEEE-exact arithmetic: ``+ - * /``, max/min, abs, neg,
  sign, the rounding family);
* ``REL``: within 1e-5 x max|ref| (transcendentals, reductions, ``dot``
  and ``batch_dot``), NaN where the reference has NaN;
* ``BF16``: within 2^-8 x max|ref|, the bf16 cases of the arithmetic,
  broadcast and comparison families.

A backward case records the op under ``autograd.record()`` on inputs
that avoid exact zeros and ties at kinks, sends a random head gradient
back and holds every input's gradient within ``REL``.  The reference
runs its ops eagerly (its engine's ``set_imperative_jit(False)``, the
switch behind ``MXNET_IMPERATIVE_JIT``), so JAX compiles each primitive
once per shape and dtype, not a program per op call.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

PKGS = (jmx, tmx)
EXACT, REL, BF16 = "exact", 1e-5, 2.0 ** -8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module (the tests make thousands of
    tiny torch ops; under several workers a team of threads costs many
    times the op), the reference's ops eager and on their plain XLA
    lowerings (``MXNET_PALLAS=0``); all restored when the module ends,
    so later modules in the same process see the engine as it was."""
    n = torch.get_num_threads()
    engine = jmx.engine.get()
    jit, pallas = engine.imperative_jit, os.environ.get("MXNET_PALLAS")
    torch.set_num_threads(1)
    engine.set_imperative_jit(False)
    os.environ["MXNET_PALLAS"] = "0"
    yield
    torch.set_num_threads(n)
    engine.set_imperative_jit(jit)
    if pallas is None:
        os.environ.pop("MXNET_PALLAS", None)
    else:
        os.environ["MXNET_PALLAS"] = pallas


# ---------------------------------------------------------------------------
# inputs: (shape, domain) -> numpy, from a seed
# ---------------------------------------------------------------------------
def _signed(rs, shape, lo, hi):
    return (rs.choice([-1.0, 1.0], shape) * rs.uniform(lo, hi, shape))


DOMAINS = {
    "f": lambda rs, s: rs.randn(*s),
    "pos": lambda rs, s: rs.uniform(0.5, 3.0, s),
    "unit": lambda rs, s: rs.uniform(-0.9, 0.9, s),
    "gt1": lambda rs, s: rs.uniform(1.1, 3.0, s),
    # away from 0 (kinks of abs, relu, sign, division)
    "nz": lambda rs, s: _signed(rs, s, 0.25, 2.0),
    # quarters: .25, .5 and .75 exactly (the rounding family's halves)
    "quarter": lambda rs, s: rs.randint(-20, 21, s) / 4.0,
    # halves in [-1, 1]: many ties (comparisons, sorting)
    "ties": lambda rs, s: rs.randint(-2, 3, s) / 2.0,
    # negative non-integers (gamma's sign)
    "negfrac": lambda rs, s: -(rs.randint(0, 4, s) + rs.uniform(0.1, 0.9, s)),
    "i": lambda rs, s: rs.randint(-9, 10, s),
    "ipos": lambda rs, s: rs.randint(1, 6, s),
    "inz": lambda rs, s: rs.choice([-1, 1], s) * rs.randint(1, 6, s),
}


def arr(shape, domain="f", dtype=None):
    """An input spec: ``dtype`` float32 for the float domains and int32
    for the integer ones unless given (``'bfloat16'``: made in float32,
    cast by ``nd.array``)."""
    if dtype is None:
        dtype = "int32" if domain.startswith("i") else "float32"
    return (tuple(shape), domain, dtype)


def make(specs, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for shape, domain, dtype in specs:
        v = np.asarray(DOMAINS[domain](rs, shape))
        out.append(v.astype("float32" if dtype == "bfloat16" else dtype))
    return out


def _np(x):
    v = x.asnumpy()
    return v.astype(np.float32) if v.dtype.name == "bfloat16" else v


def _dtype(x):
    return getattr(x.dtype, "name", str(x.dtype))


def _listed(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def run(pkg, op, specs, attrs=None, seed=0, grad=False, values=None):
    """``pkg.nd.<op>`` on the inputs of ``specs`` (or ``values``, numpy
    arrays in their own dtypes); returns the outputs as ``(numpy,
    dtype name)`` pairs, and with ``grad`` each float input's gradient
    after a random head gradient."""
    attrs = dict(attrs or {})
    vals = make(specs, seed) if values is None else values
    dts = [s[2] for s in specs] if values is None else \
        [v.dtype.name for v in values]
    with pkg.cpu():
        xs = [pkg.nd.array(v, dtype=dt) for v, dt in zip(vals, dts)]
        if not grad:
            outs = _listed(getattr(pkg.nd, op)(*xs, **attrs))
            return [(_np(o), _dtype(o)) for o in outs]
        diff = [x for x, dt in zip(xs, dts) if dt == "float32"]
        for x in diff:
            x.attach_grad()
        with pkg.autograd.record():
            outs = _listed(getattr(pkg.nd, op)(*xs, **attrs))
        rs = np.random.RandomState(seed + 1)
        heads = [pkg.nd.array(np.asarray(rs.randn(*o.shape), np.float32))
                 for o in outs]
        pkg.autograd.backward(outs, heads)
        return [(_np(o), _dtype(o)) for o in outs] + \
            [(_np(x.grad), _dtype(x.grad)) for x in diff]


def run_sym(pkg, op, values, attrs=None, seed=0):
    """``op`` bound through ``pkg.sym`` on numpy ``values``: one
    train-mode forward and a backward with a random head gradient
    (the executor's path, which a ``custom_vjp`` head's reference
    gradient takes); returns the outputs and every input's gradient."""
    names = ["in%d" % i for i in range(len(values))]
    net = getattr(pkg.sym, op)(*[pkg.sym.Variable(n) for n in names],
                               **dict(attrs or {}))
    exe = net.simple_bind(pkg.cpu(), grad_req="write",
                          **{n: v.shape for n, v in zip(names, values)})
    for n, v in zip(names, values):
        exe.arg_dict[n][:] = v
    outs = exe.forward(is_train=True)
    rs = np.random.RandomState(seed + 1)
    with pkg.cpu():
        exe.backward([pkg.nd.array(np.asarray(rs.randn(*o.shape),
                                              np.float32)) for o in outs])
    return [(_np(o), _dtype(o)) for o in outs] + \
        [(_np(exe.grad_dict[n]), _dtype(exe.grad_dict[n])) for n in names]


def agree(got, want, tol, what=""):
    """Hold ``got`` to ``want`` (lists of (numpy, dtype name)) under
    ``tol``; returns the worst ratio of an error to its bound (0 for
    ``EXACT``)."""
    assert len(got) == len(want), (what, len(got), len(want))
    worst = 0.0
    for i, ((g, gdt), (w, wdt)) in enumerate(zip(got, want)):
        where = "%s output %d" % (what, i)
        assert g.shape == w.shape, (where, g.shape, w.shape)
        assert gdt == wdt, (where, gdt, wdt)
        if tol == EXACT or w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=where)
            continue
        g, w = g.astype(np.float64), w.astype(np.float64)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                      err_msg=where)
        ok = ~np.isnan(w)
        if not ok.any():
            continue
        bound = tol * max(float(np.abs(w[ok]).max()), 1e-30)
        err = float(np.abs(g[ok] - w[ok]).max())
        assert err <= bound, (where, err, bound)
        worst = max(worst, err / bound)
    return worst


def check(op, specs, attrs=None, tol=REL, seed=0, grad=False, values=None):
    """The port's ``op`` against the reference's on the same inputs."""
    want = run(jmx, op, specs, attrs, seed, grad, values)
    got = run(tmx, op, specs, attrs, seed, grad, values)
    return agree(got, want, tol, op)


def case_id(case):
    """A readable parametrize id: the op and its attributes."""
    op, attrs = case[0], case[2] if len(case) > 2 else {}
    return op + "".join("-%s=%s" % kv for kv in sorted(attrs.items()))


# ---------------------------------------------------------------------------
# coverage of the reference's op names
# ---------------------------------------------------------------------------
# The reference's op names the port does not have yet, each with the
# slice that brings it: ROADMAP.md Queue 1 item 4 lists the same set.
STILL_TO_PORT = {
    # ops/vision.py (6)
    "BilinearSampler", "Correlation", "Crop", "GridGenerator",
    "ROIPooling", "SpatialTransformer",
    # ops/contrib.py (21)
    "CTCLoss", "MultiBoxDetection", "MultiBoxPrior", "MultiBoxTarget",
    "Proposal", "_contrib_CTCLoss", "_contrib_MultiBoxDetection",
    "_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget",
    "_contrib_Proposal", "_contrib_count_sketch", "_contrib_dequantize",
    "_contrib_fft", "_contrib_ifft", "_contrib_quantize", "count_sketch",
    "ctc_loss", "dequantize", "fft", "ifft", "quantize",
    # ops/custom.py
    "Custom",
}


def test_registry_holds_every_reference_op_but_the_listed_ones():
    ref, port = set(jreg.list_ops()), set(treg.list_ops())
    assert len(STILL_TO_PORT) == 28
    assert ref - port == STILL_TO_PORT
    assert port - ref == set()
    assert len(port) == 222


def test_roadmap_lists_the_same_ops_still_to_port():
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "..", "ROADMAP.md")) as f:
        text = f.read()
    block = text.split("<!-- ops still to port -->")[1]
    listed = {w.strip("`,.;: ") for w in block.split("<!-- end -->")[0]
              .split() if w.startswith("`")}
    assert listed == STILL_TO_PORT


# a value for each required attribute, by name and parser
_REQUIRED = {"int": 2, "float": 1.0, "str": "relu", "_parse_shape": (1,),
             "_parse_dtype": "float32"}


@pytest.mark.parametrize("name", sorted(set(treg.list_ops())))
def test_every_port_op_keeps_the_reference_arguments(name):
    """Each op's attribute names, arguments, outputs and variadic count
    are the reference's, for its defaults and a value of each required
    attribute."""
    jop, top = jreg.get_op(name), treg.get_op(name)
    assert set(top.attr_specs) == set(jop.attr_specs), name
    assert top.key_var_num_args == jop.key_var_num_args, name
    raw = {k: _REQUIRED[spec.parse.__name__]
           for k, spec in top.attr_specs.items() if spec.required}
    ja, ta = jop.parse_attrs(raw), top.parse_attrs(raw)
    assert top.arguments(ta) == jop.arguments(ja), name
    assert top.num_outputs(ta) == jop.num_outputs(ja), name
    assert top.outputs(ta) == jop.outputs(ja), name
    assert top.aux_states(ta) == jop.aux_states(ja), name
