"""The image-classification zoo of the port (``models/alexnet.py``,
``vgg.py``, ``googlenet.py``, ``inception_bn.py``, ``inception_v3.py``,
``resnext.py``, ``inception_resnet_v2.py``) against ``mxnet_tpu``'s.

Structure: each network at full size (3 x 224 x 224, Inception-v3 and
Inception-ResNet-v2 3 x 299 x 299, 1000 classes, batch 32) has the
reference's argument, auxiliary and output names and ``infer_shape``
shapes, and its parameter count.  Both packages build each network
once, in a module fixture, under a fresh ``NameManager`` (the unnamed
layers of Inception-ResNet-v2 take their names from its counters).

Numbers: a unit of each model file's own factories (an Inception-BN
unit, Inception-v3's factorized 7 x 7 unit, an Inception-ResNet-v2
block, a ResNeXt unit with its projection, a GoogLeNet module) and
AlexNet whole at batch 1 (3 x 99 x 99, its Dropouts at p = 0), bound
through ``simple_bind`` on the same numpy arguments from a seed (the
units grouped into one symbol, each on its own data), take one
train-mode forward (BatchNorm on the batch's statistics) and a backward
with a random head gradient: the output within 1e-5 x max|ref| and
every argument's gradient within 1e-4 x max|ref| (a convolution's bias
before a BatchNorm, whose exact gradient is 0, within 1e-4 x the
max|ref| of its weight's gradient in both packages).  Inputs are
continuous draws, so no ReLU or max-pool input sits at a kink or a tie.
"""
import importlib
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from test_torch_ops_common import _one_torch_thread  # noqa: F401

FWD, GRAD = 1e-5, 1e-4

# network -> (builder arguments, image shape, the reference's parameter
# count at 1000 classes)
ZOO = {
    "alexnet": ({}, (3, 224, 224), 50844008),
    "vgg": ({"num_layers": 16}, (3, 224, 224), 138357544),
    "googlenet": ({}, (3, 224, 224), 6998552),
    "inception_bn": ({}, (3, 224, 224), 11295240),
    "inception_v3": ({}, (3, 299, 299), 23834568),
    "resnext": ({"num_layers": 50}, (3, 224, 224), 25028910),
    "inception_resnet_v2": ({}, (3, 299, 299), 56009476),
}


def _module(pkg, name):
    return importlib.import_module(pkg.__name__ + ".models." + name)


def _fresh_names(pkg):
    return (jmx.name.NameManager() if pkg is jmx
            else tmx.symbol.NameManager())


def _build(pkg, fn):
    with _fresh_names(pkg):
        return fn(pkg)


@pytest.fixture(scope="module")
def zoo():
    """name -> ((names, shapes) of the port, of the reference)."""
    out = {}
    for name, (kwargs, image, _) in ZOO.items():
        pair = []
        for pkg in (tmx, jmx):
            net = _build(pkg, lambda p: getattr(p.models, name)(
                num_classes=1000, **kwargs))
            pair.append(((net.list_arguments(), net.list_auxiliary_states(),
                          net.list_outputs()),
                         net.infer_shape(data=(32,) + image)))
        out[name] = pair
    return out


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_names_and_shapes_match_jax(zoo, name):
    (tnames, tshapes), (jnames, jshapes) = zoo[name]
    assert tnames == jnames
    assert tshapes == jshapes
    args, outs, _ = tshapes
    assert outs == [(32, 1000)]
    count = sum(int(np.prod(s)) for n, s in zip(tnames[0], args)
                if n not in ("data", "softmax_label"))
    assert count == ZOO[name][2]


def test_zoo_reexports_match_jax():
    for name in ZOO:
        assert getattr(tmx.models, name) is _module(tmx, name).get_symbol
        assert hasattr(jmx.models, name)


# ---------------------------------------------------------------------------
# the units' numbers
# ---------------------------------------------------------------------------
def _values(net, shapes, seed):
    """Arguments (data, weights near He scale, gamma in [0.5, 1.5], the
    rest of scale 0.5) by name."""
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    vals = {}
    for name, s in zip(net.list_arguments(), arg_shapes):
        if name.endswith("gamma"):
            v = rs.uniform(0.5, 1.5, s)
        elif name == "softmax_label":
            v = rs.randint(0, 10, s)
        elif name.endswith("weight") and len(s) > 1:
            v = rs.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
        else:
            v = rs.randn(*s) * 0.5
        vals[name] = v.astype(np.float32)
    return vals


def _bias_weight_before_bn(net):
    """{bias name: its weight's name} for each Convolution whose output a
    train-mode BatchNorm takes: such a bias's gradient is 0 in exact
    arithmetic (the batch mean takes it out again), and what either
    package computes is the rounding of a sum that cancels."""
    graph = json.loads(net.tojson())
    nodes = graph["nodes"]
    out = {}
    for node in nodes:
        if node["op"] != "BatchNorm":
            continue
        src = nodes[node["inputs"][0][0]]
        if src["op"] == "Convolution" and len(src["inputs"]) == 3:
            out[nodes[src["inputs"][2][0]]["name"]] = \
                nodes[src["inputs"][1][0]]["name"]
    return out


def _run(pkg, net, shapes, seed=0):
    """One train-mode forward of ``net`` (every output) and a backward
    with a random head gradient for each, through ``simple_bind``:
    the outputs, every argument's gradient by name, and the biases
    before a BatchNorm by name with their weights'."""
    vals = _values(net, shapes, seed)
    exe = net.simple_bind(pkg.cpu(), grad_req="write", **shapes)
    for name, arr in exe.arg_dict.items():
        arr[:] = vals[name]
    outs = exe.forward(is_train=True)
    rs = np.random.RandomState(seed + 1)
    heads = [rs.randn(*o.shape).astype(np.float32) for o in outs]
    with pkg.cpu():
        exe.backward([pkg.nd.array(h) for h in heads])
    return ([o.asnumpy() for o in outs],
            {n: g.asnumpy() for n, g in exe.grad_dict.items()},
            _bias_weight_before_bn(net))


def _within(got, want, tol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max())
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    assert err <= bound, (what, err, bound)


def _unit(file, factory, *args, **kwargs):
    """A builder of one unit: ``build(pkg, data, name)``, ``name`` the
    unit's name where its factory takes one (in place of ``NAME``)."""
    def build(pkg, data, name):
        return getattr(_module(pkg, file), factory)(
            data, *[name if a is NAME else a for a in args], **kwargs)
    return build


NAME = object()
# case -> (builder, data shape)
UNITS = {
    "inception_bn-A": (_unit("inception_bn", "InceptionFactoryA", 4, 4, 6,
                             4, 6, "avg", 4, NAME), (2, 8, 7, 7)),
    "inception_v3-C": (_unit("inception_v3", "Inception7C", 4, 4, 4, 6, 4,
                             4, 4, 4, 6, "avg", 4, NAME), (2, 8, 7, 7)),
    "inception_resnet_v2-block35": (_unit(
        "inception_resnet_v2", "block35", 16, scale=0.17), (2, 16, 5, 5)),
    "resnext-projection": (_unit("resnext", "residual_unit", 32, (2, 2),
                                 False, NAME, num_group=4), (2, 16, 6, 6)),
    "googlenet-module": (_unit("googlenet", "_inception", NAME,
                               (4, 4, 6, 2, 4, 4)), (2, 8, 7, 7)),
}
ALEXNET_DATA = (1, 3, 99, 99)


def _alexnet(pkg):
    """AlexNet with its two Dropouts at p = 0 (through the JSON graph):
    the packages' draws differ, and Dropout is held in distribution by
    the layer tests."""
    graph = json.loads(pkg.models.alexnet(num_classes=10).tojson())
    for node in graph["nodes"]:
        if node["op"] == "Dropout":
            node["attrs"]["p"] = "0"
    return pkg.sym.load_json(json.dumps(graph))


def _units(pkg):
    """Every unit on its own data variable ``data<i>``, named ``u<i>``,
    grouped into one symbol (one bind, one compiled program in the
    reference); each unit's argument names."""
    with _fresh_names(pkg):
        outs = [build(pkg, pkg.sym.Variable("data%d" % i), "u%d" % i)
                for i, (build, _) in enumerate(UNITS.values())]
    return pkg.sym.Group(outs), [o.list_arguments() for o in outs]


@pytest.fixture(scope="module")
def units():
    """case -> (port's, reference's) (output, {argument: gradient}),
    and the biases before a BatchNorm with their weights."""
    shapes = {"data%d" % i: shape
              for i, (_, shape) in enumerate(UNITS.values())}
    res, names = [], None
    for pkg in (tmx, jmx):
        net, names = _units(pkg)
        res.append(_run(pkg, net, shapes))
        anet = _build(pkg, _alexnet)
        res[-1] += (_run(pkg, anet, {"data": ALEXNET_DATA}),)
    (touts, tgrads, tbn, talex), (jouts, jgrads, jbn, jalex) = res
    assert tbn == jbn and sorted(tgrads) == sorted(jgrads)
    out = {case: ((touts[i], {n: tgrads[n] for n in names[i]}),
                  (jouts[i], {n: jgrads[n] for n in names[i]}))
           for i, case in enumerate(UNITS)}
    out["alexnet"] = ((talex[0][0], talex[1]), (jalex[0][0], jalex[1]))
    return out, dict(tbn, **talex[2])


@pytest.mark.parametrize("case", sorted(UNITS) + ["alexnet"])
def test_zoo_units_forward_and_gradients_match_jax(units, case):
    """The output within FWD and each gradient within GRAD x max|ref|;
    a bias before a BatchNorm, whose exact gradient is 0, within GRAD x
    max|ref| of its weight's gradient in both packages."""
    res, before_bn = units
    (got, ggrads), (want, wgrads) = res[case]
    _within(got, want, FWD, (case, "output"))
    assert sorted(ggrads) == sorted(wgrads)
    for name, w in wgrads.items():
        g = ggrads[name]
        if name in before_bn:
            scale = float(np.abs(wgrads[before_bn[name]]).max())
            assert max(np.abs(g).max(), np.abs(w).max()) <= GRAD * scale, \
                (case, "bias before BatchNorm", name)
        else:
            _within(g, w, GRAD, (case, name))
