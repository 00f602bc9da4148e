"""The op library through the port's ``Symbol`` against ``mxnet_tpu``'s:
``infer_shape`` and ``infer_type`` of each op of the ported op modules,
Symbol arithmetic with Symbols and scalars on both sides, ``Group``,
``get_internals``, ``__getitem__`` and ``list_attr``, variadic and
multi-output ops in ``Module``, and the slice as a whole: the
reference's matrix-factorization recommender
(``examples/recommenders/matrix_fact.py``) trained by ``Module.fit`` in
both packages from the same parameters."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import registry as treg
from test_torch_ops_common import (REL, _one_torch_thread,  # noqa: F401
                                   agree)

_MODULES = {"elemwise", "tensor", "reduce", "indexing", "ordering",
            "init_ops", "sequence"}
_HEADS = {"LinearRegressionOutput", "LogisticRegressionOutput",
          "MAERegressionOutput", "SVMOutput", "IdentityAttachKLSparseReg"}
S = (6, 8)
# ops whose inputs or attributes the generic rules below do not cover
EXPLICIT = {
    "dot": ([(5, 7), (7, 3)], {}), "batch_dot": ([(3, 5, 7), (3, 7, 4)], {}),
    "Concat": ([(2, 3), (2, 4), (2, 1)], {"dim": 1}),
    "concat": ([(2, 3), (5, 3)], {"dim": 0}),
    "add_n": ([S, S, S], {}), "ElementWiseSum": ([S, S], {}),
    "_sum": ([S, S, S, S], {}),
    "expand_dims": ([(2, 3)], {"axis": 1}),
    "SwapAxis": ([(2, 3, 4)], {"dim1": 0, "dim2": 2}),
    "swapaxes": ([(2, 3, 4)], {"dim1": 1, "dim2": 2}),
    "slice": ([(5, 6)], {"begin": (1, 2), "end": (4, 5)}),
    "crop": ([(5, 6)], {"begin": (0, 0), "end": (2, 3)}),
    "slice_axis": ([(5, 6)], {"axis": 1, "begin": 1, "end": 4}),
    "clip": ([S], {"a_min": -1.0, "a_max": 1.0}),
    "repeat": ([(2, 3)], {"repeats": 2, "axis": 1}),
    "tile": ([(2, 3)], {"reps": (2, 2)}),
    "reverse": ([(2, 3)], {"axis": (1,)}), "flip": ([(2, 3)], {"axis": 0}),
    "where": ([(4, 3), (4, 3), (4, 3)], {}),
    "SliceChannel": ([(2, 6)], {"num_outputs": 3}),
    "split": ([(4, 6)], {"num_outputs": 2, "axis": 0,
                         "squeeze_axis": False}),
    "Pad": ([(1, 2, 3, 4)], {"pad_width": (0, 0, 0, 0, 1, 1, 2, 2)}),
    "pad": ([(1, 2, 3, 4)], {"mode": "edge",
                             "pad_width": (0, 0, 0, 0, 1, 1, 2, 2)}),
    "Reshape": ([(4, 6)], {"shape": (3, -1)}),
    "reshape": ([(4, 6)], {"shape": (0, 2, -1)}),
    "broadcast_to": ([(1, 5)], {"shape": (4, 5)}),
    "broadcast_axis": ([(4, 1)], {"axis": (1,), "size": (6,)}),
    "broadcast_axes": ([(1, 4)], {"axis": 0, "size": 3}),
    "take": ([(5, 6), (2, 3)], {}), "batch_take": ([(5, 6), (5,)], {}),
    "one_hot": ([(2, 3)], {"depth": 4}), "pick": ([(5, 6), (5,)], {}),
    "topk": ([(3, 8)], {"k": 2, "ret_typ": "both"}),
    "_zeros": ([], {"shape": (2, 3)}),
    "_ones": ([], {"shape": (4,), "dtype": "int32"}),
    "_arange": ([], {"start": 0.0, "stop": 6.0, "repeat": 2}),
    "SequenceLast": ([(5, 4, 3), (4,)], {"use_sequence_length": True}),
    "SequenceMask": ([(5, 4, 3), (4,)], {"use_sequence_length": True}),
    "SequenceReverse": ([(5, 4)], {}),
    "Embedding": ([(4, 5), (10, 3)], {"input_dim": 10, "output_dim": 3}),
    "Cast": ([S], {"dtype": "int32"}), "cast": ([S], {"dtype": "float16"}),
    "sum": ([(2, 3, 4)], {"axis": 1}), "argmax": ([(2, 3)], {"axis": 1}),
    "SVMOutput": ([(6, 3), (6,)], {}),
}


def _spec(name):
    if name in EXPLICIT:
        return EXPLICIT[name]
    op = treg.get_op(name)
    attrs = {"scalar": 1.5} if "scalar" in op.attr_specs else {}
    n = len(op.arguments(op.parse_attrs(attrs)))
    if name.startswith("broadcast_"):
        return [(S[0], 1), (1, S[1])], attrs
    return [S] * n, attrs


def _module_of(op):
    """The module that defines an op (its ``fstateful`` where it has no
    ``fcompute``)."""
    return (op.fcompute or op.fstateful).__module__.rsplit(".", 1)[-1]


def _ported_ops():
    return sorted(n for n in treg.list_ops()
                  if n in _HEADS or _module_of(treg.get_op(n)) in _MODULES)


def _infer(pkg, name):
    shapes, attrs = _spec(name)
    names = ["in%d" % i for i in range(len(shapes))]
    with pkg.name.NameManager() if pkg is jmx else tmx.symbol.NameManager():
        net = getattr(pkg.sym, name)(*[pkg.sym.Variable(n) for n in names],
                                     **attrs)
    return (net.list_arguments(), net.list_outputs(),
            net.infer_shape(**dict(zip(names, shapes))),
            net.infer_type(**{n: "float32" for n in names}))


@pytest.mark.parametrize("name", _ported_ops())
def test_infer_shape_and_type_match_the_reference(name):
    want, got = _infer(jmx, name), _infer(tmx, name)
    assert got[:2] == want[:2]
    for g, w in zip(got[2] + got[3], want[2] + want[3]):
        assert [None if x is None else tuple(x) if isinstance(x, (list,
                tuple)) else x for x in g] == \
            [None if x is None else tuple(x) if isinstance(x, (list,
             tuple)) else x for x in w], name


def _arith_graph(pkg):
    """Every Symbol operator, between Symbols and with a scalar on each
    side, as one ``Group``."""
    with pkg.name.NameManager() if pkg is jmx else tmx.symbol.NameManager():
        a, b = pkg.sym.Variable("a"), pkg.sym.Variable("b")
        return pkg.sym.Group([
            a + b, a - b, a * b, a / b, a ** b, -a, a + 2, 2 + a, a - 2,
            2 - a, a * 3, 3 * a, a / 4, 4 / a, a ** 2, (a * b + 1) / (b - 3)])


def _bind_run(pkg, net, values, grad=True):
    exe = net.simple_bind(pkg.cpu(), grad_req="write" if grad else "null",
                          **{k: v.shape for k, v in values.items()})
    for k, v in values.items():
        exe.arg_dict[k][:] = v
    outs = exe.forward(is_train=grad)
    res = [o.asnumpy() for o in outs]
    if grad:
        with pkg.cpu():
            exe.backward([pkg.nd.ones(o.shape) for o in outs])
        res += [exe.grad_dict[k].asnumpy() for k in sorted(values)]
    return res


def test_symbol_arithmetic_with_symbols_and_scalars():
    rs = np.random.RandomState(0)
    vals = {"a": rs.uniform(0.5, 2, (3, 4)).astype(np.float32),
            "b": rs.uniform(0.5, 2, (3, 4)).astype(np.float32)}
    want_net, got_net = _arith_graph(jmx), _arith_graph(tmx)
    assert got_net.list_outputs() == want_net.list_outputs()
    assert [n["op"] for n in __import__("json").loads(got_net.tojson())
            ["nodes"]] == [n["op"] for n in __import__("json").loads(
                want_net.tojson())["nodes"]]
    want, got = _bind_run(jmx, want_net, vals), _bind_run(tmx, got_net, vals)
    agree([(g, "") for g in got], [(w, "") for w in want], REL, "arith")


def test_group_internals_getitem_and_list_attr():
    def build(pkg):
        nm = pkg.name.NameManager() if pkg is jmx else \
            tmx.symbol.NameManager()
        with nm:
            x = pkg.sym.Variable("x", lr_mult=2.0, attr={"mood": "calm"})
            y = pkg.sym.Variable("y")
            z = pkg.sym.sum(x * y, axis=1, name="dotp")
            parts = pkg.sym.SliceChannel(x, num_outputs=2, name="sc")
            return x, pkg.sym.Group([z, parts[1], y]), parts
    for pkg in (jmx, tmx):
        x, g, parts = build(pkg)
        assert x.list_attr() == {"lr_mult": "2.0", "mood": "calm"}
        assert len(parts) == 2 and parts.list_outputs() == [
            "sc_output0", "sc_output1"]
    (_, jg, jparts), (_, tg, tparts) = build(jmx), build(tmx)
    assert tg.list_outputs() == jg.list_outputs() == [
        "dotp_output", "sc_output1", "y"]
    assert tg.get_internals().list_outputs() == \
        jg.get_internals().list_outputs()
    internals = tg.get_internals()
    assert internals["elemwise_mul0_output"].list_outputs() == [
        "elemwise_mul0_output"]
    assert tg[1].list_outputs() == ["sc_output1"]
    assert [s.list_outputs()[0] for s in tparts] == ["sc_output0",
                                                     "sc_output1"]
    rs = np.random.RandomState(1)
    vals = {"x": rs.randn(3, 4).astype(np.float32),
            "y": rs.randn(3, 4).astype(np.float32)}
    want = _bind_run(jmx, jg.get_internals(), vals, grad=False)
    got = _bind_run(tmx, internals, vals, grad=False)
    agree([(g, "") for g in got], [(w, "") for w in want], REL, "internals")


def test_variadic_and_multi_output_ops_through_module():
    """``mx.sym.Concat(a, b, c)`` counts ``num_args``; ``SliceChannel``
    and ``topk(ret_typ='both')`` give several outputs through a bound
    ``Module``, as the reference's."""
    rs = np.random.RandomState(2)
    X = rs.randn(8, 6).astype(np.float32)

    def outputs(pkg):
        data = pkg.sym.Variable("data")
        cat = pkg.sym.Concat(data, data * 2, data + 1, dim=1, name="cat")
        assert cat.attr_dict()["cat"]["num_args"] == "3"
        parts = pkg.sym.SliceChannel(cat, num_outputs=3, name="sc")
        top = pkg.sym.topk(parts[2], k=2, ret_typ="both", name="tk")
        net = pkg.sym.Group([parts[0], top[0], top[1]])
        mod = pkg.mod.Module(net, data_names=("data",), label_names=None,
                             context=pkg.cpu())
        mod.bind([("data", X.shape)], for_training=False)
        mod.init_params()
        mod.forward(pkg.io.DataBatch([pkg.nd.array(X, ctx=pkg.cpu())]),
                    is_train=False)
        return [(o.asnumpy(), o.dtype.name) for o in mod.get_outputs()]

    want, got = outputs(jmx), outputs(tmx)
    assert len(got) == 3
    agree(got, want, REL, "module outputs")


# ---------------------------------------------------------------------------
# the slice as a whole: the recommender through Module.fit
# ---------------------------------------------------------------------------
def make_ratings(rs, num_users, num_items, n, rank):
    """``examples/recommenders/matrix_fact.py``'s synthetic ratings."""
    U = rs.randn(num_users, rank).astype(np.float32) / np.sqrt(rank)
    V = rs.randn(num_items, rank).astype(np.float32) / np.sqrt(rank)
    users = rs.randint(0, num_users, n)
    items = rs.randint(0, num_items, n)
    r = (U[users] * V[items]).sum(axis=1) + 0.05 * rs.randn(n)
    return (users.astype(np.float32), items.astype(np.float32),
            r.astype(np.float32))


def mf_symbol(pkg, num_users, num_items, factor):
    """The example's graph: two ``Embedding``s, ``*``, ``sum(axis=1)``,
    ``LinearRegressionOutput``."""
    user = pkg.sym.Variable("user")
    item = pkg.sym.Variable("item")
    u = pkg.sym.Embedding(user, input_dim=num_users, output_dim=factor,
                          name="user_embed")
    v = pkg.sym.Embedding(item, input_dim=num_items, output_dim=factor,
                          name="item_embed")
    pred = pkg.sym.sum(u * v, axis=1)
    return pkg.sym.LinearRegressionOutput(pred, name="score")


USERS, ITEMS, FACTOR, BATCH, STEPS = 300, 200, 16, 64, 5


@pytest.fixture
def _classic_path(monkeypatch):
    monkeypatch.setenv("MXNET_MODULE_FUSED", "0")


def _fit(pkg, params, users, items, r):
    it = pkg.io.NDArrayIter({"user": users, "item": items}, r,
                            batch_size=BATCH, label_name="score_label")
    mod = pkg.mod.Module(mf_symbol(pkg, USERS, ITEMS, FACTOR),
                         data_names=("user", "item"),
                         label_names=("score_label",), context=pkg.cpu())
    if pkg is jmx:
        params = {k: jmx.nd.array(v) for k, v in params.items()}
    mod.fit(it, num_epoch=1, optimizer="adam",
            optimizer_params={"learning_rate": 0.01, "wd": 1e-5},
            arg_params=params, eval_metric="rmse", kvstore="local")
    arg, _ = mod.get_params()
    score = dict(mod.score(it, pkg.metric.RMSE()))["rmse"]
    return {k: v.asnumpy() for k, v in arg.items()}, score


def test_recommender_fit_matches_the_reference(_classic_path):
    """Five Adam steps of ``Module.fit`` (batch 64, ``shuffle=False``)
    from the same Normal(0.1) parameters: every parameter within 1e-4 of
    the largest weight (Adam's standing bound, ROADMAP Queue 3), and
    ``Module.score`` with ``RMSE`` within 1e-5."""
    rs = np.random.RandomState(11)
    users, items, r = make_ratings(rs, USERS, ITEMS, STEPS * BATCH, 8)
    params = {"user_embed_weight":
              (0.1 * rs.randn(USERS, FACTOR)).astype(np.float32),
              "item_embed_weight":
              (0.1 * rs.randn(ITEMS, FACTOR)).astype(np.float32)}
    want, want_rmse = _fit(jmx, params, users, items, r)
    got, got_rmse = _fit(tmx, params, users, items, r)
    assert sorted(got) == sorted(want) == sorted(params)
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        assert np.abs(got[name] - w).max() <= 1e-4 * top, name
        assert not np.array_equal(w, params[name]), name   # it moved
    assert abs(got_rmse - want_rmse) <= REL * want_rmse


def test_metrics_create_lists_and_regression_names():
    label = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    pred = np.array([1.5, 1.0, 3.5, 2.0], np.float32)
    for names in (["mse", "rmse", "mae"], "rmse", ["acc", "ce"]):
        got = tmx.metric.create(names)
        want = jmx.metric.create(names)
        assert type(got).__name__ == type(want).__name__
    vals = []
    for pkg in (jmx, tmx):
        m = pkg.metric.create(["mse", "rmse", "mae"])
        with pkg.cpu():
            for _ in range(2):
                m.update([pkg.nd.array(label)], [pkg.nd.array(pred)])
        vals.append(m.get())
    assert vals[1][0] == vals[0][0] == ["mse", "rmse", "mae"]
    np.testing.assert_allclose(vals[1][1], vals[0][1], rtol=1e-6)


@pytest.mark.parametrize("init", ["Normal", "Constant", "Zero", "One"])
def test_initializers_fill_as_the_reference(init):
    kwargs = {"Normal": {"sigma": 0.1}, "Constant": {"value": 0.25}}.get(
        init, {})
    with tmx.cpu():
        w, b = tmx.nd.zeros((300, 16)), tmx.nd.zeros((16,))
        getattr(tmx.init, init)(**kwargs)(tmx.init.InitDesc("fc_weight"), w)
        getattr(tmx.init, init)(**kwargs)(tmx.init.InitDesc("fc_bias"), b)
    w = w.asnumpy()
    assert not b.asnumpy().any()   # a bias is 0 under every initializer
    if init == "Normal":
        assert abs(w.std() - 0.1) < 0.01 and abs(w.mean()) < 0.01
    else:
        np.testing.assert_array_equal(w, {"Constant": 0.25, "Zero": 0.0,
                                          "One": 1.0}[init])
