"""The port's Module surface for scoring, prediction and resuming against
``mxnet_tpu``'s, on the CPU: ``predict``, ``iter_predict`` and
``score``; ``Module(label_names=None)`` as ``benchmark_score.py`` binds
it; ``reshape``; ``get_input_grads``; ``load_params``; the optimizer's
``.states`` files in both directions (the v2 envelope with the update
counts, numpy arrays only); ``Module.load(load_optimizer_states=True)``,
``load_latest`` and ``module_checkpoint(save_optimizer_states=True)``
with a resumed ``fit(begin_epoch=)``; and three bf16 ``Module.fit``
steps of a tiny ResNet with its moving statistics.

Both packages run the same small graphs from the same numpy parameters
and batches (seed 0), the reference on its classic executor-group path
(``MXNET_MODULE_FUSED=0``, ``MXNET_PALLAS=0``).  fp32 outputs and
gradients within 1e-5 and 1e-4 x max|ref|, parameters after an
optimizer step within 1e-5 x max|ref|; bf16 as
``test_torch_train_bf16.py``: outputs within 2e-2 x max|ref|,
gradients 5e-2, parameters and moving statistics 1e-2.
"""
import importlib
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from test_torch_ops_common import _one_torch_thread  # noqa: F401

B, FEAT, CLASSES = 4, 5, 4
FWD, GRAD, PARAM = 1e-5, 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _classic_plain_path(monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS", "0")
    monkeypatch.setenv("MXNET_MODULE_FUSED", "0")


def _net(pkg, group=False):
    """FullyConnected (no bias: BatchNorm would take its gradient to 0,
    the rounding of a sum that cancels, which Adam then scales up),
    BatchNorm, ReLU, FullyConnected, SoftmaxOutput; with ``group`` the
    hidden ReLU is a second output."""
    data = pkg.sym.Variable("data")
    x = pkg.sym.FullyConnected(data, num_hidden=8, no_bias=True,
                               name="fc1")
    x = pkg.sym.BatchNorm(x, fix_gamma=False, name="bn")
    hidden = pkg.sym.Activation(x, act_type="relu", name="relu")
    x = pkg.sym.FullyConnected(hidden, num_hidden=CLASSES, name="fc2")
    out = pkg.sym.SoftmaxOutput(x, name="softmax")
    return pkg.sym.Group([out, hidden]) if group else out


def _params(seed=0):
    rs = np.random.RandomState(seed)
    arg = {"fc1_weight": rs.randn(8, FEAT),
           "bn_gamma": rs.uniform(0.5, 1.5, 8), "bn_beta": rs.randn(8) * 0.1,
           "fc2_weight": rs.randn(CLASSES, 8) * 0.5,
           "fc2_bias": rs.randn(CLASSES) * 0.1}
    aux = {"bn_moving_mean": rs.randn(8) * 0.1,
           "bn_moving_var": rs.uniform(0.5, 1.5, 8)}
    return ({k: v.astype(np.float32) for k, v in arg.items()},
            {k: v.astype(np.float32) for k, v in aux.items()})


def _data(n=10, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, FEAT).astype(np.float32),
            rs.randint(0, CLASSES, n).astype(np.float32))


def _arr(pkg, v):
    return pkg.nd.array(v, ctx=pkg.cpu())


def _nd(pkg, d):
    return {k: _arr(pkg, v) for k, v in d.items()} if pkg is jmx else d


def _np(x):
    return x.asnumpy().astype(np.float32)


def _bound(pkg, net=None, batch=B, for_training=True, label=True,
           inputs_need_grad=False, label_names=("softmax_label",)):
    mod = pkg.mod.Module(net or _net(pkg), context=pkg.cpu(),
                         label_names=label_names)
    mod.bind([("data", (batch, FEAT))],
             [("softmax_label", (batch,))] if label else None,
             for_training=for_training, inputs_need_grad=inputs_need_grad)
    arg, aux = _params()
    mod.init_params(arg_params=_nd(pkg, arg), aux_params=_nd(pkg, aux))
    return mod


def _within(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= bound, what


def _same(got, want, tol, what=""):
    """Nested NDArray results: the same structure, values within tol."""
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, tol, (what, i))
    else:
        assert isinstance(got, tmx.nd.NDArray), (what, type(got))
        _within(_np(got), _np(want), tol, what)


# ---------------------------------------------------------------------------
# predict, iter_predict, score
# ---------------------------------------------------------------------------
PREDICT = {
    "merged": {}, "num_batch": {"num_batch": 2},
    "unmerged": {"merge_batches": False},
    "always_list": {"always_output_list": True},
}


@pytest.mark.parametrize("group", [False, True], ids=["one", "group"])
@pytest.mark.parametrize("kw", sorted(PREDICT))
def test_predict_matches_jax(kw, group):
    """10 rows in batches of 4, the last padded by 2: the padding rows
    stripped, the batches merged (or not) as the reference's."""
    X, y = _data()
    res = []
    for pkg in (tmx, jmx):
        mod = _bound(pkg, _net(pkg, group))
        res.append(mod.predict(pkg.io.NDArrayIter(X, y, batch_size=B),
                               **PREDICT[kw]))
    got, want = res
    _same(got, want, FWD, kw)


def test_predict_takes_numpy_and_ndarray_inputs_as_jax():
    X, _ = _data(6)
    tmod = _bound(tmx, batch=1, label=False, for_training=False)
    jmod = _bound(jmx, batch=1, label=False, for_training=False)
    want = jmod.predict(X)
    for source in (X, tmx.nd.array(X, ctx=tmx.cpu())):
        got = tmod.predict(source)
        assert got.shape == want.shape == (6, CLASSES)
        _within(_np(got), _np(want), FWD)


def test_iter_predict_matches_jax():
    X, y = _data()
    res = []
    for pkg in (tmx, jmx):
        mod = _bound(pkg, _net(pkg, True))
        res.append([(outs, i, batch.pad) for outs, i, batch in
                    mod.iter_predict(pkg.io.NDArrayIter(X, y,
                                                        batch_size=B))])
    got, want = res
    assert [(i, p) for _, i, p in got] == [(i, p) for _, i, p in want] == \
        [(0, 0), (1, 0), (2, 2)]
    for (g, _, _), (w, _, _) in zip(got, want):
        _same(g, w, FWD)
    assert [o.shape for o in got[-1][0]] == [(2, CLASSES), (2, 8)]


@pytest.mark.parametrize("num_batch", [None, 2])
def test_score_matches_jax(num_batch):
    """``score`` counts the padding rows as the reference does, stops at
    ``num_batch``, and calls ``score_end_callback`` once with the count
    of batches."""
    X, y = _data()
    res = []
    for pkg in (tmx, jmx):
        mod = _bound(pkg)
        seen = []
        res.append((mod.score(pkg.io.NDArrayIter(X, y, batch_size=B),
                              ["acc", "ce"], num_batch=num_batch,
                              score_end_callback=lambda p: seen.append(
                                  p.nbatch)), seen))
    (got, gseen), (want, wseen) = res
    assert gseen == wseen == [num_batch or 3]
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-5)


def test_scoring_without_labels_binds_the_label_as_a_parameter():
    """``Module(label_names=None)`` bound for inference with data shapes
    only, as ``benchmark_score.py`` binds it: ``softmax_label`` becomes
    a parameter in both packages, ``Xavier`` initialises it, and the
    forward ignores it (the head's forward runs on it unchecked)."""
    X, _ = _data(B)
    mods = {}
    for pkg in (tmx, jmx):
        mod = pkg.mod.Module(_net(pkg), context=pkg.cpu(), label_names=None)
        mod.bind(data_shapes=[("data", (B, FEAT))], for_training=False)
        mod.init_params(initializer=pkg.init.Xavier(magnitude=2.0))
        mods[pkg] = mod
    tmod, jmod = mods[tmx], mods[jmx]
    targ, _ = tmod.get_params()
    jarg, _ = jmod.get_params()
    assert sorted(targ) == sorted(jarg) and "softmax_label" in targ
    label = targ["softmax_label"].asnumpy()
    assert label.shape == (B,) and np.abs(label).max() > 0
    # Xavier's uniform bound for a (B,) array: sqrt(3 * 2 / B)
    assert np.abs(label).max() <= np.sqrt(6.0 / B)
    arg, aux = _params()
    for pkg, mod in mods.items():
        mod.set_params(_nd(pkg, dict(arg, softmax_label=np.float32(
            [7, -3, 1e6, np.nan]))), _nd(pkg, aux))
    outs = []
    for pkg, mod in mods.items():
        mod.forward(pkg.io.DataBatch(data=[_arr(pkg, X)], label=[]),
                    is_train=False)
        outs.append(mod.get_outputs()[0])
    _within(_np(outs[0]), _np(outs[1]), FWD)
    assert np.isfinite(_np(outs[0])).all()


# ---------------------------------------------------------------------------
# reshape, get_input_grads, load_params
# ---------------------------------------------------------------------------
def _reshape_run(pkg, sync):
    """Batch 4, then reshaped to 2 and to 6: at each batch size an eval
    forward and a train step; ``sync`` reads ``get_params`` before each
    reshape."""
    X, y = _data(6)
    mod = _bound(pkg)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    outs = []
    for n in (2, 6):
        if sync:
            mod.get_params()
        mod.reshape([("data", (n, FEAT))], [("softmax_label", (n,))])
        assert mod.data_shapes[0].shape == (n, FEAT)
        batch = pkg.io.DataBatch(data=[_arr(pkg, X[:n])],
                                 label=[_arr(pkg, y[:n])])
        mod.forward(batch, is_train=False)
        outs.append(_np(mod.get_outputs()[0]))
        mod.forward_backward(batch)
        mod.update()
        outs.append(_np(mod.get_outputs()[0]))
    arg, aux = mod.get_params()
    return outs, {k: _np(v) for k, v in list(arg.items()) +
                  list(aux.items())}


def test_reshape_to_a_smaller_and_a_larger_batch_matches_jax():
    """A training module reshaped to batch 2 and then 6 keeps its
    parameters, moving statistics and momenta: each forward and train
    step equals the reference's after the same reshapes.  The reference
    rebinds from the host copy of its parameters, which its classic path
    refreshes only in ``get_params``; so it reads them before each
    reshape, and the port gives the same without (a difference by
    design, ROADMAP Queue 3)."""
    (gouts, gparams), (wouts, wparams) = (_reshape_run(tmx, False),
                                          _reshape_run(jmx, True))
    assert [o.shape for o in gouts] == [(2, 4), (2, 4), (6, 4), (6, 4)]
    for g, w in zip(gouts, wouts):
        _within(g, w, FWD)
    assert sorted(gparams) == sorted(wparams)
    for k, w in wparams.items():
        _within(gparams[k], w, PARAM, k)
    souts, sparams = _reshape_run(tmx, True)
    for g, s_ in zip(gouts, souts):
        np.testing.assert_array_equal(g, s_)


def test_get_input_grads_matches_jax():
    X, y = _data(B)
    grads = []
    for pkg in (tmx, jmx):
        mod = _bound(pkg, inputs_need_grad=True)
        mod.forward_backward(pkg.io.DataBatch(data=[_arr(pkg, X)],
                                              label=[_arr(pkg, y)]))
        (g,) = mod.get_input_grads()
        grads.append(_np(g))
    assert grads[0].shape == (B, FEAT)
    _within(grads[0], grads[1], GRAD)
    with pytest.raises(AssertionError):
        _bound(tmx).get_input_grads()


def test_load_params_both_ways(tmp_path):
    """``save_params`` of either package is read by the other's
    ``load_params``: equal arrays, equal outputs."""
    X, y = _data(B)
    arg, aux = _params(3)
    for writer, reader in ((tmx, jmx), (jmx, tmx)):
        src = _bound(writer)
        src.set_params(_nd(writer, arg), _nd(writer, aux))
        fname = str(tmp_path / ("%s.params" % writer.__name__))
        src.save_params(fname)
        jmx.nd.waitall()
        dst = _bound(reader)
        dst.load_params(fname)
        got_arg, got_aux = dst.get_params()
        for k, v in list(arg.items()) + list(aux.items()):
            np.testing.assert_array_equal(
                _np(got_arg.get(k, got_aux.get(k))), v)
        outs = []
        for pkg, mod in ((writer, src), (reader, dst)):
            mod.forward(pkg.io.DataBatch(data=[_arr(pkg, X)],
                                         label=[_arr(pkg, y)]),
                        is_train=False)
            outs.append(_np(mod.get_outputs()[0]))
        _within(outs[1], outs[0], FWD)


# ---------------------------------------------------------------------------
# optimizer states, checkpoints, resume
# ---------------------------------------------------------------------------
OPTS = {"sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3},
        "adam": {"learning_rate": 0.01, "wd": 1e-3}}


def _trained(pkg, opt, steps, batches):
    """A module after ``steps`` updates on the first batches."""
    mod = _bound(pkg)
    mod.init_optimizer(optimizer=opt, optimizer_params=OPTS[opt])
    for batch in batches(pkg)[:steps]:
        mod.forward_backward(batch)
        mod.update()
    return mod


def _batches(pkg):
    X, y = _data(3 * B, seed=5)
    return [pkg.io.DataBatch(data=[_arr(pkg, X[i:i + B])],
                             label=[_arr(pkg, y[i:i + B])])
            for i in range(0, 3 * B, B)]


def _walk_numpy_only(obj):
    if isinstance(obj, dict):
        return all(_walk_numpy_only(k) and _walk_numpy_only(v)
                   for k, v in obj.items())
    if isinstance(obj, (tuple, list)):
        return all(_walk_numpy_only(v) for v in obj)
    return obj is None or isinstance(obj, (int, float, str, np.ndarray,
                                           np.generic))


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_optimizer_states_load_in_the_other_package(opt, writer, tmp_path):
    """Two steps in the writing package, its parameters and ``.states``
    file loaded by the other one (``load_params``,
    ``load_optimizer_states``), then the third step in both: the
    reader's parameters within 1e-5 x max|ref| of the writer's, its
    update counts (Adam's bias correction) restored.  The file is the
    v2 envelope of numpy arrays."""
    w_pkg, r_pkg = (jmx, tmx) if writer == "jax" else (tmx, jmx)
    src = _trained(w_pkg, opt, 2, _batches)
    params = str(tmp_path / "w.params")
    states = str(tmp_path / "w.states")
    src.save_params(params)
    src.save_optimizer_states(states)
    jmx.nd.waitall()
    with open(states, "rb") as f:
        env = pickle.load(f)
    assert env["__updater_format__"] == 2 and env["num_update"] == 2
    assert _walk_numpy_only(env)
    dst = _bound(r_pkg)
    dst.load_params(params)
    dst.init_optimizer(optimizer=opt, optimizer_params=OPTS[opt])
    dst.load_optimizer_states(states)
    assert dst._optimizer.num_update == 2
    assert dict(dst._optimizer._index_update_count) == \
        dict(src._optimizer._index_update_count)
    for pkg, mod in ((w_pkg, src), (r_pkg, dst)):
        mod.forward_backward(_batches(pkg)[2])
        mod.update()
    want, wax = src.get_params()
    got, gax = dst.get_params()
    for k, w in list(want.items()) + list(wax.items()):
        _within(_np(got.get(k, gax.get(k))), _np(w), PARAM, k)


def _fit(mod, X, y, begin, end, callbacks=()):
    it = tmx.io.NDArrayIter(X, y, batch_size=B)
    mod.fit(it, begin_epoch=begin, num_epoch=end, optimizer="sgd",
            optimizer_params=dict(
                OPTS["sgd"], lr_scheduler=tmx.lr_scheduler.FactorScheduler(
                    step=3, factor=0.5)),
            epoch_end_callback=list(callbacks))


def test_resumed_fit_equals_the_uninterrupted_run_bit_for_bit(tmp_path):
    """``module_checkpoint(..., save_optimizer_states=True)`` after epoch
    1, ``Module.load(prefix, 1, load_optimizer_states=True)`` and
    ``fit(begin_epoch=1)``: the same parameters, moving statistics and
    momenta as two epochs in one run, bit for bit (the learning rate
    halves every 3 updates, so the restored update count matters)."""
    X, y = _data(8, seed=7)
    arg, aux = _params()
    whole = tmx.mod.Module(_net(tmx), context=tmx.cpu())
    whole.bind([("data", (B, FEAT))], [("softmax_label", (B,))])
    whole.init_params(arg_params=arg, aux_params=aux)
    _fit(whole, X, y, 0, 2)
    prefix = str(tmp_path / "m")
    first = tmx.mod.Module(_net(tmx), context=tmx.cpu())
    first.bind([("data", (B, FEAT))], [("softmax_label", (B,))])
    first.init_params(arg_params=arg, aux_params=aux)
    _fit(first, X, y, 0, 1, [tmx.callback.module_checkpoint(
        first, prefix, save_optimizer_states=True)])
    with pytest.raises(tmx.MXNetError):
        tmx.mod.Module.load(prefix, 0, load_optimizer_states=True)
    mod, epoch = tmx.mod.Module.load_latest(prefix,
                                            load_optimizer_states=True,
                                            context=tmx.cpu())
    assert epoch == 1 and tmx.mod.Module.load_latest(
        str(tmp_path / "none")) is None
    _fit(mod, X, y, 1, 2)
    assert mod._optimizer.num_update == whole._optimizer.num_update == 4
    want, wax = whole.get_params()
    got, gax = mod.get_params()
    for k, w in list(want.items()) + list(wax.items()):
        np.testing.assert_array_equal(_np(got.get(k, gax.get(k))), _np(w))
    for i, s in whole._updater.states.items():
        np.testing.assert_array_equal(_np(mod._updater.states[i]), _np(s))


def test_model_checkpoint_functions_match_jax(tmp_path):
    """``mx.model.save_checkpoint`` / ``load_checkpoint`` /
    ``latest_checkpoint`` read each other's files."""
    arg, aux = _params()
    for writer, reader in ((tmx, jmx), (jmx, tmx)):
        prefix = str(tmp_path / writer.__name__)
        for epoch in (3, 12):
            writer.model.save_checkpoint(
                prefix, epoch, _net(writer),
                {k: _arr(writer, v) for k, v in arg.items()},
                {k: _arr(writer, v) for k, v in aux.items()})
        jmx.nd.waitall()
        assert reader.model.latest_checkpoint(prefix) == 12
        sym, a, x = reader.model.load_checkpoint(prefix, 12)
        assert sym.list_arguments() == _net(reader).list_arguments()
        for k, v in list(arg.items()) + list(aux.items()):
            np.testing.assert_array_equal(_np(a.get(k, x.get(k))), v)
    assert tmx.model.latest_checkpoint(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# three bf16 Module.fit steps of a tiny ResNet
# ---------------------------------------------------------------------------
OUT_TOL, GRAD_TOL, STEP_TOL = 2e-2, 5e-2, 1e-2
BF16_ROUNDING = 4.0


def _tiny_resnet(pkg):
    """The cifar basic-block ResNet of 8 layers (28 x 28 images): its
    BatchNorms see at least 4 x 7 x 7 values a channel."""
    return pkg.models.resnet(num_classes=10, num_layers=8,
                             image_shape="3,28,28")


def _bf16_fit(pkg, params, aux, X, y, compute_dtype="bfloat16"):
    mod = pkg.mod.Module(_tiny_resnet(pkg), context=pkg.cpu(),
                         compute_dtype=compute_dtype)
    it = pkg.io.NDArrayIter(X, y, batch_size=B)
    outs, grads = [], []

    def on_batch(_):
        ex = (mod._exec_group.execs[0] if pkg is jmx
              else mod._exec_group.executor)
        outs.append((str(mod.get_outputs()[0].dtype),
                     _np(mod.get_outputs()[0])))
        grads.append({k: (str(v.dtype), _np(v))
                      for k, v in ex.grad_dict.items()})

    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params={
        "learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4},
        arg_params=_nd(pkg, params), aux_params=_nd(pkg, aux),
        batch_end_callback=on_batch)
    arg, auxs = mod.get_params()
    return outs, grads, {k: _np(v) for k, v in arg.items()}, \
        {k: _np(v) for k, v in auxs.items()}


@pytest.fixture(scope="module")
def bf16_fitted():
    net = _tiny_resnet(jmx)
    shapes, _, aux_shapes = net.infer_shape(data=(B, 3, 28, 28))
    rs = np.random.RandomState(0)
    params = {}
    for n, s in zip(net.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("gamma"):
            params[n] = rs.uniform(0.5, 1.5, s)
        elif n.endswith("beta"):
            params[n] = rs.uniform(2.5, 3.5, s)
        elif n.endswith("bias"):
            params[n] = rs.uniform(-0.2, 0.2, s)
        else:
            params[n] = rs.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
    aux = {n: (rs.uniform(-0.1, 0.1, s) if n.endswith("mean") else
               rs.uniform(0.5, 1.5, s))
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    aux = {k: v.astype(np.float32) for k, v in aux.items()}
    X = rs.uniform(-1, 1, (3 * B, 3, 28, 28)).astype(np.float32)
    y = rs.randint(0, 10, 3 * B).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_PALLAS", "0")
        mp.setenv("MXNET_MODULE_FUSED", "0")
        want = _bf16_fit(jmx, params, aux, X, y)
        got = _bf16_fit(tmx, params, aux, X, y)
    exact = _bf16_fit(tmx, params, aux, X, y, "float64")
    return params, aux, got, want, exact


def _within_bf16(got, want, exact, tol, what):
    """``got`` within ``tol`` x max|want| of ``want``; or, past it, no
    further from the exact step (the port's float64 one, which
    ``test_torch_resnet.py`` holds to the reference's) than
    BF16_ROUNDING x the reference's own bf16 distance from it: a sum
    that cancels, such as ``bn_data_beta``'s gradient (border terms of
    the first convolution alone), is mostly bf16 rounding."""
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    if err <= bound:
        return
    own = float(np.abs(want.astype(np.float64) - exact).max())
    assert float(np.abs(got.astype(np.float64) - exact).max()) <= \
        BF16_ROUNDING * own, (what, err, bound, own)


def test_bf16_fit_outputs_and_gradients_match_jax(bf16_fitted):
    _, _, (gouts, ggrads, _, _), (wouts, wgrads, _, _), \
        (xouts, xgrads, _, _) = bf16_fitted
    assert len(gouts) == len(wouts) == 3
    for (gdt, g), (wdt, w), (_, x) in zip(gouts, wouts, xouts):
        assert gdt == wdt == "bfloat16"
        _within_bf16(g, w, x, OUT_TOL, "output")
    for g, w, x in zip(ggrads, wgrads, xgrads):
        assert sorted(g) == sorted(w)
        for k, (wdt, wv) in w.items():
            assert g[k][0] == wdt == "float32", k
            _within_bf16(g[k][1], wv, x[k][1], GRAD_TOL, k)


def test_bf16_fit_keeps_fp32_moving_statistics_rounded_through_bf16(
        bf16_fitted):
    """After three steps every parameter and moving statistic is float32
    within 1e-2 x max|ref| of the reference's (or held as the gradients
    are) and has moved; each moving statistic is a bf16 value widened:
    the executor rounds it to bf16 for the op, which updates it in bf16,
    and writes it back as float32 (the reference's ``_cast_aux`` /
    ``_uncast_aux``).  The reference's values here are not bf16 values:
    XLA on the CPU keeps the update in float32 under its default
    ``--xla_allow_excess_precision=true``, and rounds it with the flag
    off."""
    params, aux, (_, _, garg, gaux), (_, _, warg, waux), \
        (_, _, xarg, xaux) = bf16_fitted
    for got, want, exact, start in ((garg, warg, xarg, params),
                                    (gaux, waux, xaux, aux)):
        assert sorted(got) == sorted(want) == sorted(start)
        for k, w in want.items():
            assert got[k].dtype == np.float32
            _within_bf16(got[k], w, exact[k], STEP_TOL, k)
            assert not np.array_equal(got[k], start[k]), k
    for k, v in gaux.items():
        rounded = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(v, rounded, err_msg=k)
