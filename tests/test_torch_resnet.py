"""The image-classification training path of the port against the JAX
package's: ResNet through ``Module.fit`` with BatchNorm's auxiliary
states, the ``MultiFactorScheduler``, ``TopKAccuracy``, the callbacks,
checkpoints with ``aux:`` keys, and a ``compute_dtype='bfloat16'``
step.

Two tiny ResNets of the reference's builder (the cifar basic-block net,
``get_symbol(num_layers=8, image_shape='3,28,28')``, and the bottleneck
net with the ImageNet stem, ``resnet(units=[1, 1, 1, 1], ...,
image_shape=(3, 64, 64))``) take three ``Module.fit`` steps at batch 4
in both packages from the same parameters, moving statistics and
batches (seed 0), under SGD with momentum 0.9, wd 1e-4 and a
``MultiFactorScheduler`` that decays after the second update.  The
reference takes its steps in float64 (``compute_dtype='float64'``
under ``jax.enable_x64``, over float32 master arrays): the exact
arithmetic the port's float32 steps are held to.  The first step's
probabilities within 1e-5 x max|ref|, the later steps' and every
parameter and moving statistic after the third within 1e-4 x max|ref|
(they follow from parameters held to that bound), and every moving
statistic moved.  ReLU inputs come within 1e-6 of zero in many runs at
these widths (a stage-4 channel of the bottleneck net has 16 values a
batch), and where float32 rounding puts one on the other side, its
whole gradient term passes where the exact step stops it, or the other
way round.  An array past its bound is therefore held to a witness:
the port's same three steps in float64, within the bound of the
reference's.  The port's arithmetic is then the reference's, and the
float32 distance is rounding across a kink.

The reference trains on its fused path
(``MXNET_MODULE_FUSED=1``, one compiled program a step, the same
arithmetic as its executor-group path, and a tenth of its compile
time); the port has the executor-group path only.  The full ResNet-50's
argument, output and auxiliary shapes are held equal without any
compute.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

jres = importlib.import_module("mxnet_tpu.models.resnet")
tres = importlib.import_module("mxnet_tpu_torch.models.resnet")
B, STEPS = 4, 3
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module (its tests make many small
    torch ops, and under several workers a team of threads costs more
    than the op), the reference on its plain XLA lowerings; restored
    when the module ends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_PALLAS", "0")
        yield
    torch.set_num_threads(n)


# net -> (builder of a package's resnet module, image shape, seed)
NETS = {
    "cifar": (lambda m: m.get_symbol(num_classes=10, num_layers=8,
                                     image_shape="3,28,28"), (3, 28, 28), 0),
    "bottleneck": (lambda m: m.resnet(
        units=[1, 1, 1, 1], num_stages=4, filter_list=[8, 16, 32, 64, 128],
        num_classes=10, image_shape=(3, 64, 64)), (3, 64, 64), 0),
}


def _start(net, shape, seed=0):
    """Parameters (He-scaled weights, gamma near 1), moving statistics
    and three batches, in numpy."""
    arg_shapes, _, aux_shapes = net.infer_shape(data=(B,) + shape)
    rs = np.random.RandomState(seed)
    params = {}
    for name, s in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("gamma"):
            params[name] = rs.uniform(0.5, 1.5, s)
        elif name.endswith("beta") or name.endswith("bias"):
            params[name] = rs.uniform(-0.2, 0.2, s)
        else:
            params[name] = rs.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
    aux = {name: (rs.uniform(-0.1, 0.1, s) if name.endswith("mean") else
                  rs.uniform(0.5, 1.5, s))
           for name, s in zip(net.list_auxiliary_states(), aux_shapes)}
    X = rs.uniform(-1, 1, (STEPS * B,) + shape)
    y = rs.randint(0, 10, STEPS * B)
    f32 = {k: v.astype(np.float32) for k, v in params.items()}
    return f32, {k: v.astype(np.float32) for k, v in aux.items()}, \
        X.astype(np.float32), y.astype(np.float32)


def _fit(pkg, kind, params, aux, X, y, fused="0", compute_dtype=None):
    """Three ``Module.fit`` steps: each step's probabilities, then the
    parameters and moving statistics after the last, as numpy."""
    build = NETS[kind][0]
    mod = pkg.mod.Module(build(jres if pkg is jmx else tres),
                         context=pkg.cpu(), compute_dtype=compute_dtype)
    it = pkg.io.NDArrayIter(X, y, batch_size=B)
    if pkg is jmx:
        params = {k: jmx.nd.array(v) for k, v in params.items()}
        aux = {k: jmx.nd.array(v) for k, v in aux.items()}
    outs = []
    opt = dict(OPT, lr_scheduler=pkg.lr_scheduler.MultiFactorScheduler(
        step=[2], factor=0.1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_MODULE_FUSED", fused)
        mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=opt,
                arg_params=params, aux_params=aux, eval_metric="acc",
                batch_end_callback=lambda p: outs.append(
                    mod.get_outputs()[0].asnumpy()))
    arg, auxs = mod.get_params()
    return mod, outs, {k: v.asnumpy() for k, v in arg.items()}, \
        {k: v.asnumpy() for k, v in auxs.items()}


@pytest.fixture(scope="module", params=sorted(NETS))
def fitted(request):
    kind = request.param
    build, shape, seed = NETS[kind]
    params, aux, X, y = _start(build(jres), shape, seed)
    with jax.enable_x64(True):
        want = _fit(jmx, kind, params, aux, X, y, fused="1",
                    compute_dtype="float64")
    got = _fit(tmx, kind, params, aux, X, y)
    witness = _fit(tmx, kind, params, aux, X, y, compute_dtype="float64")
    return kind, (params, aux), got, want, witness


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _within(got, want, witness, tol):
    """``got`` within ``tol`` x max|want| of ``want``; or, past it, the
    port's float64 ``witness`` within that bound."""
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) <= bound or \
        float(np.abs(witness - want).max()) <= bound


def test_three_fit_steps_match_jax_in_outputs_parameters_and_aux(fitted):
    kind, (params, aux), got, want, witness = fitted
    _, gouts, gparams, gaux = got
    _, wouts, wparams, waux = want
    _, xouts, xparams, xaux = witness
    assert len(gouts) == len(wouts) == len(xouts) == STEPS
    assert _rel(gouts[0], wouts[0]) <= 1e-5, kind
    for step, (g, w, x) in enumerate(zip(gouts, wouts, xouts)):
        assert g.shape == w.shape == (B, 10)
        assert _within(g, w, x, 1e-4), (kind, step)
    assert sorted(gparams) == sorted(wparams) == sorted(params)
    assert sorted(gaux) == sorted(waux) == sorted(aux)
    for name, w in list(wparams.items()) + list(waux.items()):
        g = gparams.get(name, gaux.get(name))
        assert g.dtype == w.dtype == np.float32
        assert _within(g, w, xparams.get(name, xaux.get(name)), 1e-4), \
            (kind, name)
    for name, start in aux.items():
        assert not np.array_equal(gaux[name], start), name     # it moved


def test_get_params_returns_both_moving_stats_of_every_batchnorm(fitted):
    kind, _, (mod, _, _, aux), _, _ = fitted
    bns = [n[:-len("_moving_mean")] for n in aux if n.endswith("moving_mean")]
    assert bns and sorted(aux) == sorted(
        [b + "_moving_mean" for b in bns] + [b + "_moving_var" for b in bns])
    assert mod._exec_group.executor.aux_dict.keys() == set(aux)


def test_checkpoints_with_aux_keys_load_in_both_packages(fitted, tmp_path):
    """A checkpoint written by either package loads in the other with
    equal arrays, ``aux:`` keys included; the port's ``Module.load``
    binds and scores with them."""
    kind, _, (tmod, _, targ, taux), (jmod, _, jarg, jaux), _ = fitted
    tmod.save_checkpoint(str(tmp_path / "t"), 3)
    jmod.save_checkpoint(str(tmp_path / "j"), 3)
    jmx.nd.waitall()   # the reference writes its params file async
    _, arg, aux = jmx.model.load_checkpoint(str(tmp_path / "t"), 3)
    _, arg2, aux2 = tmx.mod.load_checkpoint(str(tmp_path / "j"), 3)
    for (a, x), (ra, rx) in (((arg, aux), (targ, taux)),
                             ((arg2, aux2), (jarg, jaux))):
        assert sorted(a) == sorted(ra) and sorted(x) == sorted(rx)
        for k in ra:
            assert np.array_equal(a[k].asnumpy(), ra[k])
        for k in rx:
            assert np.array_equal(x[k].asnumpy(), rx[k])
    mod = tmx.mod.Module.load(str(tmp_path / "j"), 3, context=tmx.cpu())
    shape = NETS[kind][1]
    mod.bind([("data", (B,) + shape)], [("softmax_label", (B,))],
             for_training=False)
    _, loaded = mod.get_params()
    for k, v in jaux.items():
        assert np.array_equal(loaded[k].asnumpy(), v)


def test_full_resnet50_shapes_match_jax_without_compute():
    """``infer_shape`` of the reference's ResNet-50 (3 x 224 x 224, 1000
    classes, batch 32): names and shapes of the arguments, outputs and
    auxiliary states equal, and the JSON graph loads in both packages
    with its auxiliary states."""
    jnet = jres.get_symbol(num_classes=1000, num_layers=50)
    tnet = tmx.models.resnet(num_classes=1000, num_layers=50)
    assert tnet.list_arguments() == jnet.list_arguments()
    assert tnet.list_auxiliary_states() == jnet.list_auxiliary_states()
    assert tnet.list_outputs() == jnet.list_outputs()
    data = (32, 3, 224, 224)
    got, want = tnet.infer_shape(data=data), jnet.infer_shape(data=data)
    assert got == want
    assert len(got[2]) == 2 * 51 and got[1] == [(32, 1000)]
    assert tnet.infer_type(data="float32") == jnet.infer_type(data="float32")
    for src, load in ((tnet, jmx.sym.load_json), (jnet, tmx.sym.load_json)):
        back = load(src.tojson())
        assert back.list_auxiliary_states() == src.list_auxiliary_states()
        assert back.infer_shape(data=data) == want


def test_model_zoo_builders_match_jax():
    for name, kw, shape in (("lenet", {}, (2, 1, 28, 28)),
                            ("mlp", {}, (2, 1, 28, 28)),
                            ("resnet", {"num_layers": 18}, (2, 3, 64, 64)),
                            ("resnet", {"num_layers": 20,
                                        "image_shape": "3,28,28"},
                             (2, 3, 28, 28))):
        t = getattr(tmx.models, name)(num_classes=10, **kw)
        j = getattr(jmx.models, name)(num_classes=10, **kw)
        assert t.list_arguments() == j.list_arguments(), name
        assert t.list_auxiliary_states() == j.list_auxiliary_states(), name
        assert t.infer_shape(data=shape) == j.infer_shape(data=shape), name


# ---------------------------------------------------------------------------
# a compute_dtype='bfloat16' step with auxiliary states
# ---------------------------------------------------------------------------
def _small_bn_net(pkg):
    data = pkg.sym.Variable("data")
    x = pkg.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                            no_bias=True, name="conv0")
    x = pkg.sym.BatchNorm(x, fix_gamma=False, eps=2e-5, name="bn0")
    x = pkg.sym.Activation(x, act_type="relu")
    x = pkg.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
    x = pkg.sym.FullyConnected(pkg.sym.Flatten(x), num_hidden=10,
                               name="fc1")
    return pkg.sym.SoftmaxOutput(x, name="softmax")


def _bf16_step(pkg, params, aux, X, y):
    mod = pkg.mod.Module(_small_bn_net(pkg), context=pkg.cpu(),
                         compute_dtype="bfloat16")
    it = pkg.io.NDArrayIter(X, y, batch_size=B)
    mod.bind(it.provide_data, it.provide_label)
    conv = (lambda d: {k: jmx.nd.array(v) for k, v in d.items()}) \
        if pkg is jmx else (lambda d: d)
    mod.init_params(arg_params=conv(params), aux_params=conv(aux))
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    mod.forward_backward(next(iter(it)))
    mod.update()
    out = mod.get_outputs()[0]
    arg, auxs = mod.get_params()
    return (str(out.dtype), out.asnumpy().astype(np.float32),
            {k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in auxs.items()})


def test_bf16_step_keeps_fp32_aux_and_matches_jax():
    """One ``compute_dtype='bfloat16'`` step through conv, BatchNorm,
    ReLU, pooling and the head: the moving statistics updated from bf16
    batch statistics, written back as float32, within 1e-2 x max|ref| of
    the reference's as the parameters are; the probabilities bf16
    within 2e-2 x max|ref|."""
    net = _small_bn_net(jmx)
    shapes, _, aux_shapes = net.infer_shape(data=(B, 3, 8, 8))
    rs = np.random.RandomState(2)
    params = {n: (rs.uniform(0.5, 1.5, s) if n.endswith("gamma") else
                  rs.randn(*s) * 0.3).astype(np.float32)
              for n, s in zip(net.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    aux = {n: (np.zeros(s) if n.endswith("mean") else np.ones(s)).astype(
        np.float32) for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    X = (rs.randn(B, 3, 8, 8) + 0.5).astype(np.float32)
    y = rs.randint(0, 10, B).astype(np.float32)
    gdt, gout, gparams, gaux = _bf16_step(tmx, params, aux, X, y)
    wdt, wout, wparams, waux = _bf16_step(jmx, params, aux, X, y)
    assert gdt == wdt == "bfloat16"
    assert _rel(gout, wout) <= 2e-2
    for got, want in ((gparams, wparams), (gaux, waux)):
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype == np.float32, k
            assert _rel(got[k], w) <= 1e-2, k
    assert not np.array_equal(gaux["bn0_moving_mean"], aux["bn0_moving_mean"])


# ---------------------------------------------------------------------------
# the training settings: initializer, schedulers, metric, callbacks, data
# ---------------------------------------------------------------------------
def test_initializer_sets_moving_stats_by_name():
    init = tmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                           magnitude=2)
    for name, value in (("bn0_moving_mean", 0.0), ("bn0_moving_var", 1.0),
                        ("x_running_mean", 0.0), ("x_running_var", 1.0),
                        ("y_moving_inv_var", 0.0), ("z_moving_avg", 0.0),
                        ("bn0_gamma", 1.0), ("bn0_beta", 0.0)):
        for pkg in (tmx, jmx):
            arr = pkg.nd.array(np.full(5, 7.0, np.float32), ctx=pkg.cpu())
            init(pkg.init.InitDesc(name), arr) if pkg is tmx else \
                pkg.init.Xavier()(pkg.init.InitDesc(name), arr)
            assert (arr.asnumpy() == value).all(), (name, pkg.__name__)


@pytest.mark.parametrize("make", [
    lambda p: p.FactorScheduler(step=3, factor=0.5, stop_factor_lr=0.01),
    lambda p: p.MultiFactorScheduler(step=[2, 5, 6], factor=0.1)],
    ids=["factor", "multifactor"])
def test_lr_schedulers_match_jax(make):
    got, want = make(tmx.lr_scheduler), make(jmx.lr_scheduler)
    got.base_lr = want.base_lr = 0.4
    assert [got(n) for n in range(12)] == [want(n) for n in range(12)]
    opt = tmx.optimizer.create("sgd", learning_rate=0.4,
                               lr_scheduler=make(tmx.lr_scheduler))
    assert opt.lr_scheduler.base_lr == 0.4


def test_top_k_accuracy_matches_jax():
    rs = np.random.RandomState(3)
    preds, labels = rs.rand(64, 10).astype(np.float32), \
        rs.randint(0, 10, 64).astype(np.float32)
    got = tmx.metric.create("top_k_accuracy", top_k=3)
    want = jmx.metric.create("top_k_accuracy", top_k=3)
    got.update([tmx.nd.array(labels, ctx=tmx.cpu())],
               [tmx.nd.array(preds, ctx=tmx.cpu())])
    want.update([jmx.nd.array(labels)], [jmx.nd.array(preds)])
    assert got.get() == want.get() and got.get()[0] == "top_k_accuracy_3"


def test_fit_with_the_image_classification_settings(tmp_path, caplog):
    """``fit.py``'s settings on the cifar net: ``SyntheticDataIter``, SGD
    with momentum and wd, a ``MultiFactorScheduler``, gaussian Xavier,
    accuracy and top-k, ``Speedometer``, ``log_train_metric`` and both
    checkpoint callbacks; the moving variances start at 1."""
    import logging
    caplog.set_level(logging.INFO)
    tmx.random.seed(0)
    np.random.seed(1)
    with tmx.cpu():
        it = tmx.io.SyntheticDataIter(10, (B, 3, 28, 28), max_iter=4)
    assert it.data.context == tmx.cpu() and it.provide_label[0].shape == (B,)
    mod = tmx.mod.Module(tmx.models.resnet(num_classes=10, num_layers=8,
                                           image_shape="3,28,28"),
                         context=tmx.cpu())
    seen = {}

    def first_aux(param):
        if param.nbatch == 0:
            seen.update({k: v.asnumpy().copy()
                         for k, v in mod.get_params()[1].items()})

    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(tmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    assert all((v.asnumpy() == 1).all() for k, v in
               mod.get_params()[1].items() if k.endswith("moving_var"))
    mod.fit(it, num_epoch=2, optimizer="sgd", optimizer_params=dict(
        OPT, lr_scheduler=tmx.lr_scheduler.MultiFactorScheduler(
            step=[4], factor=0.1)),
        eval_metric=["accuracy", tmx.metric.create("top_k_accuracy",
                                                   top_k=5)],
        batch_end_callback=[tmx.callback.Speedometer(B, 2),
                            tmx.callback.log_train_metric(2), first_aux],
        epoch_end_callback=[tmx.callback.do_checkpoint(
            str(tmp_path / "d")), tmx.callback.module_checkpoint(
            mod, str(tmp_path / "m"))])
    assert "samples/sec" in caplog.text
    assert mod._optimizer.lr_scheduler(mod._optimizer.num_update) == \
        pytest.approx(0.01)
    for prefix in ("d", "m"):
        _, arg, aux = tmx.mod.load_checkpoint(str(tmp_path / prefix), 2)
        assert sorted(aux) == sorted(seen)
        aux = {k: v.asnumpy() for k, v in aux.items()}
    assert any(not np.array_equal(v, seen[k]) for k, v in aux.items())
