"""The port's ``Module`` on its default, fused route against the JAX
package's fused ``Module``, and against the port's own classic route;
the device-side metrics, the input stager and the top-level names that
come with it.

The cases mirror the reference's ``tests/test_fused_module.py`` at one
device.  Both packages start from the same numpy parameters and take the
same numpy batches; the reference runs its fused route
(``MXNET_MODULE_FUSED=1``) on its plain XLA lowerings (``MXNET_PALLAS=0``),
both set while this module runs and restored after it.  The port's
classic route is taken with ``MXNET_MODULE_FUSED=0`` or, where a test
runs both packages side by side, with ``_fused_disabled`` as the
reference's own tests do.  Tolerances: fp32 1e-5 x max|ref|, Adam 1e-4
x max|ref|, bf16 outputs 2e-2 x max|ref| and parameter deltas 5e-2 x
max|delta ref|; the port's two routes bit-equal in fp32; device metrics'
counts exact and sums within 1e-6 of the host update's.
"""
import ast
import os
import threading
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.io.stager import DeviceStager

PKGS = (jmx, tmx)
B, DIM, CLASSES, STEPS = 8, 12, 4, 4
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}
ADAM = {"learning_rate": 0.01}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module, the reference on its fused
    route and plain lowerings; restored when the module ends."""
    n = torch.get_num_threads()
    saved = {k: os.environ.get(k) for k in ("MXNET_PALLAS",
                                            "MXNET_MODULE_FUSED")}
    torch.set_num_threads(1)
    os.environ.update(MXNET_PALLAS="0", MXNET_MODULE_FUSED="1")
    yield
    torch.set_num_threads(n)
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _ctx(pkg):
    return pkg.cpu()


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    fc1 = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = pkg.sym.Activation(fc1, act_type="relu")
    fc2 = pkg.sym.FullyConnected(act, num_hidden=CLASSES, name="fc2")
    return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def _convnet(pkg):
    data = pkg.sym.Variable("data")
    conv = pkg.sym.Convolution(data, kernel=(3, 3), num_filter=4,
                               pad=(1, 1), name="conv1")
    bn = pkg.sym.BatchNorm(conv, name="bn1")
    act = pkg.sym.Activation(bn, act_type="relu")
    pool = pkg.sym.Pooling(act, kernel=(2, 2), stride=(2, 2),
                           pool_type="max")
    flat = pkg.sym.Flatten(pool)
    fc = pkg.sym.FullyConnected(flat, num_hidden=CLASSES, name="fc1")
    return pkg.sym.SoftmaxOutput(fc, name="softmax")


NETS = {"mlp": (_mlp, (B, DIM)), "convnet": (_convnet, (B, 3, 8, 8))}


def _start(kind="mlp", seed=7):
    """Parameters and moving statistics in numpy (BatchNorm's betas near
    2.5, so no ReLU input sits within rounding of its kink) and STEPS + 1
    batches."""
    build, shape = NETS[kind]
    net = build(tmx)
    arg_shapes, _, aux_shapes = net.infer_shape(data=shape,
                                                softmax_label=(B,))
    rs = np.random.RandomState(seed)
    params = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        lo, hi = ((2.0, 3.0) if n.endswith("beta") else
                  (0.5, 1.5) if n.endswith("gamma") else (-0.1, 0.1))
        params[n] = rs.uniform(lo, hi, s).astype(np.float32)
    aux = {n: (rs.uniform(-0.1, 0.1, s) if n.endswith("mean")
               else rs.uniform(0.5, 1.5, s)).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    X = rs.uniform(-1, 1, (STEPS + 1,) + shape).astype(np.float32)
    y = rs.randint(0, CLASSES, (STEPS + 1, B)).astype(np.float32)
    return params, aux, X, y


def _batch(pkg, X, y, i):
    return pkg.io.DataBatch([pkg.nd.array(X[i], ctx=_ctx(pkg))],
                            [pkg.nd.array(y[i], ctx=_ctx(pkg))])


def _module(pkg, kind="mlp", start=None, optimizer="sgd", opt_params=SGD,
            fused=True, compute_dtype=None):
    build, shape = NETS[kind]
    params, aux, _, _ = start or _start(kind)
    mod = pkg.mod.Module(build(pkg), context=_ctx(pkg),
                         compute_dtype=compute_dtype)
    if not fused:
        mod._fused_disabled = True
    mod.bind([("data", shape)], [("softmax_label", (B,))])
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=_ctx(pkg))
                                for k, v in params.items()},
                    aux_params={k: pkg.nd.array(v, ctx=_ctx(pkg))
                                for k, v in aux.items()})
    mod.init_optimizer(kvstore="local", optimizer=optimizer,
                       optimizer_params=dict(opt_params))
    assert (mod._fused is not None) == fused, (pkg.__name__, fused)
    return mod


def _steps(pkg, mod, X, y, steps=STEPS, start=0):
    outs = []
    for i in range(start, start + steps):
        mod.forward_backward(_batch(pkg, X, y, i))
        mod.update()
        outs.append(_np(mod.get_outputs()[0]))
    return outs


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    if hasattr(v, "asnumpy"):
        return np.asarray(v.asnumpy(), dtype=np.float32)
    return np.asarray(v, dtype=np.float32)


def _params(mod):
    arg, aux = mod.get_params()
    return ({k: _np(v) for k, v in arg.items()},
            {k: _np(v) for k, v in aux.items()})


def _states(mod):
    """``{index: [arrays]}`` of the route's optimizer state."""
    trainer = mod._one_program_trainer()
    states = (trainer.get_updater_states() if trainer is not None
              else mod._updater.states)
    return {i: [_np(x) for x in (s if isinstance(s, tuple) else (s,))]
            for i, s in states.items() if s is not None}


def _rel_close(got, want, tol, what):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        bound = tol * max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= bound, "%s %s: %.3e past %.3e" % (what, k, err, bound)


def _states_close(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    for i in want:
        _rel_close(dict(enumerate(got[i])), dict(enumerate(want[i])), tol,
                   "%s %d" % (what, i))


@pytest.fixture(scope="module")
def sgd_runs():
    """STEPS fused SGD steps of the MLP in each package, from one start:
    ``{pkg: (module, outputs)}``."""
    start = _start("mlp")
    runs = {}
    for pkg in PKGS:
        mod = _module(pkg, start=start)
        runs[pkg] = mod, _steps(pkg, mod, start[2], start[3])
    return start, runs


# ---------------------------------------------------------------------------
# parity with the reference's fused Module
# ---------------------------------------------------------------------------
def test_fused_sgd_matches_reference(sgd_runs):
    _, runs = sgd_runs
    (jmod, jouts), (tmod, touts) = runs[jmx], runs[tmx]
    _rel_close(dict(enumerate(touts)), dict(enumerate(jouts)), 1e-5,
               "probabilities of step")
    _rel_close(_params(tmod)[0], _params(jmod)[0], 1e-5, "parameter")
    _states_close(_states(tmod), _states(jmod), 1e-5, "momentum")
    assert tmod._optimizer._index_update_count == \
        jmod._optimizer._index_update_count


@pytest.mark.parametrize("optimizer,opt_params,tol", [
    ("sgd", {"learning_rate": 0.05}, 1e-5),
    ("adam", ADAM, 1e-4)], ids=["sgd", "adam"])
def test_fused_optimizers_match_reference(optimizer, opt_params, tol):
    start = _start("mlp", seed=11)
    got = {}
    for pkg in PKGS:
        mod = _module(pkg, start=start, optimizer=optimizer,
                      opt_params=opt_params)
        _steps(pkg, mod, start[2], start[3])
        got[pkg] = _params(mod)[0], _states(mod)
    _rel_close(got[tmx][0], got[jmx][0], tol, optimizer + " parameter")
    _states_close(got[tmx][1], got[jmx][1], tol, optimizer + " state")


def test_fused_batchnorm_moving_statistics_match_reference():
    start = _start("convnet", seed=5)
    got = {}
    for pkg in PKGS:
        mod = _module(pkg, "convnet", start, opt_params={
            "learning_rate": 0.1})
        _steps(pkg, mod, start[2], start[3])
        got[pkg] = _params(mod)
    _rel_close(got[tmx][0], got[jmx][0], 1e-5, "parameter")
    _rel_close(got[tmx][1], got[jmx][1], 1e-5, "moving statistic")
    for k, v in got[tmx][1].items():
        assert not np.array_equal(v, start[1][k]), k


def test_fused_bf16_matches_reference():
    """One bf16 step of the MLP (fc1's biases at 1, away from ReLU's
    kink, as ``tests/test_torch_parallel.py`` holds the trainer): the
    outputs within 2e-2 x max|ref| of the reference's fused step, the
    parameter deltas within 5e-2 x max|delta ref|, the master arrays
    float32."""
    params, aux, X, y = _start("mlp", seed=3)
    params["fc1_bias"] = np.ones_like(params["fc1_bias"])
    got = {}
    for pkg in PKGS:
        mod = _module(pkg, "mlp", (params, aux, X, y),
                      compute_dtype="bfloat16")
        got[pkg] = _steps(pkg, mod, X, y, steps=1)[0], _params(mod)[0]
    _rel_close({0: got[tmx][0]}, {0: got[jmx][0]}, 2e-2,
               "bf16 probabilities")
    _rel_close({k: v - params[k] for k, v in got[tmx][1].items()},
               {k: v - params[k] for k, v in got[jmx][1].items()},
               5e-2, "bf16 parameter delta")
    assert all(v.dtype == torch.float32 for v in mod._fused.params.values())


def test_fused_bf16_moving_statistics_equal_the_classic_route():
    """Two bf16 steps of the BatchNorm convnet on the port's two routes:
    one cast rule (the ``Executor``'s), so the outputs, parameters and
    moving statistics are equal to the bit."""
    start = _start("convnet", seed=3)
    got = {}
    for fused in (True, False):
        mod = _module(tmx, "convnet", start, fused=fused,
                      compute_dtype="bfloat16")
        got[fused] = _steps(tmx, mod, start[2], start[3], steps=2), \
            _params(mod)
    for i in range(2):
        np.testing.assert_array_equal(got[True][0][i], got[False][0][i])
    for i in (0, 1):
        for k, v in got[False][1][i].items():
            np.testing.assert_array_equal(got[True][1][i][k], v, err_msg=k)


def test_fused_route_is_bit_equal_to_the_classic_route():
    """fp32 SGD with momentum and wd, three steps: the same parameters,
    outputs and momenta to the bit."""
    start = _start("mlp", seed=2)
    got = {}
    for fused in (True, False):
        mod = _module(tmx, start=start, fused=fused)
        outs = _steps(tmx, mod, start[2], start[3], steps=3)
        got[fused] = outs, _params(mod)[0], _states(mod)
    for i in range(3):
        np.testing.assert_array_equal(got[True][0][i], got[False][0][i])
    for k, v in got[False][1].items():
        np.testing.assert_array_equal(got[True][1][k], v, err_msg=k)
    for i, s in got[False][2].items():
        np.testing.assert_array_equal(got[True][2][i][0], s[0])


def test_fused_fit_and_score():
    """``fit`` takes the fused route by default, learns a separable
    task, and ``score`` reads the trainer's inference forward."""
    rng = np.random.RandomState(0)
    w = rng.randn(DIM, CLASSES)
    x = rng.uniform(-1, 1, (256, DIM)).astype("float32")
    y = np.argmax(x @ w, axis=1).astype("float32")
    it = tmx.io.NDArrayIter(x, y, batch_size=32, shuffle=True)
    val = tmx.io.NDArrayIter(x, y, batch_size=32)
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    mod.fit(it, eval_data=val, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
            num_epoch=8)
    assert mod._one_program_trainer() is mod._fused is not None
    acc = mod.score(val, "acc")[0][1]
    assert acc > 0.8, "fused fit failed to learn (acc=%.3f)" % acc


def test_building_the_trainer_draws_nothing():
    """The fused trainer starts from the module's own parameters and
    moving statistics: building it moves neither the port's host
    generator nor numpy's."""
    params, aux, _, _ = _start("convnet", seed=9)
    mod = tmx.mod.Module(_convnet(tmx), context=tmx.cpu())
    mod.bind([("data", (B, 3, 8, 8))], [("softmax_label", (B,))])
    mod.init_params(arg_params=params, aux_params=aux)
    gen = tmx.random.generator().get_state().clone()
    npst = np.random.get_state()[1].copy()
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SGD))
    assert torch.equal(gen, tmx.random.generator().get_state())
    assert np.array_equal(npst, np.random.get_state()[1])
    tr = mod._one_program_trainer()
    for k, v in params.items():
        np.testing.assert_array_equal(_np(tr.params[k]), v)
    for k, v in aux.items():
        np.testing.assert_array_equal(_np(tr.aux[k]), v)


# ---------------------------------------------------------------------------
# leaving and returning
# ---------------------------------------------------------------------------
def test_fused_defuse_continues_training():
    start = _start("mlp", seed=1)
    _, _, X, y = start
    for pkg in PKGS:
        mod = _module(pkg, start=start)
        _steps(pkg, mod, X, y, steps=1)
        mod.forward(_batch(pkg, X, y, 1), is_train=True)
        assert mod._fused is None and mod._fused_disabled
        mod.backward()
        mod.update()
        for v in _params(mod)[0].values():
            assert np.isfinite(v).all()


def test_fused_defuse_preserves_update_counts():
    """Adam's bias correction does not restart after a de-fuse: the
    update counts go over to the host updater, and the state with
    them."""
    start = _start("mlp", seed=6)
    _, _, X, y = start
    for pkg in PKGS:
        mod = _module(pkg, start=start, optimizer="adam", opt_params=ADAM)
        _steps(pkg, mod, X, y, steps=3)
        before = _states(mod)
        mod.forward(_batch(pkg, X, y, 3), is_train=True)
        assert mod._fused is None
        counts = mod._optimizer._index_update_count
        assert counts and all(c == 3 for c in counts.values()), counts
        _states_close(_states(mod), before, 0.0, "state after de-fuse")
        mod.backward()
        mod.update()
        assert mod._optimizer._index_update_count[0] == 4


def test_fused_eval_forward_keeps_pending_batch():
    start = _start("mlp", seed=7)
    _, _, X, y = start
    for pkg in PKGS:
        mod = _module(pkg, start=start, opt_params={"learning_rate": 0.1})
        before = _params(mod)[0]
        mod.forward_backward(_batch(pkg, X, y, 0))
        mod.forward(_batch(pkg, X, y, 1), is_train=False)
        assert mod._fused is not None
        mod.update()
        after = _params(mod)[0]
        assert any(not np.allclose(before[k], after[k]) for k in before), \
            pkg.__name__


def test_refuse_after_transient_defuse():
    """An explicit forward/backward/update leaves the fused route for a
    while; the next ``forward_backward`` returns to the same trainer
    with the momenta and update counts carried over, and the whole
    sequence matches the reference's and the port's classic route."""
    start = _start("mlp", seed=3)
    _, _, X, y = start
    got = {}
    for pkg, fused in ((jmx, True), (tmx, True), (tmx, False)):
        mod = _module(pkg, start=start, fused=fused)
        trainer0 = mod._fused
        _steps(pkg, mod, X, y, steps=2)
        mod.forward(_batch(pkg, X, y, 2), is_train=True)
        mod.backward()
        mod.update()
        if fused:
            assert mod._fused is None and mod._fused_stash is trainer0
            held = _states(mod)
        _steps(pkg, mod, X, y, steps=2, start=3)
        if fused:
            assert mod._fused is trainer0, "re-fuse rebuilt the trainer"
            assert set(mod._optimizer._index_update_count.values()) == {5}
            assert held.keys() == _states(mod).keys()
        got[pkg, fused] = _params(mod)[0], _states(mod)
    for other in ((jmx, True), (tmx, False)):
        _rel_close(got[tmx, True][0], got[other][0], 1e-5,
                   "parameter vs %s" % (other,))
        _states_close(got[tmx, True][1], got[other][1], 1e-5,
                      "momentum vs %s" % (other,))


def test_fused_respects_env_kill_switch(monkeypatch):
    monkeypatch.setenv("MXNET_MODULE_FUSED", "0")
    for pkg in PKGS:
        mod = pkg.mod.Module(_mlp(pkg), context=_ctx(pkg))
        mod.bind([("data", (B, DIM))], [("softmax_label", (B,))])
        mod.init_params()
        mod.init_optimizer()
        assert mod._fused is None and mod._one_program_trainer() is None


def test_fused_eval_respects_bound_input_order():
    """The fused forward maps ``batch.data`` by the bound (iterator)
    order, not the constructor's ``data_names``: two inputs of one shape
    would swap."""
    for pkg in PKGS:
        a, b = pkg.sym.Variable("a"), pkg.sym.Variable("b")
        out = pkg.sym.LinearRegressionOutput(2.0 * a - b, name="o")
        mod = pkg.mod.Module(out, context=_ctx(pkg), data_names=("a", "b"),
                             label_names=("o_label",))
        mod.bind(data_shapes=[("b", (4, 1)), ("a", (4, 1))],
                 label_shapes=[("o_label", (4, 1))])
        mod.init_params()
        mod.init_optimizer(optimizer="sgd")
        assert mod._fused is not None
        av = np.arange(4, dtype=np.float32).reshape(4, 1)
        bv = np.full((4, 1), 10.0, np.float32)
        nd = lambda v: pkg.nd.array(v, ctx=_ctx(pkg))  # noqa: E731
        mod.forward(pkg.io.DataBatch(data=[nd(bv), nd(av)],
                                     label=[nd(np.zeros((4, 1), "f4"))]),
                    is_train=False)
        np.testing.assert_allclose(_np(mod.get_outputs()[0]), 2.0 * av - bv,
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_optimizer_states_and_checkpoints_move_both_ways(sgd_runs, tmp_path):
    """``.states`` files and checkpoints between the two packages' fused
    modules, in both directions, and between the port's two routes."""
    start, runs = sgd_runs
    written = {}
    for pkg in PKGS:
        prefix = str(tmp_path / pkg.__name__)
        runs[pkg][0].save_checkpoint(prefix, 1, save_optimizer_states=True)
        written[pkg] = prefix
    jmx.nd.waitall()
    for src, dst in ((tmx, jmx), (jmx, tmx)):
        want_args = _params(runs[src][0])[0]
        want_states = _states(runs[src][0])
        mod = dst.mod.Module.load(written[src], 1,
                                  load_optimizer_states=True,
                                  context=_ctx(dst))
        mod.bind([("data", (B, DIM))], [("softmax_label", (B,))])
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SGD))
        assert mod._fused is not None
        _rel_close(_params(mod)[0], want_args, 1e-7, "parameter from file")
        _states_close(_states(mod), want_states, 1e-7, "state from file")
        assert mod._optimizer.num_update == STEPS
    # the port's classic route reads the fused file, and back
    fname = written[tmx] + "-0001.states"
    classic = _module(tmx, start=start, fused=False)
    classic.load_optimizer_states(fname)
    _states_close({i: [_np(s)] for i, s in classic._updater.states.items()},
                  _states(runs[tmx][0]), 0.0, "classic from fused")
    back = str(tmp_path / "classic.states")
    classic.save_optimizer_states(back)
    fused = _module(tmx, start=start)
    fused.load_optimizer_states(back)
    _states_close(_states(fused), _states(runs[tmx][0]), 0.0,
                  "fused from classic")
    assert fused._optimizer._index_update_count == \
        runs[tmx][0]._optimizer._index_update_count


def test_force_init_restarts_from_the_trained_parameters():
    """``init_optimizer(force_init=True)`` on the fused route builds a
    new trainer from the parameters the old one trained, not from the
    executor's stale start."""
    start = _start("mlp", seed=10)
    mod = _module(tmx, start=start)
    _steps(tmx, mod, start[2], start[3], steps=2)
    trained = _params(mod)[0]
    old = mod._fused
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SGD),
                       force_init=True)
    assert mod._fused is not None and mod._fused is not old
    for k, v in trained.items():
        np.testing.assert_array_equal(_np(mod._fused.params[k]), v)


def test_fused_reshape_carries_the_state_over():
    start = _start("mlp", seed=8)
    _, _, X, y = start
    mod = _module(tmx, start=start)
    _steps(tmx, mod, X, y, steps=1)
    held = _states(mod)
    mod.reshape([("data", (4, DIM))], [("softmax_label", (4,))])
    assert mod._fused is not None and mod._fused._arg_shapes["data"] == \
        (4, DIM)
    _states_close(_states(mod), held, 0.0, "state after reshape")
    mod.forward_backward(tmx.io.DataBatch(
        [tmx.nd.array(X[1][:4], ctx=tmx.cpu())],
        [tmx.nd.array(y[1][:4], ctx=tmx.cpu())]))
    mod.update()
    assert all(np.isfinite(v).all() for v in _params(mod)[0].values())


# ---------------------------------------------------------------------------
# bucketing on the fused route
# ---------------------------------------------------------------------------
def _bucket_sym_gen(pkg):
    def sym_gen(key):
        data = pkg.sym.Variable("data")
        pooled = pkg.sym.sum(data, axis=1)
        fc = pkg.sym.FullyConnected(pooled, num_hidden=CLASSES, name="fc1")
        return (pkg.sym.SoftmaxOutput(fc, name="softmax"), ("data",),
                ("softmax_label",))
    return sym_gen


BUCKET_KEYS = [4, 8, 4, 12, 8, 4]


def _bucket_batches(pkg, seed=5, dim=6):
    rng = np.random.RandomState(seed)
    out = []
    for key in BUCKET_KEYS:
        x = rng.uniform(-1, 1, (B, key, dim)).astype("float32")
        y = rng.randint(0, CLASSES, (B,)).astype("float32")
        out.append(pkg.io.DataBatch(
            data=[pkg.nd.array(x, ctx=_ctx(pkg))],
            label=[pkg.nd.array(y, ctx=_ctx(pkg))], bucket_key=key,
            provide_data=[pkg.io.DataDesc("data", (B, key, dim))],
            provide_label=[pkg.io.DataDesc("softmax_label", (B,))]))
    return out


def _bucketing(pkg, fused=True):
    mod = pkg.mod.BucketingModule(_bucket_sym_gen(pkg), default_bucket_key=8,
                                  context=_ctx(pkg))
    batches = _bucket_batches(pkg)
    mod.bind(data_shapes=batches[1].provide_data,
             label_shapes=batches[1].provide_label)
    rng = np.random.RandomState(11)
    mod.init_params(arg_params={
        "fc1_weight": pkg.nd.array(rng.uniform(-.1, .1, (CLASSES, 6))
                                   .astype("float32"), ctx=_ctx(pkg)),
        "fc1_bias": pkg.nd.array(np.zeros(CLASSES, "float32"),
                                 ctx=_ctx(pkg))}, aux_params={})
    if not fused:
        mod._buckets[8]._fused_disabled = True
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params=dict(SGD))
    return mod, batches


def test_bucketing_fused_parity():
    """Fused buckets (one trainer a bucket over one shared state) match
    the reference's fused buckets and the port's classic buckets."""
    got = {}
    for pkg, fused in ((jmx, True), (tmx, True), (tmx, False)):
        mod, batches = _bucketing(pkg, fused)
        for b in batches:
            mod.forward_backward(b)
            mod.update()
        if fused:
            trainers = [m._fused for m in mod._buckets.values()]
            assert len(trainers) == 3 and None not in trainers
            assert all(t._st is trainers[0]._st for t in trainers)
        else:
            assert all(m._fused is None for m in mod._buckets.values())
        got[pkg, fused] = {k: _np(v) for k, v in mod.get_params()[0].items()}
    _rel_close(got[tmx, True], got[jmx, True], 1e-5, "vs reference")
    _rel_close(got[tmx, True], got[tmx, False], 1e-6, "vs classic")


def test_bucketing_fused_defuse_propagates():
    """A monitor installed mid-run takes every bucket off the fused
    route; training goes on from the shared state on the classic
    route, in both packages alike."""
    got = {}
    for pkg in PKGS:
        mod, batches = _bucketing(pkg)
        for b in batches[:4]:
            mod.forward_backward(b)
            mod.update()
        assert mod._curr_module._fused is not None
        mod.install_monitor(pkg.monitor.Monitor(1, lambda x: x))
        assert all(m._fused is None for m in mod._buckets.values())
        for b in batches[4:]:
            mod.forward_backward(b)
            mod.update()
        got[pkg] = {k: _np(v) for k, v in mod.get_params()[0].items()}
        assert all(np.isfinite(v).all() for v in got[pkg].values())
    _rel_close(got[tmx], got[jmx], 1e-5, "after the de-fuse")


# ---------------------------------------------------------------------------
# device-side metrics
# ---------------------------------------------------------------------------
def _metric_inputs(rs, name):
    probs = rs.rand(B, CLASSES).astype("f4") + 0.05
    probs /= probs.sum(1, keepdims=True)
    label = rs.randint(0, CLASSES, B).astype("f4")
    nd = lambda v: tmx.nd.array(v, ctx=tmx.cpu())  # noqa: E731
    if name in ("mae", "mse", "rmse"):
        return [nd(label)], [nd(probs[:, 0] * 3)]
    if name == "perplexity":
        seq = rs.rand(B, 3, CLASSES).astype("f4") + 0.05
        seq /= seq.sum(-1, keepdims=True)
        return [nd(rs.randint(0, CLASSES, (B, 3)).astype("f4"))], [nd(seq)]
    return [nd(label), nd(label[::-1].copy())], [nd(probs), nd(probs)]


METRICS = {"acc": lambda: tmx.metric.Accuracy(),
           "top_k": lambda: tmx.metric.TopKAccuracy(top_k=2),
           "perplexity": lambda: tmx.metric.Perplexity(ignore_label=0),
           "ce": lambda: tmx.metric.CrossEntropy(),
           "mae": lambda: tmx.metric.MAE(), "mse": lambda: tmx.metric.MSE(),
           "rmse": lambda: tmx.metric.RMSE(),
           "composite": lambda: tmx.metric.create(["acc", "ce"])}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_device_metric_matches_host_update(name):
    rs = np.random.RandomState(sorted(METRICS).index(name))
    dev, host = METRICS[name](), METRICS[name]()
    for _ in range(3):
        labels, preds = _metric_inputs(rs, name)
        assert dev.update_device(labels, preds)
        host.update(labels, preds)
    members = dev.metrics if name == "composite" else [dev]
    assert all(m._dev_state is not None for m in members)
    (_, got), (_, want) = dev.get(), host.get()
    for m, h in zip(members, host.metrics if name == "composite"
                    else [host]):
        assert m.num_inst == h.num_inst and m._dev_state is None
        assert abs(m.sum_metric - float(h.sum_metric)) <= \
            1e-6 * max(abs(float(h.sum_metric)), 1.0), name
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_device_metric_copies_nothing_from_the_host(name, monkeypatch):
    """``update_device`` makes every tensor it needs on the predictions'
    device: a tensor built from host values (``torch.tensor`` and its
    kin) is a copy that a card waits on, once a batch."""
    rs = np.random.RandomState(1)
    labels, preds = _metric_inputs(rs, name)
    metric = METRICS[name]()

    def host_copy(*args, **kwargs):
        raise AssertionError("a tensor copied from host values")

    for fn in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, fn, host_copy)
    for _ in range(2):
        assert metric.update_device(labels, preds)
    monkeypatch.undo()
    assert metric.get()


def test_fused_lm_step_builds_nothing_from_host_values(monkeypatch):
    """A fused step of the transformer LM (Embedding, attention, norms,
    the loss head) and its device metric make every tensor they need on
    the step's device: a tensor built from host values is a copy that a
    card would wait on once a step.  The first step (the program's
    build) runs before the check."""
    L, V = 8, 11
    net = tmx.models.transformer_lm(seq_len=L, num_layers=1, num_hidden=16,
                                    num_heads=2, vocab_size=V)
    rs = np.random.RandomState(2)
    X = rs.randint(0, V, (3, 4, L)).astype("f4")
    batches = [tmx.io.DataBatch([tmx.nd.array(x, ctx=tmx.cpu())],
                                [tmx.nd.array((x + 1) % V, ctx=tmx.cpu())])
               for x in X]
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.bind([("data", (4, L))], [("softmax_label", (4, L))])
    mod.init_params(tmx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SGD))
    assert mod._one_program_trainer() is not None
    metric = tmx.metric.Perplexity(ignore_label=None)

    def host_copy(*args, **kwargs):
        raise AssertionError("a tensor copied from host values")

    for i, batch in enumerate(batches):
        if i == 1:
            for fn in ("tensor", "as_tensor", "from_numpy"):
                monkeypatch.setattr(torch, fn, host_copy)
        mod.forward_backward(batch)
        mod.update()
        assert mod.update_metric(metric, batch.label) is None
    monkeypatch.undo()
    assert metric._dev_state is not None and np.isfinite(metric.get()[1])


@pytest.mark.parametrize("op", ["_plus_scalar", "_mul_scalar",
                                "_maximum_scalar", "Embedding"])
def test_step_ops_fill_on_the_device(op, monkeypatch):
    """The scalar ops' scalar and ``Embedding``'s fill for an id outside
    the table are made on the array's device, not copied from a host
    value; the values stay the reference rules' (an id past the table
    gives NaN)."""
    x = tmx.nd.array([[0.0, 2.0], [5.0, -1.0]], ctx=tmx.cpu())
    table = tmx.nd.array(np.arange(6, dtype="f4").reshape(3, 2),
                         ctx=tmx.cpu())

    def host_copy(*args, **kwargs):
        raise AssertionError("a tensor copied from host values")

    monkeypatch.setattr(torch, "tensor", host_copy)
    if op == "Embedding":
        got = tmx.nd.Embedding(x, table, input_dim=3,
                               output_dim=2).asnumpy()
        want = np.full((2, 2, 2), np.nan, "f4")
        want[0, 0], want[0, 1], want[1, 1] = [0, 1], [4, 5], [4, 5]
    else:
        got = getattr(tmx.nd, op)(x, scalar=1.5).asnumpy()
        fn = {"_plus_scalar": np.add, "_mul_scalar": np.multiply,
              "_maximum_scalar": np.maximum}[op]
        want = fn(x.asnumpy(), np.float32(1.5))
    np.testing.assert_array_equal(got, want)


def test_device_metric_declines_up_front_and_counts_saturate():
    acc = tmx.metric.Accuracy()
    nd = lambda v: tmx.nd.array(v, ctx=tmx.cpu())  # noqa: E731
    # shapes the host update raises on, and host numpy labels: declined
    # before anything is accumulated
    assert not acc.update_device([nd(np.zeros(3, "f4"))],
                                 [nd(np.zeros((4, 2), "f4"))])
    assert not acc.update_device([np.zeros(4, "f4")],
                                 [nd(np.zeros((4, 2), "f4"))])
    comp = tmx.metric.create(["acc", "mae"])
    assert not comp.update_device([nd(np.zeros(4, "f4"))],
                                  [nd(np.zeros((4, 2), "f4"))])
    assert all(m._dev_state is None for m in comp.metrics)
    assert acc._dev_state is None and acc.num_inst == 0
    # the int32 count lane saturates and get() raises
    labels, preds = [nd(np.zeros(4, "f4"))], [nd(np.zeros((4, 2), "f4"))]
    assert acc.update_device(labels, preds)
    s, _ = acc._dev_state
    acc._dev_state = (s, torch.tensor(2 ** 31 - 3, dtype=torch.int32))
    assert acc.update_device(labels, preds)
    assert acc.update_device(labels, preds)
    assert int(acc._dev_state[1]) == 2 ** 31 - 1
    with pytest.raises(OverflowError):
        acc.get()


# ---------------------------------------------------------------------------
# the input stager
# ---------------------------------------------------------------------------
def test_stager_preserves_batch_attrs_and_values():
    rs = np.random.RandomState(0)
    X = rs.rand(80, 5).astype("f4")
    y = rs.randint(0, 4, 80).astype("f4")
    it = tmx.io.NDArrayIter(X, y, batch_size=32)
    stager = DeviceStager(it, "cpu", depth=2)
    for epoch in range(2):
        seen = 0
        for i, batch in enumerate(stager):
            lo = i * 32
            n = min(32, 80 - lo)
            assert batch.pad == 32 - n
            np.testing.assert_array_equal(batch.data[0].asnumpy()[:n],
                                          X[lo:lo + n])
            np.testing.assert_array_equal(batch.label[0].asnumpy()[:n],
                                          y[lo:lo + n])
            seen += 1
        assert seen == 3
        # the end of the data holds until reset()
        with pytest.raises(StopIteration):
            next(stager)
        stager.reset()
    first = next(stager)
    np.testing.assert_array_equal(first.data[0].asnumpy(), X[:32])
    assert stager.provide_data == it.provide_data
    stager.close()
    assert stager._producer is None


def test_stager_surfaces_producer_errors():
    class Exploding:
        def __iter__(self):
            return self

        def __next__(self):
            raise RuntimeError("decode failed")

        def reset(self):
            pass

    stager = DeviceStager(Exploding(), "cpu")
    with pytest.raises(tmx.MXNetError, match="decode failed"):
        next(stager)
    stager.close()


def test_stager_passes_an_epoch_already_on_the_device_through():
    """On a device target an epoch whose first batch already lies there
    passes through as the source's own batches, with no producer thread
    (the ``meta`` device stands in for a card); ``reset()`` decides
    again at the next epoch's first read."""
    class OnDevice:
        def __init__(self):
            self.made, self.n = [], 0

        def __iter__(self):
            return self

        def __next__(self):
            if self.n == 3:
                raise StopIteration
            self.n += 1
            self.made.append(tmx.io.DataBatch(
                [torch.empty(4, 2, device="meta")],
                [torch.empty(4, device="meta")]))
            return self.made[-1]

        def reset(self):
            self.made, self.n = [], 0

    src = OnDevice()
    stager = DeviceStager(src, "meta")
    threads = threading.active_count()
    for _ in range(2):
        got = list(stager)
        assert threading.active_count() == threads
        assert stager._producer is None
        assert len(got) == 3 and all(a is b for a, b in zip(got, src.made))
        with pytest.raises(StopIteration):
            next(stager)
        stager.reset()
    stager.close()


def test_stager_runs_on_a_producer_thread_and_fit_is_unchanged(monkeypatch):
    """``fit`` stages through a producer thread by default, and closes
    it; ``MXNET_IO_STAGE=0`` hands the iterator over as it is; the
    trained parameters are the same to the bit."""
    rs = np.random.RandomState(4)
    X = rs.uniform(-1, 1, (64, DIM)).astype("f4")
    y = rs.randint(0, CLASSES, 64).astype("f4")
    start = _start("mlp", seed=4)
    got, threads = {}, {}
    for stage in ("1", "0"):
        monkeypatch.setenv("MXNET_IO_STAGE", stage)
        it = tmx.io.NDArrayIter(X, y, batch_size=B)
        mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
        seen = []
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params=dict(SGD), arg_params=start[0],
                batch_end_callback=lambda p: seen.append(
                    threading.active_count()))
        got[stage] = _params(mod)[0]
        threads[stage] = max(seen)
        assert (mod._stage_train_data(it) is it) == (stage == "0")
    assert threads["1"] == threads["0"] + 1
    for k, v in got["0"].items():
        np.testing.assert_array_equal(got["1"][k], v, err_msg=k)


# ---------------------------------------------------------------------------
# top-level names
# ---------------------------------------------------------------------------
# names the JAX package exports that the port has not reached yet, by
# ROADMAP.md's Queue 1 item (4: the training plane, 5: serving, 6: data,
# 7: KVStore and parallelism, 8: the control plane and telemetry, 9:
# tooling); the TPU context has no counterpart
STILL_TO_EXPORT = {
    "FeedForward", "operator", "visualization", "viz",  # 4
    "data", "image", "recordio",  # 6
    "KVStore", "create_kvstore", "kv", "kvstore", "kvstore_server",
    "executor_manager",  # 7
    "metrics", "profiler", "tracing", "faultinject",  # 8
    "pallas_ops",  # 9
    "tpu",
}
PORT_ONLY = {"GenerationEngine", "ModelRegistry", "TokenStream", "kernels",
             "transformer_lm"}


def _init_names(pkg):
    """The names a package's ``__init__`` binds by import or
    assignment."""
    tree = ast.parse(open(pkg.__file__).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return names


def test_top_level_names_diff():
    """The reference's top-level names against the port's, as ``dir()``
    gives them.  A submodule counts where either package's ``__init__``
    names it: one that other code imported later appears in ``dir()``
    too, and would make the diff depend on what ran before."""
    named = _init_names(jmx) | _init_names(tmx)

    def exported(pkg):
        return {n for n in dir(pkg) if not n.startswith("_") and (
            not isinstance(getattr(pkg, n), types.ModuleType) or n in named)}

    ref, port = exported(jmx), exported(tmx)
    assert ref - port == STILL_TO_EXPORT
    assert port - ref == PORT_ONLY
    for name in ("Variable", "Monitor", "Optimizer", "NameManager",
                 "executor", "init_registry", "AttrScope", "Prefix",
                 "cpu_pinned", "num_devices"):
        assert hasattr(tmx, name), name
    assert tmx.num_devices("cpu") == 1
    assert tmx.cpu_pinned().device_type == "cpu_pinned"


def test_attr_scope_and_prefix_match_reference():
    got = {}
    for pkg in PKGS:
        with pkg.AttrScope(ctx_group="s1", lr_mult="0.5"):
            data = pkg.sym.Variable("data")
            with pkg.AttrScope(ctx_group="s2"):
                fc = pkg.sym.FullyConnected(data, num_hidden=3, name="fc",
                                            attr={"__wd_mult__": "0"})
        with pkg.name.Prefix("enc_"):
            out = pkg.sym.FullyConnected(fc, num_hidden=2)
        got[pkg] = out.attr_dict(), out.list_arguments()
    assert got[tmx] == got[jmx]
