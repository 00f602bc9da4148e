"""The port's ``DataParallelTrainer`` on one device against the JAX
package's on a one-device mesh, and against the port's own classic
``Module``.

Both trainers start from the same injected parameters (and moving
statistics) and take the same batches, all drawn with numpy from fixed
seeds; the reference runs on its plain XLA lowerings
(``MXNET_PALLAS=0``) over ``local_mesh(devices=jax.devices()[:1])``.
The nets are the reference's fused-path test nets
(``tests/test_fused_module.py``): an MLP, and a convnet with BatchNorm
whose betas sit near 2.5, so that no ReLU input comes within rounding of
its kink (a flipped kink moves a whole gradient term, not a rounding).
Tolerances: SGD 2e-5 rtol and 2e-6 atol (the reference's own
fused-vs-classic bound); the convnet 3e-5 and 3e-6; Adam 1e-4 x
max|ref|; one bf16 step's outputs within 2e-2 x max|ref| and its
parameter deltas within 5e-2 x max|delta ref|.
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.parallel.mesh import local_mesh
from mxnet_tpu_torch import flops
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import DataParallelTrainer, spmd

B, CLASSES, STEPS = 8, 4, 4
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}


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


def _mlp(pkg, dropout=False):
    data = pkg.sym.Variable("data")
    fc1 = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = pkg.sym.Activation(fc1, act_type="relu")
    if dropout:
        act = pkg.sym.Dropout(act, p=0.5)
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


NETS = {"mlp": (_mlp, (B, 12)), "convnet": (_convnet, (B, 3, 8, 8))}


def _start(kind, seed=7):
    """Parameters, moving statistics and STEPS batches, in numpy."""
    build, shape = NETS[kind]
    net = build(tmx)
    arg_shapes, _, aux_shapes = net.infer_shape(data=shape,
                                                softmax_label=(B,))
    rs = np.random.RandomState(seed)
    params = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("beta"):
            params[n] = rs.uniform(2.0, 3.0, s)
        elif n.endswith("gamma"):
            params[n] = rs.uniform(0.5, 1.5, s)
        else:
            params[n] = rs.uniform(-0.1, 0.1, s)
    aux = {n: (rs.uniform(-0.1, 0.1, s) if n.endswith("mean")
               else rs.uniform(0.5, 1.5, s))
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    X = rs.uniform(-1, 1, (STEPS,) + shape)
    y = rs.randint(0, CLASSES, (STEPS, B))
    f32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa
    return f32(params), f32(aux), X.astype(np.float32), y.astype(np.float32)


def _opt(pkg, params):
    opt = dict(params)
    if "momentum" in opt:
        opt["lr_scheduler"] = pkg.lr_scheduler.MultiFactorScheduler(
            step=[2], factor=0.1)
    return opt


def _trainer(pkg, kind, params, aux, optimizer="sgd", opt_params=SGD,
             compute_dtype=None, **kw):
    build, shape = NETS[kind]
    if pkg is jmx:
        mesh = local_mesh(devices=jax.devices()[:1])
        params = {k: jmx.nd.array(v) for k, v in params.items()}
        aux = {k: jmx.nd.array(v) for k, v in aux.items()}
    else:
        mesh = tmx.cpu()
    tr = pkg.parallel.DataParallelTrainer(
        build(pkg), data_shapes={"data": shape},
        label_shapes={"softmax_label": (B,)}, mesh=mesh,
        optimizer=optimizer, optimizer_params=_opt(pkg, opt_params),
        compute_dtype=compute_dtype, **kw)
    tr.set_params(params, aux)
    return tr


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(v).astype(np.float32)


def _run(pkg, kind, start, steps=STEPS, **kw):
    """``steps`` trainer steps: each step's probabilities, then the
    parameters, moving statistics and optimizer states after the last,
    as numpy."""
    params, aux, X, y = start
    tr = _trainer(pkg, kind, params, aux, **kw)
    outs = [_host(tr.step(X[i], y[i])[0]) for i in range(steps)]
    arg, auxs = tr.get_params()
    states = tr.get_updater_states()
    return tr, outs, {k: v.asnumpy() for k, v in arg.items()}, \
        {k: v.asnumpy() for k, v in auxs.items()}, \
        {i: [_host(x.asnumpy()) for x in (s if isinstance(s, tuple)
                                          else (s,))]
         for i, s in states.items() if s is not None}


@pytest.fixture(scope="module")
def sgd_runs():
    start = _start("mlp")
    return start, _run(jmx, "mlp", start), _run(tmx, "mlp", start)


def _close(got, want, rtol, atol, what):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg="%s %s" % (what, k))


def _rel_close(got, want, tol, what):
    for k in want:
        bound = tol * max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= bound, "%s %s: %.3e past %.3e" % (what, k, err, bound)


def test_sgd_momentum_wd_scheduler_matches_reference(sgd_runs):
    _, (_, jouts, jarg, _, jst), (_, touts, targ, _, tst) = sgd_runs
    _close(dict(enumerate(touts)), dict(enumerate(jouts)), 2e-5, 2e-6,
           "probabilities of step")
    _close(targ, jarg, 2e-5, 2e-6, "parameter")
    assert sorted(tst) == sorted(jst)
    for i in jst:
        _close(dict(enumerate(tst[i])), dict(enumerate(jst[i])), 2e-5, 2e-6,
               "momentum of %d" % i)


def test_adam_matches_reference():
    start = _start("mlp", seed=11)
    kw = dict(optimizer="adam", opt_params={"learning_rate": 0.01,
                                            "wd": 1e-3})
    _, jouts, jarg, _, jst = _run(jmx, "mlp", start, **kw)
    _, touts, targ, _, tst = _run(tmx, "mlp", start, **kw)
    _rel_close(targ, jarg, 1e-4, "adam parameter")
    for i in jst:
        _rel_close(dict(enumerate(tst[i])), dict(enumerate(jst[i])), 1e-4,
                   "adam moments of %d" % i)


def test_convnet_batchnorm_parameters_and_moving_stats_match_reference():
    start = _start("convnet", seed=5)
    _, jouts, jarg, jaux, _ = _run(jmx, "convnet", start)
    _, touts, targ, taux, _ = _run(tmx, "convnet", start)
    _close(targ, jarg, 3e-5, 3e-6, "parameter")
    _close(taux, jaux, 3e-5, 3e-6, "moving statistic")
    for k, v in taux.items():
        assert not np.array_equal(v, start[1][k]), k


def test_bf16_step_matches_reference():
    params, aux, X, y = _start("mlp", seed=3)
    params["fc1_bias"] = np.ones_like(params["fc1_bias"])   # off the kink
    start = (params, aux, X, y)
    _, jouts, jarg, _, _ = _run(jmx, "mlp", start, steps=1,
                                compute_dtype="bfloat16")
    tr, touts, targ, _, _ = _run(tmx, "mlp", start, steps=1,
                                 compute_dtype="bfloat16")
    _rel_close({0: touts[0]}, {0: jouts[0]}, 2e-2, "bf16 probabilities")
    _rel_close({k: targ[k] - params[k] for k in targ},
               {k: jarg[k] - params[k] for k in jarg}, 5e-2,
               "bf16 parameter delta")
    assert all(v.dtype == torch.float32 for v in tr.params.values())
    assert all(s.dtype == torch.float32 for st in tr.opt_state.values()
               for s in st)


def test_predict_matches_reference(sgd_runs):
    (params, aux, X, y), (jtr, *_), (ttr, *_) = sgd_runs
    batch = {"data": X[0], "softmax_label": y[0]}
    want = np.asarray(jtr.predict(batch)[0])
    np.testing.assert_allclose(_host(ttr.predict(batch)[0]), want,
                               rtol=2e-5, atol=2e-6)
    # labels are not read by the forward: the port fills them with zeros
    np.testing.assert_allclose(_host(ttr.predict(X[0])[0]), want,
                               rtol=2e-5, atol=2e-6)


def _module(params, aux, kind="mlp", opt_params=SGD):
    build, shape = NETS[kind]
    mod = tmx.mod.Module(build(tmx), context=tmx.cpu())
    mod.bind([("data", shape)], [("softmax_label", (B,))])
    mod.init_params(arg_params=params, aux_params=aux)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=_opt(tmx, opt_params))
    return mod


def _module_steps(mod, X, y, steps):
    for i in range(steps):
        mod.forward_backward(tmx.io.DataBatch(
            [tmx.nd.array(X[i], ctx=tmx.cpu())],
            [tmx.nd.array(y[i], ctx=tmx.cpu())]))
        mod.update()


@pytest.mark.parametrize("kind", sorted(NETS))
def test_trainer_matches_the_ports_classic_module(kind, monkeypatch):
    monkeypatch.setenv("MXNET_MODULE_FUSED", "0")   # the classic route
    params, aux, X, y = _start(kind, seed=9)
    _, touts, targ, taux, tst = _run(tmx, kind, (params, aux, X, y))
    mod = _module(params, aux, kind)
    _module_steps(mod, X, y, STEPS)
    arg, auxs = mod.get_params()
    _close(targ, {k: v.asnumpy() for k, v in arg.items()}, 2e-5, 2e-6,
           "parameter")
    _close(taux, {k: v.asnumpy() for k, v in auxs.items()}, 2e-5, 2e-6,
           "moving statistic")
    for i, s in mod._updater.states.items():
        np.testing.assert_allclose(tst[i][0], s.asnumpy(), rtol=2e-5,
                                   atol=2e-6, err_msg="momentum %d" % i)


def test_states_file_moves_between_trainer_and_module(tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("MXNET_MODULE_FUSED", "0")   # the host updater's file
    params, aux, X, y = _start("mlp", seed=4)
    tr = _trainer(tmx, "mlp", params, aux)
    for i in range(2):
        tr.step(X[i], y[i])
    fname = str(tmp_path / "t.states")
    with open(fname, "wb") as f:
        f.write(topt.pack_updater_states(
            {i: s.asnumpy() for i, s in tr.get_updater_states().items()},
            tr.optimizer))
    arg, _ = tr.get_params()
    mod = _module({k: v.asnumpy() for k, v in arg.items()}, aux)
    mod.load_optimizer_states(fname)
    assert mod._optimizer._index_update_count == \
        tr.optimizer._index_update_count
    assert mod._optimizer.num_update == tr.optimizer.num_update == 2
    # one more step on each from the same state: the same parameters
    tr.step(X[2], y[2])
    _module_steps(mod, X[2:], y[2:], 1)
    _close({k: v.asnumpy() for k, v in tr.get_params()[0].items()},
           {k: v.asnumpy() for k, v in mod.get_params()[0].items()},
           2e-5, 2e-6, "parameter after the resumed step")
    # and back: the module's states and counts into a fresh trainer
    states, counts, num_update = topt.unpack_updater_states(
        mod._updater.get_states())
    back = _trainer(tmx, "mlp", params, aux)
    back.set_updater_states(states)
    back.optimizer._index_update_count = dict(counts)
    back.optimizer.num_update = num_update
    assert counts == tr.optimizer._index_update_count and num_update == 3
    for i, s in back.get_updater_states().items():
        np.testing.assert_array_equal(s.asnumpy(), states[i])


def test_none_state_is_skipped():
    params, aux, X, y = _start("mlp")
    tr = _trainer(tmx, "mlp", params, aux, opt_params={"learning_rate": 0.1})
    assert set(tr.get_updater_states().values()) == {None}
    tr.set_updater_states(tr.get_updater_states())
    tr.step(X[0], y[0])
    assert all(st == () for st in tr.opt_state.values())


def test_fixed_params_stay_and_carry_no_state():
    params, aux, X, y = _start("mlp")
    tr = _trainer(tmx, "mlp", params, aux, fixed_params=("fc1_weight",))
    tr.step(X[0], y[0])
    arg, _ = tr.get_params()
    np.testing.assert_array_equal(arg["fc1_weight"].asnumpy(),
                                  params["fc1_weight"])
    assert not np.array_equal(arg["fc2_weight"].asnumpy(),
                              params["fc2_weight"])
    assert sorted(tr.get_updater_states()) == [1, 2, 3]
    assert not tr.params["fc1_weight"].requires_grad


def test_share_state_with_two_shapes_over_one_state():
    params, aux, X, y = _start("mlp")
    tr = _trainer(tmx, "mlp", params, aux)
    half = DataParallelTrainer(
        _mlp(tmx), data_shapes={"data": (B // 2, 12)},
        label_shapes={"softmax_label": (B // 2,)}, mesh=tmx.cpu(),
        optimizer=tr.optimizer, share_state_with=tr)
    assert half.params is tr.params and half.opt_state is tr.opt_state
    before = tr.params["fc1_weight"].detach().clone()
    half.step(X[0][:B // 2], y[0][:B // 2])
    assert not torch.equal(tr.params["fc1_weight"], before)
    tr.step(X[1], y[1])
    assert tr.optimizer.num_update == 2
    with pytest.raises(MXNetError, match="identical param/aux"):
        DataParallelTrainer(_convnet(tmx), data_shapes={"data": (B, 3, 8, 8)},
                            label_shapes={"softmax_label": (B,)},
                            mesh=tmx.cpu(), share_state_with=tr)
    with pytest.raises(MXNetError, match="shape mismatch"):
        DataParallelTrainer(_mlp(tmx), data_shapes={"data": (B, 10)},
                            label_shapes={"softmax_label": (B,)},
                            mesh=tmx.cpu(), share_state_with=tr)


def test_batch_placement_rules(sgd_runs):
    (params, aux, X, y), _, (tr, *_) = sgd_runs
    t = torch.from_numpy(X[0].copy())
    assert tr._shard_batch({"data": t})["data"] is t
    # a host array edited in place is seen at the next call
    x = X[0].copy()
    first = _host(tr.predict(x)[0])
    x[:] = X[1]
    np.testing.assert_array_equal(_host(tr.predict(x)[0]),
                                  _host(tr.predict(X[1].copy())[0]))
    assert not np.array_equal(first, _host(tr.predict(x)[0]))
    # an NDArray on the trainer's device is used as its own tensor, and
    # a write to it in place is seen, before and after
    # clear_placement_cache (the port caches no placement)
    a = tmx.nd.array(X[0], ctx=tmx.cpu())
    assert tr._shard_batch({"data": a})["data"] is a._data
    tr.predict(a)
    a[:] = X[1]
    np.testing.assert_array_equal(_host(tr.predict(a)[0]),
                                  _host(tr.predict(X[1].copy())[0]))
    tr.clear_placement_cache()
    a[:] = X[0]
    np.testing.assert_array_equal(_host(tr.predict(a)[0]), first)


def test_dropout_repeats_its_draws_after_seed():
    params, aux, X, y = _start("mlp")
    runs = []
    for _ in range(2):
        tmx.random.seed(42)
        tr = DataParallelTrainer(
            _mlp(tmx, dropout=True), data_shapes={"data": (B, 12)},
            label_shapes={"softmax_label": (B,)}, mesh=tmx.cpu(),
            optimizer_params=SGD)
        tr.set_params(params)
        runs.append([_host(tr.step(X[i], y[i])[0]) for i in range(2)])
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0][0], runs[0][1])


def test_refusals():
    kw = dict(data_shapes={"data": (B, 12)},
              label_shapes={"softmax_label": (B,)})
    with pytest.raises(MXNetError, match="Queue 1 item 7"):
        DataParallelTrainer(_mlp(tmx), mesh=tmx.cpu(), reduce_mode="bucket",
                            **kw)
    with pytest.raises(MXNetError, match="mesh of 2 devices"):
        DataParallelTrainer(_mlp(tmx), mesh=[tmx.cpu(0), tmx.cpu(1)], **kw)

    class Nag(topt.Optimizer):
        pass

    with pytest.raises(MXNetError, match=r"'Nag' \(have \['adam', 'sgd'\]"):
        DataParallelTrainer(_mlp(tmx), mesh=tmx.cpu(), optimizer=Nag(), **kw)


def test_trainers_of_one_setup_share_one_program():
    spmd.reset_program_cache(max_size=2)
    kw = dict(data_shapes={"data": (B, 12)},
              label_shapes={"softmax_label": (B,)}, mesh=tmx.cpu())
    net = _mlp(tmx)
    a = DataParallelTrainer(net, optimizer_params=SGD, **kw)
    # an equal graph of another Symbol object shares it too
    b = DataParallelTrainer(tmx.sym.load_json(net.tojson()),
                            optimizer_params=SGD, **kw)
    assert a._program is b._program
    # ZeRO-1 changes nothing on one device, so it keys no program
    c = DataParallelTrainer(net, optimizer_params=SGD,
                            shard_optimizer_state=True, **kw)
    assert c._program is a._program
    DataParallelTrainer(net, optimizer="adam", **kw)
    DataParallelTrainer(net, compute_dtype="bfloat16", **kw)
    stats = spmd.program_cache_stats()
    assert (stats["hits"], stats["misses"], stats["evictions"],
            stats["size"]) == (2, 3, 1, 2)
    assert spmd._cache_size() == 2
    spmd.reset_program_cache()


def test_compiled_cost_counts_the_mlps_products(sgd_runs):
    (params, aux, X, y), _, (tr, *_) = sgd_runs
    cost = tr.step_cost_analysis(X[0], y[0])
    # fc1 forward and weight gradient (the data takes none), fc2
    # forward, weight and input gradients: 2 x M x N x K each
    want = 2 * (2 * B * 12 * 16) + 3 * (2 * B * 16 * CLASSES)
    assert cost == {"flops": float(want), "temp_bytes": None}
    assert flops.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.mfu_proxy(want, 10.0, 989e12) == round(
        want * 10 / 989e12, 4)


def test_step_cost_analysis_leaves_the_state_unchanged():
    params, aux, X, y = _start("convnet", seed=2)
    tr = _trainer(tmx, "convnet", params, aux)
    tr.step(X[0], y[0])
    snap = [{k: v.detach().clone() for k, v in d.items()}
            for d in (tr.params, tr.aux)]
    moms = {k: [s.clone() for s in st] for k, st in tr.opt_state.items()}
    counts = (dict(tr.optimizer._index_update_count),
              tr.optimizer.num_update)
    cost = tr.step_cost_analysis(X[1], y[1])
    assert cost["flops"] > 0
    for before, now in zip(snap, (tr.params, tr.aux)):
        for k, v in before.items():
            assert torch.equal(v, now[k]), k
    for k, st in moms.items():
        assert all(torch.equal(a, b) for a, b in zip(st, tr.opt_state[k]))
    assert counts == (tr.optimizer._index_update_count,
                      tr.optimizer.num_update)
