"""The LSTM language model through the port's ``BucketingModule``
against the JAX package's, and the Module surface that comes with it:
``state_names`` with ``get_states`` / ``set_states``, ``Monitor``, and
checkpoints of a bucketed model in both directions.

Both packages train the same tiny LSTM LM (vocabulary 32, two layers of
8, buckets 3 and 6) from the same parameters on the same epoch: the
port's ``BucketSentenceIter`` draws it and the reference's loads it
through ``state_dict`` / ``load_state``.  The JAX package runs its
classic executor-group path (``MXNET_MODULE_FUSED=0``) on its plain XLA
lowerings (``MXNET_PALLAS=0``).
"""
import importlib
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

PKGS = (jmx, tmx)
V, H, LAYERS, B = 32, 8, 2, 4
BUCKETS = [3, 6]
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-5}
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module, the reference on its classic
    plain path; restored when the module ends."""
    n = torch.get_num_threads()
    saved = {k: os.environ.get(k) for k in ("MXNET_PALLAS",
                                            "MXNET_MODULE_FUSED")}
    torch.set_num_threads(1)
    os.environ.update(MXNET_PALLAS="0", MXNET_MODULE_FUSED="0")
    yield
    torch.set_num_threads(n)
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _close(got, want, what, tol=TOL):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= bound, (what, err, bound)


def _sentences(seed, lengths):
    rs = np.random.RandomState(seed)
    return [list(rs.randint(1, V, n)) for n in lengths]


# two batches of bucket 3 and one of bucket 6: three steps an epoch
TRAIN = _sentences(0, [3, 2, 2, 3, 3, 3, 1, 3, 6, 4, 5, 6])
# one batch a bucket, and a bucket (5) the training data has not
EVAL = _sentences(1, [3, 2, 3, 3, 5, 4, 5, 5])
EVAL_BUCKETS = [3, 5]


def _sym_gen(pkg):
    lm = importlib.import_module(pkg.__name__ + ".models.lstm_lm")
    return lm.sym_gen_factory(num_layers=LAYERS, num_hidden=H, num_embed=H,
                              vocab_size=V)


def _module(pkg, key=max(BUCKETS)):
    return pkg.mod.BucketingModule(_sym_gen(pkg), default_bucket_key=key,
                                   context=pkg.cpu())


def _arrays(params):
    return {k: v.asnumpy() for k, v in params.items()}


def _fit(pkg, params, state):
    """Three SGD steps through ``fit`` from ``params`` on the epoch
    ``state`` (drawn when None), scored on EVAL after the epoch and
    again after the fit.  Returns the epoch, each step's bucket,
    parameters and perplexity, the score and the module."""
    it = pkg.rnn.BucketSentenceIter(TRAIN, B, buckets=BUCKETS,
                                    invalid_label=0)
    if state is not None:
        it.load_state(state)
    state = it.state_dict()
    ev = pkg.rnn.BucketSentenceIter(EVAL, B, buckets=EVAL_BUCKETS,
                                    invalid_label=0)
    mod = _module(pkg)
    steps = []

    def on_batch(param):
        arg, _ = mod.get_params()
        steps.append((param.locals["data_batch"].bucket_key, _arrays(arg),
                      param.eval_metric.get()[1]))
        param.eval_metric.reset()

    arg = {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in params.items()}
    mod.fit(it, eval_data=ev, num_epoch=1, optimizer="sgd",
            optimizer_params=OPT, arg_params=arg,
            eval_metric=pkg.metric.Perplexity(ignore_label=0),
            batch_end_callback=on_batch)
    score = mod.score(ev, pkg.metric.Perplexity(ignore_label=0))[0][1]
    return state, steps, score, mod


@pytest.fixture(scope="module")
def trained():
    """The port's fit, then the reference's from the port's start."""
    it = tmx.rnn.BucketSentenceIter(TRAIN, B, buckets=BUCKETS,
                                    invalid_label=0)
    mod = _module(tmx)
    mod.bind(it.provide_data, it.provide_label)
    tmx.random.seed(3)
    mod.init_params(tmx.init.Xavier(factor_type="in", magnitude=2.34))
    start = _arrays(mod.get_params()[0])
    state, t_steps, t_score, t_mod = _fit(tmx, start, None)
    _, j_steps, j_score, j_mod = _fit(jmx, start, state)
    return dict(start=start, port=(t_steps, t_score, t_mod),
                ref=(j_steps, j_score, j_mod))


def test_fit_over_two_buckets_matches(trained):
    """Each step's bucket, every parameter after it (1e-5 x max|ref|)
    and its perplexity, and the score on an eval set with a bucket the
    training data lacks."""
    t_steps, t_score, t_mod = trained["port"]
    j_steps, j_score, j_mod = trained["ref"]
    assert [s[0] for s in t_steps] == [s[0] for s in j_steps]
    assert sorted({s[0] for s in t_steps}) == BUCKETS
    assert len(t_steps) == 3
    for i, ((_, tp, tppl), (_, jp, jppl)) in enumerate(zip(t_steps,
                                                          j_steps)):
        assert sorted(tp) == sorted(jp)
        for name in jp:
            _close(tp[name], jp[name], "step %d %s" % (i, name))
            assert not np.array_equal(tp[name], trained["start"][name]), \
                name
        assert abs(tppl - jppl) <= TOL * jppl, (i, tppl, jppl)
    assert abs(t_score - j_score) <= TOL * j_score
    assert sorted(t_mod._buckets) == [3, 5, 6]


def test_buckets_share_tensors_and_optimizer(trained):
    """Every bucket's executor holds the default bucket's parameter,
    gradient and auxiliary tensors themselves, and one updater."""
    mod = trained["port"][2]
    default = mod._buckets[6]
    d_ex = default._exec_group.executor
    for key, m in mod._buckets.items():
        ex = m._exec_group.executor
        for name in default._param_names:
            assert ex.arg_dict[name]._data is d_ex.arg_dict[name]._data
            assert ex.grad_dict[name] is d_ex.grad_dict[name]
        assert m._updater is default._updater
    assert len(default._updater.states) == len(default._param_names)


def _save(pkg, prefix, mod):
    arg, aux = mod.get_params()
    pkg.model.save_checkpoint(prefix, 3, mod.symbol, arg, aux)
    pkg.nd.waitall()    # the reference writes asynchronously


def _forward(pkg, mod, key, state):
    """The outputs of an inference forward of EVAL's batch of bucket
    ``key``, in the epoch ``state``."""
    it = pkg.rnn.BucketSentenceIter(EVAL, B, buckets=EVAL_BUCKETS,
                                    invalid_label=0)
    it.load_state(state)
    batch = [b for b in it if b.bucket_key == key][0]
    mod.forward(batch, is_train=False)
    return mod.get_outputs()[0].asnumpy()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_checkpoint_both_ways(trained, tmp_path, writer):
    """A trained bucketed model's ``get_params``, written by
    ``mx.model.save_checkpoint`` of one package and read by the other's
    ``load_checkpoint`` into ``init_params(arg_params=...)``: the reader
    gives the writer's outputs on buckets 3 and 5."""
    src, dst = (tmx, jmx) if writer == "port" else (jmx, tmx)
    mod = trained[writer][2]
    prefix = str(tmp_path / "lstm")
    _save(src, prefix, mod)
    _, arg, aux = dst.model.load_checkpoint(prefix, 3)
    assert sorted(arg) == sorted(mod.get_params()[0])
    new = _module(dst)
    it = dst.rnn.BucketSentenceIter(TRAIN, B, buckets=BUCKETS,
                                    invalid_label=0)
    new.bind(it.provide_data, it.provide_label, for_training=False)
    new.init_params(arg_params=arg, aux_params=aux)
    state = tmx.rnn.BucketSentenceIter(EVAL, B, buckets=EVAL_BUCKETS,
                                       invalid_label=0).state_dict()
    for key in EVAL_BUCKETS:
        _close(_forward(dst, new, key, state),
               _forward(src, mod, key, state), "bucket %d" % key)


def _state_net(pkg):
    """An LSTM cell unrolled from explicit state inputs ``h0``/``c0``;
    its outputs are the merged sequence and the last states."""
    with (jmx.name.NameManager() if pkg is jmx
          else tmx.symbol.NameManager()):
        cell = pkg.rnn.LSTMCell(H, prefix="lstm_")
        outs, states = cell.unroll(
            3, inputs=pkg.sym.Variable("data"), merge_outputs=True,
            begin_state=[pkg.sym.Variable("h0", shape=(B, H)),
                         pkg.sym.Variable("c0", shape=(B, H))])
        return pkg.sym.Group([outs] + list(states))


def test_states_get_set():
    """``state_names`` inputs: ``set_states(value=)`` fills them,
    ``set_states(states=)`` writes them, ``get_states`` reads them back,
    and a forward from set states equals the reference's."""
    rs = np.random.RandomState(5)
    data = rs.randn(B, 3, 6).astype(np.float32)
    h0, c0 = (rs.randn(B, H).astype(np.float32) for _ in range(2))
    outs = {}
    params = None
    for pkg in PKGS:
        mod = pkg.mod.Module(_state_net(pkg), label_names=None,
                             state_names=["h0", "c0"], context=pkg.cpu())
        mod.bind([("data", data.shape)], for_training=False)
        if params is None:
            mod.init_params(pkg.init.Xavier())
            params = _arrays(mod.get_params()[0])
        else:
            mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                        for k, v in params.items()})
        assert sorted(mod.get_params()[0]) == sorted(
            ["lstm_i2h_weight", "lstm_i2h_bias", "lstm_h2h_weight",
             "lstm_h2h_bias"])
        mod.set_states(value=0.25)
        for s in mod.get_states():
            assert s.shape == (B, H)
            np.testing.assert_array_equal(s.asnumpy(), 0.25)
        with pkg.cpu():
            mod.set_states(states=[pkg.nd.array(h0), pkg.nd.array(c0)])
        for s, want in zip(mod.get_states(), (h0, c0)):
            np.testing.assert_array_equal(s.asnumpy(), want)
        with pkg.cpu():
            mod.forward(jmx.io.DataBatch([pkg.nd.array(data)], [])
                        if pkg is jmx else
                        tmx.io.DataBatch([tmx.nd.array(data)], []),
                        is_train=False)
        outs[pkg] = [o.asnumpy() for o in mod.get_outputs()]
    for g, w in zip(outs[tmx], outs[jmx]):
        _close(g, w, "forward from set states")


def _monitor_rows(pkg, params, data):
    mod = pkg.mod.Module(_state_net(pkg), label_names=None,
                         state_names=["h0", "c0"], context=pkg.cpu())
    mod.bind([("data", data.shape)], for_training=False)
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in params.items()})
    mod.set_states(value=0.5)
    mon = pkg.monitor.Monitor(1, pattern=".*", sort=True)
    mod.install_monitor(mon)
    mon.tic()
    with pkg.cpu():
        batch = (jmx if pkg is jmx else tmx).io.DataBatch(
            [pkg.nd.array(data)], [])
        mod.forward(batch, is_train=False)
    return mon.toc()


def test_monitor_rows_match():
    """A ``Monitor`` over every tensor: the same (step, name) rows as
    the reference's, every op node's outputs and the arguments, each
    mean |x| within 1e-5 of the reference's."""
    rs = np.random.RandomState(6)
    data = rs.randn(B, 3, 6).astype(np.float32)
    params = {"lstm_i2h_weight": rs.randn(4 * H, 6),
              "lstm_i2h_bias": rs.randn(4 * H),
              "lstm_h2h_weight": rs.randn(4 * H, H),
              "lstm_h2h_bias": rs.randn(4 * H)}
    params = {k: (0.3 * v).astype(np.float32) for k, v in params.items()}
    rows = {pkg: _monitor_rows(pkg, params, data) for pkg in PKGS}
    assert [r[:2] for r in rows[tmx]] == [r[:2] for r in rows[jmx]]
    names = [r[1] for r in rows[tmx]]
    assert "lstm_t2_out_output" in names and "lstm_h2h_weight" in names
    for (_, name, got), (_, _, want) in zip(rows[tmx], rows[jmx]):
        g, w = float(got.split()[0]), float(want.split()[0])
        assert abs(g - w) <= TOL * max(abs(w), 1e-30), (name, g, w)


def test_fit_with_monitor_sees_every_bucket():
    """``fit(monitor=)`` on a ``BucketingModule``: the monitor reports
    the nodes of each bucket's graph as the bucket runs."""
    seen = set()

    def stat(x):
        return float(abs(x).mean().asscalar())

    it = tmx.rnn.BucketSentenceIter(TRAIN, B, buckets=BUCKETS,
                                    invalid_label=0)
    mod = _module(tmx)
    mon = tmx.monitor.Monitor(1, stat_func=stat, pattern=r".*_out_output")
    orig = mon.toc

    def toc():
        rows = orig()
        seen.update(name for _, name, _ in rows)
        return rows

    mon.toc = toc
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=OPT,
            initializer=tmx.init.Xavier(), monitor=mon,
            eval_metric=tmx.metric.Perplexity(ignore_label=0))
    assert "lstm_l1_t5_out_output" in seen     # bucket 6's last step
    assert "lstm_l0_t2_out_output" in seen
