"""Training through the port's ``Module`` against the JAX package's.

Both modules get identical initial parameters (the port's
``init_params(arg_params=...)`` takes the numpy arrays that cross from
the JAX package) and the same batches; the JAX package runs its classic
executor-group path (``MXNET_MODULE_FUSED=0``) on its plain XLA
lowerings (``MXNET_PALLAS=0``).  Then the port's own copy of the JAX
package's transformer convergence test, unit checks of the metrics,
optimizer multipliers and Xavier, and checkpoints in both directions.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

LM = dict(seq_len=16, num_layers=2, num_hidden=32, num_heads=2,
          vocab_size=64)
BATCH = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its tests make thousands of
    tiny torch ops, and under a parallel run (several workers on the
    same cores) handing each op to a team of threads costs many times
    the op.  Restored when the module ends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _classic_plain_path(monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS", "0")
    monkeypatch.setenv("MXNET_MODULE_FUSED", "0")


def _successor_data(n, L, V, seed=0):
    """Token grids of the successor language x[t+1] = x[t] + 1 mod V."""
    rs = np.random.RandomState(seed)
    X = (rs.randint(0, V, (n, 1)) + np.arange(L)) % V
    return X.astype(np.float32), ((X + 1) % V).astype(np.float32)


def _init_arrays(seed=1):
    """Seeded parameters at the tiny LM's shapes, in numpy."""
    net = jmx.models.transformer_lm(**LM)
    shapes, _, _ = net.infer_shape(data=(BATCH, LM["seq_len"]),
                                   softmax_label=(BATCH, LM["seq_len"]))
    rs = np.random.RandomState(seed)
    return {n: rs.uniform(-0.2, 0.2, s).astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _steps(pkg, params, batches, optimizer, opt_params):
    net = pkg.models.transformer_lm(**LM)
    it = pkg.io.NDArrayIter(*batches, batch_size=BATCH)
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.bind(it.provide_data, it.provide_label)
    if pkg is jmx:
        params = {k: jmx.nd.array(v) for k, v in params.items()}
    mod.init_params(arg_params=params)
    mod.init_optimizer(optimizer=optimizer, optimizer_params=opt_params)
    outs = []
    for batch in it:
        mod.forward_backward(batch)
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    arg, _ = mod.get_params()
    return outs, {k: v.asnumpy() for k, v in arg.items()}


def _rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("optimizer,opt_params,param_tol", [
    ("sgd", {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-4}, 1e-5),
    ("adam", {"learning_rate": 0.01, "wd": 1e-4}, 1e-4)])
def test_three_steps_match_jax_module(optimizer, opt_params, param_tol):
    """Three forward_backward + update steps: every step's output agrees
    within 1e-5 of the reference's largest magnitude, and so do the
    parameters after the last step under SGD.  Adam's parameters get
    1e-4: its step ``lr * m / (sqrt(v) + eps)`` has the size ``lr``
    whatever the gradient's, so a weight whose gradient is at the fp32
    rounding level of the others moves by up to ``lr`` in a direction
    that rounding decides."""
    params = _init_arrays()
    X, y = _successor_data(3 * BATCH, LM["seq_len"], LM["vocab_size"])
    want_outs, want_params = _steps(jmx, params, (X, y), optimizer,
                                    opt_params)
    got_outs, got_params = _steps(tmx, params, (X, y), optimizer,
                                  opt_params)
    assert len(got_outs) == len(want_outs) == 3
    for g, w in zip(got_outs, want_outs):
        assert _rel_err(g, w) <= 1e-5
    assert sorted(got_params) == sorted(want_params)
    for name, w in want_params.items():
        assert _rel_err(got_params[name], w) <= param_tol, name
        assert not np.array_equal(w, params[name]), name  # it moved


def test_transformer_lm_convergence():
    """The port's copy of the JAX package's train-tier headline: a
    causal LM fits the successor language through ``Module.fit``."""
    B, L, V = 16, 16, 32
    rs = np.random.RandomState(0)
    starts = rs.randint(0, V, (8 * B, 1))
    X = (starts + np.arange(L)) % V            # x[t+1] = x[t] + 1 mod V
    y = (X + 1) % V
    sym = tmx.models.transformer_lm(seq_len=L, num_layers=1,
                                    num_hidden=32, num_heads=2,
                                    vocab_size=V)
    tmx.random.seed(42)
    it = tmx.io.NDArrayIter(X.astype("float32"), y.astype("float32"),
                            batch_size=B, shuffle=True)
    mod = tmx.Module(sym, context=tmx.cpu())
    metric = tmx.metric.Perplexity(ignore_label=None)
    mod.fit(it, num_epoch=8, optimizer="adam",
            optimizer_params={"learning_rate": 0.01},
            initializer=tmx.initializer.Xavier(),
            eval_metric=metric)
    ppl = mod.score(it, tmx.metric.Perplexity(ignore_label=None))[0][1]
    assert ppl < 2.0, ppl


def test_fit_callbacks_and_eval_data():
    X, y = _successor_data(2 * BATCH, LM["seq_len"], LM["vocab_size"])
    it = tmx.io.NDArrayIter(X, y, batch_size=BATCH)
    seen, epochs = [], []
    mod = tmx.Module(tmx.models.transformer_lm(**LM), context=tmx.cpu())
    mod.fit(it, eval_data=it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1},
            eval_metric=tmx.metric.Perplexity(ignore_label=None),
            batch_end_callback=lambda p: seen.append((p.epoch, p.nbatch)),
            epoch_end_callback=lambda e, s, a, x: epochs.append(e))
    assert seen == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert epochs == [0, 1]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_batches_like_jax(shuffle, handle):
    """Batch order and last-batch handling; with shuffle, the order is
    the permutation the port's generator drew."""
    X = np.arange(22, dtype=np.float32).reshape(11, 2)
    y = np.arange(11, dtype=np.float32)
    tmx.random.seed(3)
    t = tmx.io.NDArrayIter(X, y, batch_size=4, shuffle=shuffle,
                           last_batch_handle=handle)
    j = jmx.io.NDArrayIter(X, y, batch_size=4, shuffle=shuffle,
                           last_batch_handle=handle)
    if shuffle:
        # the same permutation, handed to the reference
        j._order = t._order.copy()
    for _ in range(2):
        tb, jb = list(t), list(j)
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            assert np.array_equal(a.data[0].asnumpy(), b.data[0].asnumpy())
            assert np.array_equal(a.label[0].asnumpy(), b.label[0].asnumpy())
            assert a.pad == b.pad
        t.reset()
        j.reset()
    assert t.provide_data[0].shape == j.provide_data[0].shape
    assert t.provide_label[0].name == j.provide_label[0].name


def test_shuffle_draws_from_the_seeded_generator():
    X = np.zeros((32, 1), np.float32)
    tmx.random.seed(7)
    a = tmx.io.NDArrayIter(X, batch_size=4, shuffle=True)._order
    tmx.random.seed(7)
    b = tmx.io.NDArrayIter(X, batch_size=4, shuffle=True)._order
    assert np.array_equal(a, b) and not np.array_equal(a, np.arange(32))


def test_metrics_match_jax():
    rs = np.random.RandomState(0)
    logits = rs.randn(40, 9).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    label = rs.randint(0, 9, 40).astype(np.float32)
    label[::7] = 3
    cases = [(tmx.metric.Perplexity(ignore_label=None),
              jmx.metric.Perplexity(ignore_label=None)),
             (tmx.metric.Perplexity(ignore_label=3),
              jmx.metric.Perplexity(ignore_label=3)),
             (tmx.metric.Accuracy(), jmx.metric.Accuracy()),
             (tmx.metric.CrossEntropy(), jmx.metric.CrossEntropy()),
             (tmx.metric.create("acc"), jmx.metric.create("acc"))]
    for t, j in cases:
        for lo, hi in ((0, 16), (16, 40)):
            t.update([tmx.nd.array(label[lo:hi], ctx=tmx.cpu())],
                     [tmx.nd.array(prob[lo:hi], ctx=tmx.cpu())])
            j.update([jmx.nd.array(label[lo:hi])],
                     [jmx.nd.array(prob[lo:hi])])
        (tn, tv), (jn, jv) = t.get(), j.get()
        assert tn == jn
        assert abs(tv - jv) <= 1e-6 * max(1.0, abs(jv)), (tn, tv, jv)


def test_optimizer_multipliers_match_jax():
    """Which parameters decay and at what rate, for the transformer's
    arguments, with symbol attributes and explicit overrides."""
    net_t = tmx.models.transformer_lm(**LM)
    net_j = jmx.models.transformer_lm(**LM)
    names = [n for n in net_j.list_arguments()
             if n not in ("data", "softmax_label")]
    idx2name = dict(enumerate(names))
    kw = dict(param_idx2name=idx2name, wd=1e-3, learning_rate=0.1)
    t = tmx.optimizer.create("sgd", sym=net_t, **kw)
    j = jmx.optimizer.create("sgd", sym=net_j, **kw)
    assert t.wd_mult == j.wd_mult
    assert t.lr_mult == j.lr_mult
    assert {n for n, m in t.wd_mult.items() if m == 0.0} == \
        {n for n in names if not n.endswith(("_weight", "_gamma"))}
    over = {"pred_bias": 2.0, "blk0_q_weight": 0.5}
    t.set_wd_mult(over)
    j.set_wd_mult(over)
    t.set_lr_mult({"embed_weight": 3.0})
    j.set_lr_mult({"embed_weight": 3.0})
    for i in idx2name:
        assert t._get_wd(i) == j._get_wd(i)
        assert t._get_lr(i) == j._get_lr(i)
    v_t = tmx.sym.Variable("x_weight", lr_mult=0.25, wd_mult=4.0)
    v_j = jmx.sym.Variable("x_weight", lr_mult=0.25, wd_mult=4.0)
    t = tmx.optimizer.create("adam", sym=v_t, param_idx2name={0: "x_weight"})
    j = jmx.optimizer.create("adam", sym=v_j, param_idx2name={0: "x_weight"})
    assert t.lr_mult == j.lr_mult and t.wd_mult == j.wd_mult


@pytest.mark.parametrize("clip", [None, 0.05])
def test_sgd_step_arithmetic_matches_jax(clip):
    """rescale_grad, clip_gradient and weight decay of one momentum
    step on one array."""
    rs = np.random.RandomState(2)
    w0, g = (rs.randn(5, 4).astype(np.float32) for _ in range(2))
    out = {}
    for pkg in (tmx, jmx):
        o = pkg.optimizer.create("sgd", learning_rate=0.3, momentum=0.9,
                                 wd=0.01, rescale_grad=0.5,
                                 clip_gradient=clip,
                                 param_idx2name={0: "fc_weight"})
        up = pkg.optimizer.get_updater(o)
        w = pkg.nd.array(w0, ctx=pkg.cpu())
        for _ in range(2):
            up(0, pkg.nd.array(g, ctx=pkg.cpu()), w)
        out[pkg] = w.asnumpy()
    assert np.abs(out[tmx] - out[jmx]).max() <= 1e-6


def test_xavier_bound_and_statistics():
    shape = (256, 384)
    scale = np.sqrt(3.0 / ((256 + 384) / 2.0))
    assert tmx.initializer.xavier_scale(shape) == pytest.approx(scale)
    for ft, fan in (("in", 384), ("out", 256)):
        assert tmx.initializer.xavier_scale(shape, ft) == \
            pytest.approx(np.sqrt(3.0 / fan))
    tmx.random.seed(0)
    arr = tmx.nd.zeros(shape, ctx=tmx.cpu())
    tmx.initializer.Xavier()(tmx.initializer.InitDesc("fc_weight"), arr)
    a = arr.asnumpy()
    assert np.abs(a).max() <= scale
    assert abs(a.mean()) < 0.01 * scale
    # uniform(-s, s) has variance s^2 / 3
    assert abs(a.var() / (scale ** 2 / 3) - 1) < 0.02
    ref = jmx.nd.zeros(shape)
    jmx.initializer.Xavier()(jmx.initializer.InitDesc("fc_weight"), ref)
    assert np.abs(ref.asnumpy()).max() <= scale
    g = tmx.nd.zeros((3,), ctx=tmx.cpu())
    tmx.initializer.Xavier()(tmx.initializer.InitDesc("ln_gamma"), g)
    b = tmx.nd.ones((3,), ctx=tmx.cpu())
    tmx.initializer.Xavier()(tmx.initializer.InitDesc("fc_bias"), b)
    assert g.asnumpy().tolist() == [1, 1, 1]
    assert b.asnumpy().tolist() == [0, 0, 0]


def _scored_module(pkg, mod, X, y):
    it = pkg.io.NDArrayIter(X, y, batch_size=BATCH)
    mod.bind(it.provide_data, it.provide_label, for_training=False)
    return mod.score(it, pkg.metric.Perplexity(ignore_label=None))[0][1]


def test_checkpoint_from_jax_scores_the_same_in_port(tmp_path):
    """A checkpoint written by the JAX package's Module loads in the
    port and scores the same batch to the same perplexity, and the
    reverse."""
    X, y = _successor_data(BATCH, LM["seq_len"], LM["vocab_size"], seed=5)
    it = jmx.io.NDArrayIter(X, y, batch_size=BATCH)
    jmod = jmx.Module(jmx.models.transformer_lm(**LM), context=jmx.cpu())
    jmod.bind(it.provide_data, it.provide_label)
    jmod.init_params(arg_params={k: jmx.nd.array(v)
                                 for k, v in _init_arrays(9).items()})
    want = jmod.score(it, jmx.metric.Perplexity(ignore_label=None))[0][1]
    jprefix = str(tmp_path / "jax")
    jmod.save_checkpoint(jprefix, 3)
    jmx.nd.waitall()   # the reference writes its files asynchronously
    tmod = tmx.Module.load(jprefix, 3, context=tmx.cpu())
    got = _scored_module(tmx, tmod, X, y)
    assert abs(got - want) <= 1e-5 * want
    tprefix = str(tmp_path / "port")
    tmod.save_checkpoint(tprefix, 4)
    back = jmx.Module.load(tprefix, 4, context=jmx.cpu())
    assert abs(_scored_module(jmx, back, X, y) - want) <= 1e-5 * want


def test_ndarray_save_load_crosses_packages(tmp_path):
    arrs = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.ones(4, np.float32)}
    jmx.nd.save(str(tmp_path / "j.params"),
                {k: jmx.nd.array(v) for k, v in arrs.items()})
    jmx.nd.waitall()
    got = tmx.nd.load(str(tmp_path / "j.params"))
    assert sorted(got) == ["a", "b"]
    for k, v in arrs.items():
        assert np.array_equal(got[k].asnumpy(), v)
    tmx.nd.save(str(tmp_path / "t.params"),
                [tmx.nd.array(v, ctx=tmx.cpu()) for v in arrs.values()])
    back = jmx.nd.load(str(tmp_path / "t.params"))
    assert [b.asnumpy().tolist() for b in back] == \
        [v.tolist() for v in arrs.values()]


def test_module_without_context_needs_a_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(tmx.MXNetError):
        tmx.Module(tmx.models.transformer_lm(**LM))
