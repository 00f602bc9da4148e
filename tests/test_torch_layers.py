"""The port's layer ops (``ops/nn.py``: the convolution family, pooling,
``BatchNorm``, ``Dropout``, ``LeakyReLU``, ``LRN``, ``InstanceNorm``,
``L2Normalization``, ``UpSampling``) and its sampling ops
(``ops/sampling.py``) against ``mxnet_tpu``'s, on the same numpy inputs
from a seed, through ``mx.nd`` on the CPU.

Deterministic ops: outputs within 1e-5 x max|ref| and, under
``autograd.record()`` with a random head gradient, every input's
gradient within 1e-4 x max|ref|; shapes and dtypes equal.  ``BatchNorm``
in each mode also updates its moving statistics, held within 1e-5.
Inputs are continuous draws, so no ReLU or max-pool input sits exactly
at a kink or a tie.  The reference's side of every case is its op
(``OpDef.apply``) and ``jax.vjp`` of it, all cases in one jitted program
computed once for the module: one XLA compile in place of one a
primitive and shape in eager mode.

Random ops draw from the port's generators, whose streams are not the
reference's (``jax.random``): they are held equal in distribution.
The samplers' sample means and variances over 10^5 draws lie within six
standard errors of the distribution's (and of the reference's draws),
Dropout's mask rate within six standard errors of ``p``, every kept
element and its gradient scaled by ``1 / (1 - p)`` as the reference's,
the identity outside training; a seed reproduces the draws.  rrelu's slope
is the midpoint at inference, as the reference's, and a draw in
``[lower_bound, upper_bound]`` in training, where the reference keeps
the midpoint (ROADMAP Queue 3, differences by design).
"""
import contextlib

import numpy as np
import pytest

import jax
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from test_torch_ops_common import _one_torch_thread  # noqa: F401

FWD, GRAD = 1e-5, 1e-4


def _within(got, want, tol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    err = float(np.abs(got.astype(np.float64) - want).max())
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    assert err <= bound, (what, err, bound)


def _values(shapes, seed, positive=()):
    rs = np.random.RandomState(seed)
    return [(rs.uniform(0.5, 1.5, s) if i in positive else rs.randn(*s))
            .astype(np.float32) for i, s in enumerate(shapes)]


def _heads(shapes):
    rs = np.random.RandomState(1)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _run(op, values, attrs, train=True):
    """The port's ``mx.nd.<op>`` on ``values`` under
    ``autograd.record()`` (in train mode unless ``train`` is False),
    backward from a random head gradient: the outputs, then each
    input's gradient, as numpy."""
    with tmx.cpu():
        xs = [tmx.nd.array(v) for v in values]
        for x in xs:
            x.attach_grad()
        with tmx.autograd.record(train_mode_=train):
            outs = getattr(tmx.nd, op)(*xs, **attrs)
        outs = outs if isinstance(outs, list) else [outs]
        tmx.autograd.backward(outs, [tmx.nd.array(h) for h in
                                     _heads([o.shape for o in outs])])
        return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs]


def _jax_case(op, attrs, values, aux=(), train=True):
    """The reference's op on ``values`` (auxiliary states ``aux``) as a
    function for ``jax.vjp``, and the head gradients of its outputs."""
    jop = jreg.get_op(op)
    parsed = jop.parse_attrs(attrs)

    def f(*xs):
        outs, new_aux = jop.apply(parsed, xs, tuple(aux), train, None)
        return outs, new_aux

    outs = jax.eval_shape(lambda *xs: f(*xs)[0], *values)
    return f, _heads([o.shape for o in outs])


def _jax_all(cases):
    """Every case's (outputs, input gradients, new auxiliary states)
    from the reference, in one jitted program.  ``cases``: (op, attrs,
    values, aux, train)."""
    fns = [_jax_case(op, attrs, values, aux, train)
           for op, attrs, values, aux, train in cases]

    def run(all_values, all_heads):
        res = []
        for (f, _), values, heads in zip(fns, all_values, all_heads):
            outs, vjp, new_aux = jax.vjp(f, *values, has_aux=True)
            res.append((outs, vjp(tuple(heads)), new_aux))
        return res

    res = jax.jit(run)([c[2] for c in cases], [h for _, h in fns])
    return [tuple([np.asarray(a) for a in part] for part in r) for r in res]


K33 = {"kernel": (3, 3)}
# (op, input shapes, attrs, indices of inputs drawn positive)
LAYER_CASES = [
    ("Convolution", [(2, 4, 7, 7), (6, 4, 3, 3), (6,)],
     dict(K33, num_filter=6, stride=(2, 2), pad=(1, 1)), ()),
    ("Convolution", [(2, 4, 8, 8), (6, 2, 3, 3)],
     dict(K33, num_filter=6, num_group=2, dilate=(2, 2), pad=(2, 2),
          no_bias=True), ()),
    ("Convolution_v1", [(2, 3, 9), (4, 3, 3), (4,)],
     {"kernel": (3,), "num_filter": 4, "stride": (2,), "pad": (1,)}, ()),
    ("Convolution", [(1, 2, 5, 5, 5), (3, 2, 3, 3, 3)],
     {"kernel": (3, 3, 3), "num_filter": 3, "pad": (1, 1, 1),
      "stride": (2, 1, 1), "no_bias": True}, ()),
    # adj 1, below the stride
    ("Deconvolution", [(2, 4, 4, 4), (4, 3, 3, 3), (3,)],
     dict(K33, num_filter=3, stride=(2, 2), pad=(1, 1), adj=(1, 1)), ()),
    # target_shape 10 = 7 + adj 3, past the stride
    ("Deconvolution", [(1, 2, 4, 4), (2, 3, 3, 3)],
     dict(K33, num_filter=3, stride=(2, 2), pad=(1, 1),
          target_shape=(10, 10), no_bias=True), ()),
    # target_shape below the plain size: adj -1
    ("Deconvolution", [(1, 2, 4, 4), (2, 3, 3, 3), (3,)],
     dict(K33, num_filter=3, stride=(2, 2), pad=(1, 1),
          target_shape=(6, 6)), ()),
    ("Deconvolution", [(2, 4, 5, 5), (4, 3, 4, 4)],
     {"kernel": (4, 4), "num_filter": 6, "num_group": 2, "stride": (2, 2),
      "pad": (1, 1), "no_bias": True}, ()),
    ("Deconvolution", [(2, 3, 6), (3, 2, 3), (2,)],
     {"kernel": (3,), "num_filter": 2, "stride": (3,)}, ()),
    ("Deconvolution", [(1, 2, 3, 3, 3), (2, 2, 2, 2, 2)],
     {"kernel": (2, 2, 2), "num_filter": 2, "stride": (2, 2, 2),
      "no_bias": True}, ()),
]
for _pool in ("max", "avg", "sum"):
    LAYER_CASES += [
        ("Pooling", [(2, 3, 7, 7)],
         dict(K33, stride=(2, 2), pad=(1, 1), pool_type=_pool), ()),
        # ceil windows, the last one starting in the padding
        ("Pooling", [(2, 3, 6, 6)],
         dict(K33, stride=(2, 2), pad=(1, 1), pool_type=_pool,
              pooling_convention="full"), ()),
        # padding past half the kernel: padded explicitly
        ("Pooling_v1", [(2, 3, 6, 6)],
         dict(K33, stride=(2, 2), pad=(2, 2), pool_type=_pool), ()),
        # the kernel ignored
        ("Pooling", [(2, 3, 5, 5)],
         {"kernel": (7, 7), "global_pool": True, "pool_type": _pool}, ()),
        ("Pooling", [(2, 3, 9)],
         {"kernel": (3,), "stride": (2,), "pad": (1,), "pool_type": _pool,
          "pooling_convention": "full"}, ()),
    ]
LAYER_CASES += [
    ("Pooling", [(1, 2, 5, 5, 5)],
     {"kernel": (2, 2, 2), "stride": (2, 2, 2), "pool_type": "max"}, ()),
    ("Pooling", [(1, 2, 5, 5, 5)],
     {"kernel": (2, 2, 2), "stride": (2, 2, 2), "pool_type": "avg",
      "pooling_convention": "full"}, ()),
    ("LeakyReLU", [(2, 3, 4, 4)], {"act_type": "leaky", "slope": 0.1}, ()),
    ("LeakyReLU", [(2, 3, 4, 4)], {"act_type": "elu", "slope": 0.3}, ()),
    ("LeakyReLU", [(2, 3, 4, 4), (3,)], {"act_type": "prelu"}, (1,)),
    ("LRN", [(2, 6, 4, 4)], {"nsize": 3}, ()),
    ("LRN", [(2, 7, 3, 3)], {"nsize": 5, "alpha": 0.01, "beta": 0.5,
                             "knorm": 1.5}, ()),
    ("InstanceNorm", [(2, 3, 4, 5), (3,), (3,)], {"eps": 1e-3}, (1,)),
    ("L2Normalization", [(2, 3, 4, 4)], {"mode": "instance"}, ()),
    ("L2Normalization", [(2, 3, 4, 4)], {"mode": "channel"}, ()),
    ("L2Normalization", [(2, 3, 4, 4)], {"mode": "spatial"}, ()),
    ("UpSampling", [(2, 3, 3, 4)], {"scale": 2, "num_args": 1}, ()),
    ("UpSampling", [(2, 3, 3, 4), (2, 2, 3, 4)],
     {"scale": 3, "num_args": 2}, ()),
]


def _case_id(case):
    op, shapes, attrs, _ = case
    return op + "-" + "-".join("%s=%s" % kv for kv in sorted(attrs.items())
                               if kv[0] != "num_args")


@pytest.fixture(scope="module")
def jax_layers():
    return _jax_all([(op, attrs, _values(shapes, 3, positive), (), True)
                     for op, shapes, attrs, positive in LAYER_CASES])


@pytest.mark.parametrize("index", range(len(LAYER_CASES)),
                         ids=[_case_id(c) for c in LAYER_CASES])
def test_layer_forward_and_gradients_match_jax(jax_layers, index):
    op, shapes, attrs, positive = LAYER_CASES[index]
    values = _values(shapes, 3, positive)
    want_outs, want_grads, _ = jax_layers[index]
    got_outs, got_grads = _run(op, values, attrs)
    for i, (g, w) in enumerate(zip(got_outs, want_outs)):
        _within(g, w, FWD, "%s output %d" % (op, i))
    for i, (g, w) in enumerate(zip(got_grads, want_grads)):
        _within(g, w, GRAD, "%s gradient of input %d" % (op, i))


def test_rrelu_takes_the_midpoint_at_inference():
    values = _values([(2, 3, 4, 4)], 4)
    attrs = {"act_type": "rrelu", "lower_bound": 0.1, "upper_bound": 0.3}
    (want_outs, want_grads, _), = _jax_all([("LeakyReLU", attrs, values,
                                             (), False)])
    got_outs, got_grads = _run("LeakyReLU", values, attrs, False)
    _within(got_outs[0], want_outs[0], FWD, "rrelu output")
    _within(got_grads[0], want_grads[0], GRAD, "rrelu gradient")


def test_rrelu_draws_its_slope_in_training():
    x = -np.ones((20000,), np.float32)
    with tmx.cpu(), tmx.autograd.train_mode():
        tmx.random.seed(2)
        y = tmx.nd.LeakyReLU(tmx.nd.array(x), act_type="rrelu",
                             lower_bound=0.1, upper_bound=0.3).asnumpy()
    slope = -y
    assert slope.min() >= 0.1 and slope.max() <= 0.3
    # uniform on [0.1, 0.3]: mean 0.2, sd 0.2 / sqrt(12)
    assert abs(slope.mean() - 0.2) < 6 * 0.2 / np.sqrt(12 * x.size)


# ---------------------------------------------------------------------------
# BatchNorm: the output, the gradients and the moving statistics
# ---------------------------------------------------------------------------
BN_MODES = [
    ("train", {"fix_gamma": False}),
    ("train", {"fix_gamma": True}),
    ("train", {"fix_gamma": False, "output_mean_var": True}),
    ("train", {"fix_gamma": False, "use_global_stats": True}),
    ("train", {"fix_gamma": False, "momentum": 0.7, "eps": 2e-5}),
    ("infer", {"fix_gamma": False}),
]


def _bn(values, attrs, mode):
    """The port's BatchNorm through ``mx.nd`` on (data, gamma, beta) with
    the moving statistics as its auxiliary states: the outputs, the
    gradients of the three arguments (under ``record()``) and the moving
    statistics after the call."""
    with tmx.cpu():
        data, gamma, beta, mm, mv = [tmx.nd.array(v) for v in values]
        args = [data, gamma, beta]
        scope = tmx.autograd.record() if mode == "train" else \
            contextlib.nullcontext()
        for x in args:
            x.attach_grad()
        with scope:
            outs = tmx.nd.BatchNorm(data, gamma, beta, mm, mv, **attrs)
        outs = outs if isinstance(outs, list) else [outs]
        grads = []
        if mode == "train":
            tmx.autograd.backward(outs, [tmx.nd.array(h) for h in
                                         _heads([o.shape for o in outs])])
            grads = [x.grad.asnumpy() for x in args]
        return [o.asnumpy() for o in outs], grads, [mm.asnumpy(),
                                                    mv.asnumpy()]


BN_SHAPES = [(4, 3, 5, 5), (6, 4)]
BN_CASES = [(mode, attrs, shape) for shape in BN_SHAPES
            for mode, attrs in BN_MODES]


def _bn_values(shape):
    rs = np.random.RandomState(5)
    c = shape[1]
    return [(1.5 * rs.randn(*shape) + 0.3).astype(np.float32),
            rs.uniform(0.5, 1.5, c).astype(np.float32),
            rs.randn(c).astype(np.float32),
            rs.uniform(-0.2, 0.2, c).astype(np.float32),
            rs.uniform(0.5, 1.5, c).astype(np.float32)]


@pytest.fixture(scope="module")
def jax_bn():
    cases = []
    for mode, attrs, shape in BN_CASES:
        v = _bn_values(shape)
        cases.append(("BatchNorm", attrs, v[:3], v[3:], mode == "train"))
    return _jax_all(cases)


@pytest.mark.parametrize("index", range(len(BN_CASES)), ids=[
    "-".join([m] + sorted(a) + ["x".join(map(str, sh))])
    for m, a, sh in BN_CASES])
def test_batchnorm_matches_jax_and_updates_its_moving_stats(jax_bn, index):
    mode, attrs, shape = BN_CASES[index]
    values = _bn_values(shape)
    want_outs, want_grads, want_aux = jax_bn[index]
    got = _bn(values, attrs, mode)
    want = (want_outs, want_grads if mode == "train" else [], want_aux)
    for what, g_list, w_list, tol in (("output", got[0], want[0], FWD),
                                      ("gradient", got[1], want[1], GRAD),
                                      ("moving stat", got[2], want[2], FWD)):
        assert len(g_list) == len(w_list)
        for i, (g, w) in enumerate(zip(g_list, w_list)):
            _within(g, w, tol, "BatchNorm %s %d" % (what, i))
    moved = not (mode == "infer" or attrs.get("use_global_stats"))
    assert moved == (not np.array_equal(got[2][0], values[3]))
    if attrs.get("fix_gamma", True) and mode == "train":
        assert not got[1][1].any()      # gamma replaced by ones


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------
P = 0.3


def _dropout(pkg, x, mode, seed=0):
    """Dropout(p=P) of ``x`` under ``mode``: 'record' (train mode, with
    a backward of ones), 'train' (train mode, no tape) or 'infer'."""
    with pkg.cpu():
        pkg.random.seed(seed)
        a = pkg.nd.array(x)
        a.attach_grad()
        if mode == "infer":
            return pkg.nd.Dropout(a, p=P).asnumpy(), None
        if mode == "train":
            with pkg.autograd.train_mode():
                return pkg.nd.Dropout(a, p=P).asnumpy(), None
        with pkg.autograd.record():
            y = pkg.nd.Dropout(a, p=P)
        y.backward()
        return y.asnumpy(), a.grad.asnumpy()


def test_dropout_rate_scale_and_gradient_match_jax_in_distribution():
    x = np.random.RandomState(6).uniform(0.5, 2.0, 100000).astype(np.float32)
    got, got_grad = _dropout(tmx, x, "record")
    want, _ = _dropout(jmx, x, "record")
    se = np.sqrt(P * (1 - P) / x.size)
    for y in (got, want):
        assert abs((y == 0).mean() - P) < 6 * se
    # every kept element scaled by 1 / (1 - p), in both packages (within
    # one float32 rounding: a division by a scalar may be a product by
    # its reciprocal)
    for y in (got, want):
        kept = y != 0
        np.testing.assert_allclose(y[kept], x[kept] / (1 - P), rtol=1e-6)
    np.testing.assert_allclose(got_grad,
                               np.where(got != 0, 1 / (1 - P), 0),
                               rtol=1e-6)


def test_dropout_is_the_identity_outside_training_and_follows_the_seed():
    x = np.random.RandomState(7).randn(4096).astype(np.float32)
    for pkg in (tmx, jmx):
        np.testing.assert_array_equal(_dropout(pkg, x, "infer")[0], x)
    a, b = _dropout(tmx, x, "train", 11)[0], _dropout(tmx, x, "train", 11)[0]
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, _dropout(tmx, x, "train", 12)[0])


def test_dropout_in_a_graph_drops_only_when_training():
    data = tmx.sym.Variable("data")
    net = tmx.sym.Dropout(data, p=P)
    exe = net.simple_bind(tmx.cpu(), grad_req="null", data=(8, 512))
    x = np.random.RandomState(8).uniform(0.5, 2.0, (8, 512)).astype(
        np.float32)
    exe.arg_dict["data"][:] = x
    np.testing.assert_array_equal(exe.forward(is_train=False)[0].asnumpy(),
                                  x)
    y = exe.forward(is_train=True)[0].asnumpy()
    assert abs((y == 0).mean() - P) < 6 * np.sqrt(P * (1 - P) / y.size)
    np.testing.assert_allclose(y[y != 0], x[y != 0] / (1 - P), rtol=1e-6)


# ---------------------------------------------------------------------------
# the sampling ops
# ---------------------------------------------------------------------------
N = 100000
# op, attributes, the distribution's mean and variance
SAMPLERS = [
    ("_sample_uniform", {"low": -1.0, "high": 3.0}, 1.0, 16.0 / 12),
    ("_sample_normal", {"loc": 1.0, "scale": 2.0}, 1.0, 4.0),
    ("_sample_gamma", {"alpha": 2.5, "beta": 1.5}, 3.75, 2.5 * 1.5 ** 2),
    ("_sample_exponential", {"lam": 2.0}, 0.5, 0.25),
    ("_sample_poisson", {"lam": 3.5}, 3.5, 3.5),
    ("_sample_negbinomial", {"k": 3.0, "p": 0.4}, 4.5, 3.0 * 0.6 / 0.16),
]
ALIASES = {
    "_sample_uniform": ("uniform", "_random_uniform", "random_uniform"),
    "_sample_normal": ("normal", "_random_normal", "random_normal"),
    "_sample_gamma": ("_random_gamma", "random_gamma"),
    "_sample_exponential": ("_random_exponential", "random_exponential"),
    "_sample_poisson": ("_random_poisson", "random_poisson"),
    "_sample_negbinomial": ("_random_negbinomial",
                            "random_negative_binomial"),
}


def _draw(op, attrs, shape, dtype="float32", seed=0):
    with tmx.cpu():
        tmx.random.seed(seed)
        return getattr(tmx.nd, op)(shape=shape, dtype=dtype,
                                   **attrs).asnumpy()


def _jax_sampler(op, attrs, shape, dtype="float32"):
    jop = jreg.get_op(op)
    parsed = jop.parse_attrs(dict(attrs, shape=shape, dtype=dtype))
    return lambda key: jop.apply(parsed, (), (), False, key)[0][0]


@pytest.fixture(scope="module")
def jax_draws():
    """The reference's N draws of every sampler, in one jitted
    program."""
    fns = [_jax_sampler(op, attrs, (N,)) for op, attrs, _, _ in SAMPLERS]
    keys = jax.random.split(jax.random.PRNGKey(0), len(fns))
    draws = jax.jit(lambda ks: [f(k) for f, k in zip(fns, ks)])(keys)
    return {op: np.asarray(d) for (op, _, _, _), d in zip(SAMPLERS, draws)}


@pytest.mark.parametrize("op,attrs,mean,var", SAMPLERS,
                         ids=[s[0] for s in SAMPLERS])
def test_sampler_moments_match_jax_and_the_distribution(jax_draws, op,
                                                        attrs, mean, var):
    got = _draw(op, attrs, (N,)).astype(np.float64)
    want = jax_draws[op].astype(np.float64)
    se_mean = np.sqrt(var / N)
    # the sample variance's standard error from the draws' fourth moment
    se_var = np.sqrt(max(((got - got.mean()) ** 4).mean() - var ** 2,
                         0) / N)
    assert abs(got.mean() - mean) < 6 * se_mean, (got.mean(), mean)
    assert abs(got.var() - var) < 6 * se_var, (got.var(), var)
    assert abs(got.mean() - want.mean()) < 6 * np.sqrt(2) * se_mean
    for name in (op,) + ALIASES[op]:
        assert tmx.ops.registry.get_op(name) is tmx.ops.registry.get_op(op)


@pytest.mark.parametrize("op,attrs", [(s[0], s[1]) for s in SAMPLERS],
                         ids=[s[0] for s in SAMPLERS])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_sampler_shape_dtype_and_seed(op, attrs, dtype):
    got = _draw(op, attrs, (3, 5), dtype, seed=4)
    want = jax.eval_shape(_jax_sampler(op, attrs, (3, 5), dtype),
                          jax.random.PRNGKey(0))
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    np.testing.assert_array_equal(got, _draw(op, attrs, (3, 5), dtype,
                                             seed=4))


def test_sampler_in_a_graph_draws_on_each_forward():
    net = tmx.sym.random_normal(shape=(4, 6), loc=2.0) + tmx.sym.Variable(
        "x")
    exe = net.simple_bind(tmx.cpu(), grad_req="null", x=(4, 6))
    a = exe.forward(is_train=False)[0].asnumpy()
    b = exe.forward(is_train=False)[0].asnumpy()
    assert a.shape == (4, 6) and not np.array_equal(a, b)
    assert net.infer_shape(x=(4, 6))[1] == [(4, 6)]
