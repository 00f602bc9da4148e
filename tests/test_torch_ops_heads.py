"""The port's regression heads and ``SVMOutput`` /
``IdentityAttachKLSparseReg`` (``ops/softmax.py``) against
``mxnet_tpu``'s ``custom_vjp`` heads, and against their formulas: the
heads ignore the head gradient and send ``grad(out, label) * grad_scale
/ num_output`` back, the label a zero gradient.

The gradients are compared through each package's executor
(``run_sym``): the JAX package's eager tape adds the head gradient to
the input of an op whose forward returns its input array (ROADMAP
Queue 3, traps), so its imperative gradient of an identity head is the
formula plus the head gradient.  The port's imperative gradient is the
formula (checked here)."""
import numpy as np
import pytest

import mxnet_tpu_torch as tmx
import mxnet_tpu as jmx
from test_torch_ops_common import (REL, _one_torch_thread,  # noqa: F401
                                   agree, check, run, run_sym)

RS = np.random.RandomState(7)
X = RS.randn(6, 3).astype(np.float32)
Y = RS.randn(6, 3).astype(np.float32)
X1 = RS.randn(6).astype(np.float32)
Y1 = RS.randn(6).astype(np.float32)
CLS = np.array([0, 2, 1, 1, 0, 2], np.float32)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


# (op, inputs, attrs, d loss / d data from (data, label))
HEADS = [
    ("LinearRegressionOutput", [X, Y], {}, lambda d, l: (d - l) / 3),
    ("LinearRegressionOutput", [X1, Y1], {"grad_scale": 2.0},
     lambda d, l: 2.0 * (d - l)),
    ("LogisticRegressionOutput", [X, Y], {"grad_scale": 0.5},
     lambda d, l: (_sigmoid(d) - l) * 0.5 / 3),
    ("MAERegressionOutput", [X, Y], {}, lambda d, l: np.sign(d - l) / 3),
    ("MAERegressionOutput", [X1, Y1], {"grad_scale": 3.0},
     lambda d, l: 3.0 * np.sign(d - l)),
]


def _svm_grad(d, l, margin, reg, linear):
    onehot = np.eye(d.shape[1], dtype=np.float32)[l.astype(int)]
    sign = np.where(onehot > 0, -1.0, 1.0)
    viol = (margin + sign * d) > 0
    if linear:
        return np.where(viol, sign * reg, 0.0)
    return np.where(viol, 2.0 * reg * (margin + sign * d) * sign, 0.0)


def _kl_grad(d, g, rho, penalty):
    rho_hat = _sigmoid(d).mean(axis=0, keepdims=True)
    return g + penalty * (-rho / rho_hat + (1 - rho) / (1 - rho_hat)) \
        / d.shape[0]


def _id(case):
    return "%s-%dd%s" % (case[0], case[1][0].ndim, "".join(
        "-%s=%s" % kv for kv in sorted(case[2].items())))


@pytest.mark.parametrize("case", HEADS, ids=[_id(c) for c in HEADS])
def test_regression_heads(case):
    op, vals, attrs, grad = case
    check(op, [], attrs, values=vals)
    agree(run_sym(tmx, op, vals, attrs), run_sym(jmx, op, vals, attrs), REL,
          op)
    (_, _), (gd, _), (gl, _) = run(tmx, op, [], attrs, grad=True, values=vals)
    want = grad(*vals)
    np.testing.assert_allclose(gd, want, rtol=0,
                               atol=REL * np.abs(want).max())
    assert not gl.any()


@pytest.mark.parametrize("attrs", [{}, {"margin": 0.5,
                                        "regularization_coefficient": 2.0},
                                   {"use_linear": True, "margin": 1.5}])
def test_svm_output(attrs):
    vals = [X, CLS]
    check("SVMOutput", [], attrs, values=vals)
    agree(run_sym(tmx, "SVMOutput", vals, attrs),
          run_sym(jmx, "SVMOutput", vals, attrs), REL, "SVMOutput")
    (out, _), (gd, _), _ = run(tmx, "SVMOutput", [], attrs, grad=True,
                               values=vals)
    np.testing.assert_array_equal(out, X)
    want = _svm_grad(X, CLS, attrs.get("margin", 1.0),
                     attrs.get("regularization_coefficient", 1.0),
                     attrs.get("use_linear", False))
    np.testing.assert_allclose(gd, want, rtol=0,
                               atol=REL * np.abs(want).max())


@pytest.mark.parametrize("attrs", [{}, {"sparseness_target": 0.3,
                                        "penalty": 0.01}])
def test_identity_attach_kl_sparse_reg(attrs):
    op = "IdentityAttachKLSparseReg"
    check(op, [], attrs, values=[X])
    agree(run_sym(tmx, op, [X], attrs), run_sym(jmx, op, [X], attrs), REL,
          op)
    (_, _), (gd, _) = run(tmx, "IdentityAttachKLSparseReg", [], attrs,
                          grad=True, values=[X])
    head = np.random.RandomState(1).randn(*X.shape).astype(np.float32)
    want = _kl_grad(X, head, attrs.get("sparseness_target", 0.1),
                    attrs.get("penalty", 0.001))
    np.testing.assert_allclose(gd, want, rtol=0,
                               atol=REL * np.abs(want).max())


# the softmax layers on integer data: (op, attrs, data shape, label
# dtype or None); channel mode on 3D data, where it differs from instance
INT_SOFTMAX = [("SoftmaxActivation", {}, (4, 5), None),
               ("SoftmaxActivation", {"mode": "channel"}, (2, 3, 4), None)] + [
    (op, {}, (4, 5), lt) for op in ("SoftmaxOutput", "Softmax")
    for lt in ("float32", "int32")]


def _int_softmax_values(shape, dtype, label_dtype):
    rs = np.random.RandomState(21)
    lo = 0 if dtype == "uint8" else -9
    vals = [rs.randint(lo, 10, shape).astype(dtype)]
    if label_dtype is not None:
        vals.append(rs.randint(0, shape[-1], shape[0]).astype(label_dtype))
    return vals


def _int_softmax_id(case):
    return "%s%s-label=%s" % (case[0], "".join(
        "-%s=%s" % kv for kv in case[1].items()), case[3])


@pytest.mark.parametrize("dtype", ["int32", "int8"])
@pytest.mark.parametrize("case", INT_SOFTMAX,
                         ids=[_int_softmax_id(c) for c in INT_SOFTMAX])
def test_softmax_layers_on_integer_data_match_the_reference(case, dtype):
    """Integer data is widened to float32 first: float32 probabilities
    equal to the reference's within 1e-6."""
    op, attrs, shape, label_dtype = case
    vals = _int_softmax_values(shape, dtype, label_dtype)
    got = run(tmx, op, [], attrs, values=vals)
    assert got[0][1] == "float32"
    agree(got, run(jmx, op, [], attrs, values=vals), 1e-6, op)


@pytest.mark.parametrize("case", INT_SOFTMAX,
                         ids=[_int_softmax_id(c) for c in INT_SOFTMAX])
def test_softmax_layers_on_uint8_data_follow_the_formula(case):
    """uint8 against the formula in float64: the reference computes
    ``x - max`` in uint8, which wraps (ROADMAP Queue 3, traps)."""
    op, attrs, shape, label_dtype = case
    vals = _int_softmax_values(shape, "uint8", label_dtype)
    ((got, dtype),) = run(tmx, op, [], attrs, values=vals)
    x = vals[0].astype(np.float64)
    if attrs.get("mode") == "channel":
        e = np.exp(x - x.max(axis=1, keepdims=True))
        want = e / e.sum(axis=1, keepdims=True)
    else:
        e = np.exp(x - x.max(axis=-1, keepdims=True))
        want = e / e.sum(axis=-1, keepdims=True)
    assert dtype == "float32"
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_regression_label_takes_the_data_shape():
    data = tmx.sym.Variable("data")
    net = tmx.sym.LinearRegressionOutput(data, name="lro")
    args, outs, _ = net.infer_shape(data=(8, 3))
    assert dict(zip(net.list_arguments(), args))["lro_label"] == (8, 3)
    assert outs == [(8, 3)]
