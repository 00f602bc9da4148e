"""The port's elementwise ops (``mxnet_tpu_torch/ops/elemwise.py``)
against ``mxnet_tpu``'s: unary math, ``smooth_l1``, the same-shape
binary ops, ``broadcast_*``, every ``*_scalar`` op, the comparisons and
``add_n``, forward and backward (the rules are in
``tests/test_torch_ops_common.py``)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from test_torch_ops_common import (BF16, EXACT, REL, _one_torch_thread,  # noqa: F401
                                   arr, check, run)

S = (6, 8)   # every elementwise case's shape: JAX compiles once a dtype

# (op, domain, tolerance) on float32 input
UNARY = [
    ("relu", "nz", EXACT), ("sigmoid", "f", REL), ("softsign", "f", REL),
    ("tanh", "f", REL), ("negative", "f", EXACT), ("abs", "nz", EXACT),
    ("sign", "nz", EXACT), ("round", "quarter", EXACT),
    ("rint", "quarter", EXACT), ("ceil", "quarter", EXACT),
    ("floor", "quarter", EXACT), ("trunc", "quarter", EXACT),
    ("fix", "quarter", EXACT), ("square", "f", EXACT), ("sqrt", "pos", REL),
    ("rsqrt", "pos", REL), ("cbrt", "nz", REL), ("rcbrt", "nz", REL),
    ("exp", "f", REL), ("log", "pos", REL), ("log10", "pos", REL),
    ("log2", "pos", REL), ("log1p", "pos", REL), ("expm1", "f", REL),
    ("sin", "f", REL), ("cos", "f", REL), ("tan", "unit", REL),
    ("arcsin", "unit", REL), ("arccos", "unit", REL), ("arctan", "f", REL),
    ("sinh", "f", REL), ("cosh", "f", REL), ("arcsinh", "f", REL),
    ("arccosh", "gt1", REL), ("arctanh", "unit", REL),
    ("degrees", "f", REL), ("radians", "f", REL), ("gamma", "pos", REL),
    ("gamma", "negfrac", REL), ("gammaln", "pos", REL), ("erf", "f", REL),
    ("_copy", "f", EXACT), ("identity", "f", EXACT),
]
# ops whose gradient is 0 almost everywhere: forward only; the identity
# copies against the formula (test_copy_gradient_is_the_head_gradient)
_FLAT = {"sign", "round", "rint", "ceil", "floor", "trunc", "fix", "_copy",
         "identity"}


@pytest.mark.parametrize("op,domain,tol", UNARY,
                         ids=["%s-%s" % c[:2] for c in UNARY])
def test_unary_forward(op, domain, tol):
    check(op, [arr(S, domain)], tol=tol)


@pytest.mark.parametrize("op,domain", [c[:2] for c in UNARY
                                       if c[0] not in _FLAT],
                         ids=["%s-%s" % c[:2] for c in UNARY
                              if c[0] not in _FLAT])
def test_unary_backward(op, domain):
    check(op, [arr(S, domain)], grad=True)


@pytest.mark.parametrize("op", ["_copy", "identity"])
def test_copy_gradient_is_the_head_gradient(op):
    """The JAX package's eager tape sends the head gradient to the input
    of an op that returns its input array twice (2 x head; ROADMAP Queue
    3, traps); the port's is the head gradient itself."""
    (out, _), (g, _) = run(tmx, op, [arr(S)], grad=True)
    np.testing.assert_array_equal(out, run(tmx, "negative", [arr(S)])[0][0]
                                  * -1)
    head = np.random.RandomState(1).randn(*S).astype(np.float32)
    np.testing.assert_array_equal(g, head)


# integer input: the IEEE-exact ops keep int32; the rest return float32
@pytest.mark.parametrize("op", ["relu", "negative", "abs", "sign", "round",
                                "rint", "ceil", "floor", "trunc", "fix",
                                "square", "_copy", "sqrt", "exp", "log"])
def test_unary_on_int32(op):
    check(op, [arr(S, "ipos" if op in ("sqrt", "log") else "i")], tol=EXACT
          if op not in ("sqrt", "exp", "log") else REL)


def test_smooth_l1_forward_and_its_gradient_formula():
    for scalar in (1.0, 2.0, 0.5):
        check("smooth_l1", [arr(S, "quarter")], {"scalar": scalar})
        check("smooth_l1", [arr(S, "f")], {"scalar": scalar}, grad=True)
        (out, _), (g, _) = run(tmx, "smooth_l1", [arr(S, "f")],
                               {"scalar": scalar}, grad=True)
        x = run(tmx, "_copy", [arr(S, "f")])[0][0]
        head = np.random.RandomState(1).randn(*S).astype(np.float32)
        s2 = scalar ** 2
        want = np.where(np.abs(x) < 1 / s2, s2 * x, np.sign(x)) * head
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=REL * np.abs(want).max())


# ---------------------------------------------------------------------------
# binary: same shape
# ---------------------------------------------------------------------------
_ARITH = ["elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
          "_plus", "_add", "_minus", "_sub", "_mul", "_div", "_grad_add",
          "_maximum", "_minimum"]
# (op, lhs domain, rhs domain, tolerance)
BINARY = [(op, "f", "nz", EXACT) for op in _ARITH] + [
    ("_power", "pos", "f", REL), ("_hypot", "f", "f", REL),
    ("_mod", "f", "nz", REL)]


# aliases share their op's function: forward only
_ALIASES = {"_plus", "_add", "_minus", "_sub", "_mul", "_div",
            "broadcast_plus", "broadcast_minus"}


@pytest.mark.parametrize("op,ld,rd,tol", BINARY, ids=[c[0] for c in BINARY])
def test_binary_forward_and_backward(op, ld, rd, tol):
    check(op, [arr(S, ld), arr(S, rd)], tol=tol)
    if op not in _ALIASES:
        check(op, [arr(S, ld), arr(S, rd)], grad=True)


@pytest.mark.parametrize("op", ["elemwise_add", "elemwise_sub",
                                "elemwise_mul", "elemwise_div", "_maximum",
                                "_minimum", "_mod", "_hypot"])
def test_binary_on_int32(op):
    check(op, [arr(S, "i"), arr(S, "inz")], tol=EXACT if op != "_hypot"
          else REL)


def test_int_power_with_nonnegative_exponents_matches_the_reference():
    lhs = np.array([[-3, 3, 1, -1, 2, 0, 5, -2]], np.int32)
    rhs = np.array([[2, 3, 5, 3, 0, 4, 2, 1]], np.int32)
    check("_power", [], tol=EXACT, values=[lhs, rhs])


def test_int_power_with_negative_exponents_is_the_truncated_real_power():
    """The reference's XLA integer power is undefined below -1 ((-3) **
    -2 gives 703701817 there); the port gives trunc(real power), as
    MXNet does: 0 but for bases 1 and -1."""
    lhs = np.array([[-3, 3, 1, -1, -1, 2, 7, 1]], np.int32)
    rhs = np.array([[-2, -3, -5, -3, -2, -1, -4, -1]], np.int32)
    want = np.trunc(np.power(lhs.astype(np.float64),
                             rhs.astype(np.float64))).astype(np.int32)
    got, dt = run(tmx, "_power", [], values=[lhs, rhs])[0]
    assert dt == "int32"
    np.testing.assert_array_equal(got, want)
    got, _ = run(tmx, "_power_scalar", [], {"scalar": -2},
                 values=[lhs])[0]
    np.testing.assert_array_equal(
        got, np.trunc(lhs.astype(np.float64) ** -2.0).astype(np.int32))


@pytest.mark.parametrize("op", ["elemwise_add", "elemwise_sub",
                                "elemwise_mul", "elemwise_div", "_maximum",
                                "_minimum", "_power", "_hypot", "_mod"])
def test_binary_on_bf16(op):
    ld = "pos" if op == "_power" else "f"
    check(op, [arr(S, ld, "bfloat16"), arr(S, "nz", "bfloat16")], tol=BF16)


# ---------------------------------------------------------------------------
# binary: broadcasting, and the comparisons (float32 0/1)
# ---------------------------------------------------------------------------
_BCAST_ARITH = ["broadcast_add", "broadcast_plus", "broadcast_sub",
                "broadcast_minus", "broadcast_mul", "broadcast_div",
                "broadcast_maximum", "broadcast_minimum", "broadcast_power",
                "broadcast_hypot", "broadcast_mod"]
_COMPARE = ["broadcast_equal", "broadcast_not_equal", "broadcast_greater",
            "broadcast_greater_equal", "broadcast_lesser",
            "broadcast_lesser_equal", "_equal", "_not_equal", "_greater",
            "_greater_equal", "_lesser", "_lesser_equal"]
_PAIRS = {"row": (S, (1, S[1])), "outer": ((S[0], 1), (1, S[1]))}


def _bcast_specs(op, pair, dtype="float32"):
    lhs, rhs = _PAIRS[pair]
    ld = "pos" if op == "broadcast_power" else "f"
    return [arr(lhs, ld, dtype), arr(rhs, "nz", dtype)]


@pytest.mark.parametrize("pair", sorted(_PAIRS))
@pytest.mark.parametrize("op", _BCAST_ARITH)
def test_broadcast_forward_and_backward(op, pair):
    tol = REL if op in ("broadcast_power", "broadcast_hypot",
                        "broadcast_mod") else EXACT
    check(op, _bcast_specs(op, pair), tol=tol)
    if pair == "outer" and op not in _ALIASES:
        check(op, _bcast_specs(op, pair), grad=True)


@pytest.mark.parametrize("op", _BCAST_ARITH[::2] + _COMPARE[:6])
def test_broadcast_on_bf16(op):
    check(op, _bcast_specs(op, "outer", "bfloat16"), tol=BF16)


@pytest.mark.parametrize("op", _COMPARE)
def test_comparisons_return_float32(op):
    lhs, rhs = _PAIRS["row"] if op.startswith("broadcast") else (S, S)
    # the same-shape names are aliases: float32 only
    for dtype in ("float32", "int32", "bfloat16")[
            :3 if op.startswith("broadcast") else 1]:
        d = "i" if dtype == "int32" else "ties"
        check(op, [arr(lhs, d, dtype), arr(rhs, d, dtype)], tol=EXACT)
        assert run(tmx, op, [arr(lhs, d, dtype), arr(rhs, d, dtype)]
                   )[0][1] == "float32"


def test_ndarray_comparison_operators_stay_bool():
    x, y = (np.random.RandomState(i).randint(-2, 3, S).astype(np.float32)
            for i in (0, 1))
    for pkg in (jmx, tmx):
        with pkg.cpu():
            a, b = pkg.nd.array(x), pkg.nd.array(y)
            for res in (a == b, a != b, a > b, a >= b, a < b, a <= b):
                assert res.asnumpy().dtype == np.bool_


# ---------------------------------------------------------------------------
# scalar ops: the scalar is cast to x's dtype; comparisons keep x's dtype
# ---------------------------------------------------------------------------
_SCALAR = ["_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
           "_div_scalar", "_rdiv_scalar", "_maximum_scalar",
           "_minimum_scalar", "_power_scalar", "_rpower_scalar",
           "_mod_scalar", "_rmod_scalar", "_hypot_scalar"]
_SCALAR_COMPARE = ["_equal_scalar", "_not_equal_scalar", "_greater_scalar",
                   "_greater_equal_scalar", "_lesser_scalar",
                   "_lesser_equal_scalar"]


def _scalar_domain(op):
    return {"_power_scalar": "pos", "_rdiv_scalar": "nz",
            "_rmod_scalar": "nz"}.get(op, "f")


@pytest.mark.parametrize("scalar", [1.5, -0.75])
@pytest.mark.parametrize("op", _SCALAR)
def test_scalar_ops_forward_and_backward(op, scalar):
    tol = REL if op in ("_power_scalar", "_rpower_scalar", "_hypot_scalar",
                        "_mod_scalar", "_rmod_scalar") else EXACT
    x = [arr(S, _scalar_domain(op))]
    check(op, x, {"scalar": scalar}, tol=tol)
    if scalar > 0:
        check(op, x, {"scalar": scalar}, grad=True)


@pytest.mark.parametrize("op", _SCALAR + _SCALAR_COMPARE)
def test_scalar_ops_on_int32_cast_the_scalar(op):
    domain = "ipos" if op in ("_rdiv_scalar", "_rmod_scalar",
                              "_power_scalar") else "i"
    for scalar in (2.7, -2.0):
        if op in ("_power_scalar", "_rpower_scalar") and scalar < 0:
            # a negative integer power: the reference raises (a scalar
            # exponent) or is undefined (a negative base); the port's is
            # held to the formula in test_int_power_with_negative_...
            continue
        check(op, [arr(S, domain)], {"scalar": scalar},
              tol=REL if op == "_hypot_scalar" else EXACT)


@pytest.mark.parametrize("op", _SCALAR_COMPARE)
def test_scalar_comparisons_keep_the_input_dtype(op):
    for dtype in ("float32", "bfloat16"):
        check(op, [arr(S, "ties", dtype)], {"scalar": 0.5}, tol=EXACT)
    assert run(tmx, op, [arr(S, "ties")], {"scalar": 0.5})[0][1] == \
        "float32"


@pytest.mark.parametrize("op", ["_plus_scalar", "_mul_scalar",
                                "_div_scalar", "_rminus_scalar"])
def test_scalar_ops_on_bf16(op):
    check(op, [arr(S, "nz", "bfloat16")], {"scalar": 1.5}, tol=BF16)


# ---------------------------------------------------------------------------
# n-ary sum
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", ["add_n", "ElementWiseSum", "_sum"])
def test_add_n_counts_its_inputs(op):
    specs = [arr(S), arr(S), arr(S)]
    check(op, specs, tol=EXACT)
    check(op, specs, grad=True)
    check(op, [arr(S, "i"), arr(S, "i")], tol=EXACT)
