"""The port's imperative plane (``mx.nd`` + ``mx.autograd``) against the
JAX package's.

Every case runs the same code on both packages (``pkg`` is
``mxnet_tpu`` or ``mxnet_tpu_torch``), each under its CPU context, on
the same numpy inputs, and compares the numpy results: exactly for
integers, booleans and plain arithmetic, within 1e-5 of the largest
reference value where the two sum or reduce in another order.  The
JAX package runs its plain XLA lowerings (``MXNET_PALLAS=0``); the
port's kernel wrappers take their plain versions on CPU tensors.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.models import transformer_lm as tlm

PKGS = (jmx, tmx)
REL = 1e-5   # of max|ref|: the two packages sum in another order


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
def _plain_reference(monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS", "0")


def _both(case):
    """``case(pkg)`` on each package under its CPU context, as numpy."""
    out = []
    for pkg in PKGS:
        with pkg.cpu():
            res = case(pkg)
        if isinstance(res, dict):
            res = {k: _np(v) for k, v in res.items()}
        else:
            res = [_np(v) for v in res]
        out.append(res)
    return out


def _np(v):
    return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)


def _close(got, want, rel=REL):
    items = got.items() if isinstance(got, dict) else enumerate(got)
    for k, g in items:
        w = want[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        if g.dtype.kind in "biu":
            assert np.array_equal(g, w), k
        else:
            tol = rel * max(float(np.abs(w).max()), 1e-30) if w.size else 0
            assert np.allclose(g, w, rtol=0, atol=tol, equal_nan=True), \
                (k, float(np.abs(g - w).max()), tol)


def _check(case, rel=REL):
    want, got = _both(case)
    _close(got, want, rel)


def _x(seed=0, shape=(3, 4)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# creation, dtypes and the context
# ---------------------------------------------------------------------------
SOURCES = {
    "list_float": [1.5, -2.0, 3.25],
    "list_int": [[1, 2], [3, 4]],
    "scalar": 2.0,
    "np_float64": np.linspace(-1, 1, 5),
    "np_float32": np.ones((2, 3), np.float32),
    "np_float16": np.arange(4).astype(np.float16),
    "np_int64": np.arange(6).reshape(2, 3),
    "np_int32": np.arange(3, dtype=np.int32),
    "np_int8": np.arange(-2, 2, dtype=np.int8),
    "np_bool": np.array([True, False]),
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_array_dtype_defaults_match_jax(name):
    src = SOURCES[name]
    _check(lambda pkg: [pkg.nd.array(src)])


@pytest.mark.parametrize("dtype", [None, "float32", "int32", np.float16])
def test_array_with_dtype_matches_jax(dtype):
    src = np.linspace(-3, 3, 7)
    _check(lambda pkg: [pkg.nd.array(src, dtype=dtype),
                        pkg.nd.array(pkg.nd.array(src), dtype=dtype)])


def test_creation_functions_match_jax():
    _check(lambda pkg: [
        pkg.nd.zeros((2, 3)), pkg.nd.ones(4), pkg.nd.full((2, 2), 7.5),
        pkg.nd.empty((3,)), pkg.nd.zeros((2,), dtype="int32"),
        pkg.nd.zeros_like(pkg.nd.array(_x())),
        pkg.nd.ones_like(pkg.nd.array(_x())),
        pkg.nd.arange(0, 5), pkg.nd.arange(1, 7, 2, repeat=2),
        pkg.nd.concatenate([pkg.nd.array(_x(0)), pkg.nd.array(_x(1))],
                           axis=1)])


def test_default_context_is_the_gpu_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmx.current_context() == tmx.gpu(0)
    for make in (lambda: tmx.nd.array([1.0]), lambda: tmx.nd.zeros((2,)),
                 lambda: tmx.nd.ones(3), lambda: tmx.nd.arange(3),
                 lambda: tmx.nd.array([1.0], ctx=tmx.gpu(0))):
        with pytest.raises(tmx.MXNetError, match="no CUDA device"):
            make()
    a = tmx.nd.array([1.0], ctx=tmx.cpu())
    assert a.context == tmx.cpu() and a._data.device.type == "cpu"
    with tmx.cpu() as ctx:
        assert tmx.current_context() == ctx == tmx.cpu(0)
        b = tmx.nd.array([1.0])
        with tmx.gpu(0):
            with pytest.raises(tmx.MXNetError):
                tmx.nd.zeros((1,))
        assert tmx.nd.ones((2,)).context == tmx.cpu()
    assert b.context == tmx.cpu()
    assert tmx.current_context() == tmx.gpu(0)
    with pytest.raises(tmx.MXNetError):
        tmx.Module(tmx.models.transformer_lm(seq_len=4))
    with tmx.cpu():
        tmx.Module(tmx.models.transformer_lm(seq_len=4))


def test_context_values_and_copies():
    assert str(tmx.cpu()) == "cpu(0)" and str(tmx.gpu(1)) == "gpu(1)"
    assert tmx.Context("gpu", 1) == tmx.gpu(1) != tmx.cpu()
    assert len({tmx.cpu(), tmx.Context(tmx.cpu())}) == 1
    with pytest.raises(tmx.MXNetError):
        tmx.Context("tpu")
    with tmx.cpu():
        a = tmx.nd.array(_x())
        b = a.copyto(tmx.cpu())
        c = a.as_in_context(tmx.cpu())
        d = tmx.nd.zeros(a.shape)
        a.copyto(d)
    assert c is a and b is not a
    assert np.array_equal(b.asnumpy(), a.asnumpy())
    assert np.array_equal(d.asnumpy(), a.asnumpy())


# ---------------------------------------------------------------------------
# arithmetic, comparisons, in-place ops, indexing
# ---------------------------------------------------------------------------
BINARY = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
    "pow": lambda a, b: abs(a) ** b, "mod": lambda a, b: a % b,
    "add_scalar": lambda a, b: a + 2, "radd": lambda a, b: 2 + a,
    "rsub": lambda a, b: 3 - a, "rmul": lambda a, b: 0.5 * a,
    "rdiv": lambda a, b: 2 / b, "rpow": lambda a, b: 2 ** a,
    "neg": lambda a, b: -a, "abs": lambda a, b: abs(a),
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
    "gt": lambda a, b: a > b, "ge": lambda a, b: a >= 0,
    "lt": lambda a, b: a < b, "le": lambda a, b: a <= 0.5,
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_arithmetic_and_comparisons_match_jax(op):
    x, y = _x(0), _x(1) + 3.0
    y[0, 0] = x[0, 0]
    _check(lambda pkg: [BINARY[op](pkg.nd.array(x), pkg.nd.array(y))])


def test_integer_arithmetic_matches_jax():
    x = np.arange(-3, 9, dtype=np.int32).reshape(3, 4)
    _check(lambda pkg: [pkg.nd.array(x) + 2, pkg.nd.array(x) * 3,
                        pkg.nd.array(x) + 0.5, pkg.nd.array(x) % 3,
                        pkg.nd.array(x) / 2])


INPLACE = {
    "iadd": lambda a, b: a.__iadd__(b),
    "isub": lambda a, b: a.__isub__(1),
    "imul": lambda a, b: a.__imul__(b),
    "idiv": lambda a, b: a.__itruediv__(2),
}


@pytest.mark.parametrize("op", sorted(INPLACE))
def test_inplace_ops_match_jax(op):
    def case(pkg):
        a, b = pkg.nd.array(_x(0)), pkg.nd.array(_x(1))
        res = INPLACE[op](a, b)
        assert res is a
        return [a]
    _check(case)


def test_indexing_and_views_match_jax():
    x = _x(2, (4, 5))
    _check(lambda pkg: [
        pkg.nd.array(x)[1], pkg.nd.array(x)[1:3], pkg.nd.array(x)[:, 2],
        pkg.nd.array(x)[-1, 1:4], pkg.nd.array(x).slice(1, 3),
        pkg.nd.array(x).slice_axis(1, 1, None), pkg.nd.array(x).at(2),
        pkg.nd.array(x).reshape((5, 4)), pkg.nd.array(x).reshape(2, 10),
        pkg.nd.array(x).astype("int32"), pkg.nd.array(x).T,
        pkg.nd.array(x).transpose((1, 0)), pkg.nd.array(x).flatten(),
        pkg.nd.array(x).expand_dims(1), pkg.nd.array(x[:1]).broadcast_to(
            (3, 5)), pkg.nd.array(x).copy(),
        pkg.nd.array(x)[pkg.nd.array(np.array([2, 0], np.int32))]])


def test_setitem_matches_jax():
    def case(pkg):
        a = pkg.nd.array(_x(3, (4, 5)))
        a[1] = 5.0
        a[2:4, 1:3] = pkg.nd.array(np.ones((2, 2), np.float32))
        a[0, :] = np.arange(5, dtype=np.float32)
        a[:, 4] = [7.0, 8.0, 9.0, 10.0]
        b = pkg.nd.zeros((2, 3))
        b[:] = 3
        c = pkg.nd.zeros((2, 3))
        c[:] = pkg.nd.array(_x(4, (2, 3)))
        return [a, b, c]
    _check(case)


def test_scalar_access_and_sync_match_jax():
    for pkg in PKGS:
        with pkg.cpu():
            a = pkg.nd.array([[2.5]])
            a.wait_to_read()
            pkg.nd.waitall()
            assert a.asscalar() == 2.5 and float(a) == 2.5 and int(a) == 2
            assert bool(a) and len(pkg.nd.zeros((3, 2))) == 3
            assert a.size == 1 and a.ndim == 2 and a.shape == (1, 1)
            with pytest.raises(pkg.MXNetError):
                pkg.nd.zeros((2,)).asscalar()


# ---------------------------------------------------------------------------
# reductions and imperative_invoke
# ---------------------------------------------------------------------------
REDUCE_KW = [{}, {"axis": 1}, {"axis": (0, 2)}, {"axis": 0, "keepdims": True},
             {"axis": 1, "exclude": True}]


@pytest.mark.parametrize("op", ["sum", "sum_axis", "mean", "prod", "nansum",
                                "nanprod", "max", "max_axis", "min",
                                "min_axis"])
def test_reduce_ops_match_jax(op):
    x = _x(5, (2, 3, 4))
    x[0, 1, 2] = np.nan if op.startswith("nan") else x[0, 1, 2]
    _check(lambda pkg: [getattr(pkg.nd, op)(pkg.nd.array(x), **kw)
                        for kw in REDUCE_KW])


def test_integer_and_arg_reductions_match_jax():
    xi = np.arange(24, dtype=np.int32).reshape(2, 3, 4) - 7
    x = _x(6, (3, 5))
    _check(lambda pkg: [
        pkg.nd.sum(pkg.nd.array(xi), axis=1), pkg.nd.prod(pkg.nd.array(xi)),
        pkg.nd.argmax(pkg.nd.array(x), axis=1),
        pkg.nd.argmin(pkg.nd.array(x), axis=0, keepdims=True),
        pkg.nd.argmax(pkg.nd.array(x)), pkg.nd.array(x).argmax(axis=0),
        pkg.nd.array(x).sum(), pkg.nd.array(x).mean(axis=1),
        pkg.nd.array(x).max(axis=0, keepdims=True), pkg.nd.array(x).min()])


@pytest.mark.parametrize("op,dtype,n,value", [
    ("sum", np.uint8, 300, 200), ("prod", np.int8, 4, 100),
    ("sum", np.bool_, 3, True), ("nansum", np.int16, 40000, 3),
    ("sum", np.uint16, 5, 60000), ("prod", np.int32, 3, 3000)])
def test_narrow_integer_reductions_match_jax(op, dtype, n, value):
    """jnp's promotion: a sum or product of int8/int16/bool is int32, of
    uint8/uint16 uint32, so 300 uint8 200s sum to 60000, not 96."""
    x = np.full((n,), value, dtype)
    got, want = _both(lambda pkg: [getattr(pkg.nd, op)(pkg.nd.array(
        x, dtype=x.dtype))])
    _close(got, want)
    assert got[0].dtype == want[0].dtype
    pinned = {("sum", np.uint8): 60000, ("prod", np.int8): 100000000,
              ("sum", np.bool_): 3}
    if (op, dtype) in pinned:
        assert int(got[0]) == pinned[op, dtype]


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min", "prod"])
@pytest.mark.parametrize("keepdims", [False, True])
def test_exclude_of_every_axis_reduces_nothing(op, keepdims):
    """``exclude=True`` naming every axis leaves no axis to reduce: the
    input comes back as it is, as jnp's ``axis=()``."""
    x = _x(12, (3, 4))
    xi = np.arange(12, dtype=np.int8).reshape(3, 4)
    _check(lambda pkg: [getattr(pkg.nd, op)(pkg.nd.array(a, dtype=a.dtype),
                                            axis=(0, 1), exclude=True,
                                            keepdims=keepdims)
                        for a in (x, xi)])


@pytest.mark.parametrize("case", ["iadd_half", "idiv", "imul", "broadcast",
                                  "same_dtype_view"])
def test_inplace_arithmetic_outside_record_matches_jax(case):
    """Outside ``record()`` a result of another dtype or shape rebinds
    the array, as the reference does; a result of the same dtype and
    shape is written in place, so a view sees it."""
    xi = np.array([[3, -4], [1, 5]], np.int32)

    def run(pkg):
        if case == "iadd_half":
            a = pkg.nd.array(xi, dtype=xi.dtype)
            a += 0.5
        elif case == "idiv":
            a = pkg.nd.array(xi, dtype=xi.dtype)
            a /= 2
        elif case == "imul":
            a = pkg.nd.array(xi, dtype=xi.dtype)
            a *= 1.5
        elif case == "broadcast":
            a = pkg.nd.array(np.array([[1.0, 2.0]], np.float32))
            a += pkg.nd.array(_x(13, (2, 2)))
        else:
            a = pkg.nd.array(xi, dtype=xi.dtype)
            a += 2
        return [a]
    got, want = _both(run)
    _close(got, want)
    if case == "iadd_half":
        assert got[0].dtype == np.float32
        assert got[0].ravel().tolist() == [3.5, -3.5, 1.5, 5.5]
    with tmx.cpu():
        a = tmx.nd.array(xi, dtype=xi.dtype)
        view = a[0]
        a += 2
        assert view.asnumpy().tolist() == [5, -2]


def test_scalar_ops_cast_the_scalar_to_the_input_dtype():
    """``_plus_scalar`` (and ``Symbol.__add__``, which emits it) casts
    the scalar to x's dtype: int32 x plus 2.7 is int32 x + 2."""
    xi = np.array([[3, -4], [1, 5]], np.int32)
    x = _x(14, (2, 2))
    _check(lambda pkg: [
        pkg.nd._plus_scalar(pkg.nd.array(xi, dtype=xi.dtype), scalar=2.7),
        pkg.nd._plus_scalar(pkg.nd.array(xi, dtype=xi.dtype), scalar=-2.7),
        pkg.nd._plus_scalar(pkg.nd.array(x), scalar=2.7)])
    got = tmx.nd._plus_scalar(tmx.nd.array(xi, dtype=xi.dtype, ctx=tmx.cpu()),
                              scalar=2.7).asnumpy()
    assert got.dtype == np.int32 and np.array_equal(got, xi + 2)
    for pkg in PKGS:
        sym = pkg.sym.Variable("x") + 2.7
        with pkg.cpu():
            exe = sym.bind(pkg.cpu(), {"x": pkg.nd.array(xi, dtype=xi.dtype)})
            out = exe.forward()[0].asnumpy()
        assert out.dtype == np.int32 and np.array_equal(out, xi + 2), pkg


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_embedding_ids_outside_the_table_follow_jnp_take(dtype):
    """Ids in [-n, 0) wrap to row n + id; other ids outside [0, n) give a
    NaN row (INT32_MIN for an int32 table), as ``jnp.take``."""
    table = (np.arange(12).reshape(4, 3) + 1).astype(dtype)
    ids = np.array([-5, -4, -1, 0, 3, 4], np.float32)
    got, want = _both(lambda pkg: [pkg.nd.Embedding(
        pkg.nd.array(ids), pkg.nd.array(table, dtype=table.dtype),
        input_dim=4, output_dim=3)])
    _close(got, want)
    rows = got[0]
    assert np.array_equal(rows[1:5], table[[0, 3, 0, 3]])
    for r in (rows[0], rows[5]):
        if dtype == np.float32:
            assert np.isnan(r).all()
        else:
            assert (r == np.iinfo(np.int32).min).all()


def test_imperative_invoke_out_and_named_inputs_match_jax():
    x, w, b = _x(7, (4, 6)), _x(8, (3, 6)), _x(9, (3,))

    def case(pkg):
        o = pkg.nd.zeros((4, 3))
        r = pkg.nd.FullyConnected(pkg.nd.array(x), pkg.nd.array(w),
                                  pkg.nd.array(b), num_hidden=3, out=o)
        assert r is o
        named = pkg.nd.FullyConnected(pkg.nd.array(x),
                                      weight=pkg.nd.array(w),
                                      bias=pkg.nd.array(b), num_hidden=3)
        t = pkg.nd.transpose(pkg.nd.array(x), axes=(1, 0))
        return [o, named, t, pkg.nd.Reshape(t, shape=(-1, 2)),
                pkg.nd.softmax(pkg.nd.array(x), axis=0),
                pkg.nd.log_softmax(pkg.nd.array(x), temperature=2.0),
                pkg.nd.SoftmaxActivation(pkg.nd.array(x)),
                pkg.nd.square(pkg.nd.array(x)), pkg.nd.exp(pkg.nd.array(x))]
    _check(case)


OPT = {
    "sgd_update": (1, dict(lr=0.1, wd=0.01, rescale_grad=0.5)),
    "sgd_mom_update": (2, dict(lr=0.1, momentum=0.9, clip_gradient=0.3)),
    "adam_update": (3, dict(lr=0.01, wd=0.001)),
    "rmsprop_update": (2, dict(lr=0.01, clip_weights=0.5)),
    "rmspropalex_update": (4, dict(lr=0.01)),
}


@pytest.mark.parametrize("op", sorted(OPT))
def test_optimizer_ops_and_mutate_match_jax(op):
    """Three updates with ``out=w``: the weight and every state the op
    mutates."""
    n_args, kw = OPT[op]

    def case(pkg):
        w = pkg.nd.array(_x(10))
        states = [pkg.nd.array(np.abs(_x(11 + i)) * 0.1)
                  for i in range(n_args - 1)]
        for step in range(3):
            g = pkg.nd.array(_x(20 + step))
            r = getattr(pkg.nd, op)(w, g, *states, out=w, **kw)
            assert r is w
        return [w] + states
    _check(case)


def test_optimizer_op_returns_a_new_weight_without_out():
    def case(pkg):
        w, g, m = (pkg.nd.array(_x(i)) for i in range(3))
        new = pkg.nd.sgd_mom_update(w, g, m, lr=0.1, momentum=0.5)
        return [w, new, m]
    _check(case)


def test_invoke_refuses_bad_inputs():
    with tmx.cpu():
        x = tmx.nd.array(_x())
        with pytest.raises(tmx.MXNetError, match="unknown attributes"):
            tmx.nd.softmax(x, bogus=1)
        with pytest.raises(tmx.MXNetError, match="takes 1 inputs"):
            tmx.nd.exp(x, x)
        with pytest.raises(tmx.MXNetError, match="missing"):
            tmx.nd.sgd_update(x, lr=0.1)
        with pytest.raises(tmx.MXNetError, match="NDArray inputs"):
            tmx.nd.exp(np.ones(3))


# ---------------------------------------------------------------------------
# autograd: tests/test_autograd.py's cases, then the reference's semantics
# where torch's differ
# ---------------------------------------------------------------------------
def test_autograd_basic_backward_matches_jax():
    def case(pkg):
        x = pkg.nd.array([1.0, 2.0, 3.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.sum(pkg.nd.square(x))
        y.backward()
        return [x.grad, y]
    _check(case)


def test_autograd_python_operator_gradients_match_jax():
    def case(pkg):
        x = pkg.nd.array([2.0, 3.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = (x * x + 2 * x).sum()
        y.backward()
        return [x.grad]
    want, got = _both(case)
    _close(got, want)
    assert np.allclose(got[0], [6, 8])


def test_autograd_chain_matches_jax():
    def case(pkg):
        x = pkg.nd.array([0.5])
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.exp(pkg.nd.sin(x))
        y.backward()
        return [x.grad]
    _check(case)


def test_autograd_grad_req_add_matches_jax():
    def case(pkg):
        x = pkg.nd.array([1.0])
        g = pkg.nd.zeros((1,))
        pkg.autograd.mark_variables([x], [g], "add")
        for _ in range(2):
            with pkg.autograd.record():
                y = x * 3
            pkg.autograd.backward([y])
        return [g]
    want, got = _both(case)
    _close(got, want)
    assert got[0].tolist() == [6.0]


def test_autograd_grad_and_loss_matches_jax():
    def case(pkg):
        def f(a, b):
            return pkg.nd.sum(a * a * b)
        grads, loss = pkg.autograd.grad_and_loss(f)(
            pkg.nd.array([1.0, 2.0]), pkg.nd.array([3.0, 4.0]))
        only = pkg.contrib.autograd.grad(f, argnum=1)(
            pkg.nd.array([1.0, 2.0]), pkg.nd.array([3.0, 4.0]))
        return grads + [loss] + only
    _check(case)


def test_autograd_train_mode_flags_match_jax():
    for pkg in PKGS:
        ag = pkg.autograd
        assert not ag.is_training() and not ag.is_recording()
        with ag.record():
            assert ag.is_training() and ag.is_recording()
            with ag.pause():
                assert not ag.is_recording() and not ag.is_training()
            with ag.predict_mode():
                assert ag.is_recording() and not ag.is_training()
        with ag.train_mode():
            assert ag.is_training() and not ag.is_recording()
        with ag.record(train_mode_=False):
            assert ag.is_recording() and not ag.is_training()
        with ag.train_section():
            assert ag.is_recording()
            with ag.test_section():
                assert not ag.is_recording()
        assert not ag.is_recording() and not ag.is_training()
        assert ag.set_recording(True) is False
        assert ag.set_recording(False) is True
        assert ag.set_training(True) is False
        assert pkg.contrib.autograd.set_is_training(False) is True


def test_autograd_head_grads_match_jax():
    def case(pkg):
        x = pkg.nd.array([1.0, 2.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = x * 2
            z = pkg.nd.exp(x)
        pkg.autograd.backward([y, z], [pkg.nd.array([10.0, 100.0]),
                                       pkg.nd.array([1.0, -1.0])])
        gx = x.grad.asnumpy()
        with pkg.autograd.record():
            y = x * 2
        y.backward(pkg.nd.array([3.0, 4.0]))
        return [gx, x.grad]
    _check(case)


def test_autograd_mutated_variable_matches_jax():
    """Rebinding a recorded variable mid-record: the gradient is the one
    of the value the output consumed."""
    def case(pkg):
        x = pkg.nd.array([1.0])
        x.attach_grad()
        with pkg.autograd.record():
            pkg.nd.square(x)
            x[:] = 3.0
            y2 = pkg.nd.square(x)
        pkg.autograd.backward([y2])
        return [x.grad]
    want, got = _both(case)
    _close(got, want)
    assert got[0].tolist() == [6.0]


def test_autograd_layer_op_recording_matches_jax():
    """A layer op with parameters records under the tape (the JAX
    package's case records BatchNorm, which the port has not ported:
    LayerNorm and RMSNorm stand in)."""
    x = _x(12, (4, 3))

    def case(pkg):
        data = pkg.nd.array(x)
        gamma, beta = pkg.nd.ones((3,)), pkg.nd.zeros((3,))
        g2 = pkg.nd.array([0.5, 1.0, 2.0])
        for v in (data, gamma, beta, g2):
            v.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.LayerNorm(data, gamma, beta)
            out = pkg.nd.RMSNorm(out * 1.5 + 0.25, g2)
            loss = pkg.nd.sum(out * out * pkg.nd.array(x))
        loss.backward()
        return [out, data.grad, gamma.grad, beta.grad, g2.grad]
    _check(case, rel=1e-4)


def test_autograd_mark_variables_write_add_null_match_jax():
    def case(pkg):
        a, b, c = (pkg.nd.array(_x(i, (3,))) for i in range(3))
        ga, gb, gc = (pkg.nd.ones((3,)) for _ in range(3))
        pkg.autograd.mark_variables([a, b, c], [ga, gb, gc],
                                    ["write", "add", "null"])
        for _ in range(2):
            with pkg.autograd.record():
                y = pkg.nd.sum(a * b * c)
            y.backward()
        return [ga, gb, gc]
    want, got = _both(case)
    _close(got, want)
    assert np.array_equal(got[2], np.ones(3, np.float32))


def test_autograd_unreached_variable_keeps_its_buffer():
    """A marked variable the outputs do not depend on keeps its gradient
    buffer unchanged (not zeroed), as the reference's tape does."""
    def case(pkg):
        x, u = pkg.nd.array([1.0, 2.0]), pkg.nd.array([5.0])
        gu = pkg.nd.array([7.0])
        pkg.autograd.mark_variables([x, u], [pkg.nd.zeros((2,)), gu])
        with pkg.autograd.record():
            y = pkg.nd.sum(x * x)
        y.backward()
        return [x.grad, u.grad]
    want, got = _both(case)
    _close(got, want)
    assert got[1].tolist() == [7.0]


def test_autograd_second_backward_after_the_tape_is_cleared():
    """After a backward without retain_graph the tape is cleared: a
    second backward reaches no variable (no error, buffers unchanged);
    with retain_graph the second backward repeats the first."""
    def case(pkg):
        x = pkg.nd.array([1.0, 2.0])
        x.attach_grad()
        with pkg.autograd.record():
            h = x * x
            y = pkg.nd.sum(h * 3)
        y.backward(retain_graph=True)
        first = x.grad.asnumpy()
        x.grad[:] = 0
        y.backward()
        second = x.grad.asnumpy()
        x.grad[:] = -1
        y.backward()
        with pkg.autograd.record():
            z = pkg.nd.sum(h * x)   # h was recorded on the cleared tape
        z.backward()
        return [first, second, x.grad]
    want, got = _both(case)
    _close(got, want)
    assert np.array_equal(got[0], got[1])


def test_autograd_records_nothing_outside_record():
    with tmx.cpu():
        x = tmx.nd.array([1.0, 2.0])
        x.attach_grad()
        y = x * 2 + tmx.nd.exp(x)
        assert not y._data.requires_grad and y._data.grad_fn is None
        y.backward()
        assert x.grad.asnumpy().tolist() == [0.0, 0.0]
        with tmx.autograd.record():
            with tmx.autograd.pause():
                z = x * 2
            w = x * 2
        assert z._data.grad_fn is None and w._data.grad_fn is not None
        assert x._data.is_leaf


def test_autograd_blockgrad_and_make_loss():
    """Forward values against the JAX package's; gradients against
    their formulas.  The JAX package's eager tape keys gradients by array
    identity, and these identity-forward ops return their input array
    object there, so its tape also hands the head gradient to the input
    (BlockGrad passes the gradient; make_loss adds the head's ones): a
    reference fault, ROADMAP Queue 3."""
    x0 = _x(13, (2, 3))

    def case(pkg):
        x = pkg.nd.array(x0)
        outs = []
        for which in range(3):
            x.attach_grad()
            with pkg.autograd.record():
                if which == 0:
                    y = pkg.nd.sum(pkg.nd.BlockGrad(x) * x) + pkg.nd.sum(
                        pkg.nd.stop_gradient(x))
                elif which == 1:
                    y = pkg.nd.make_loss(x * 2, grad_scale=0.5)
                else:
                    y = pkg.nd.MakeLoss(x * x, normalization="valid",
                                        valid_thresh=0.5)
            y.backward()
            outs += [y, x.grad.asnumpy()]
        return outs
    want, got = _both(case)
    _close(got[0::2], want[0::2])
    valid = max(int(np.sum(x0 * x0 > 0.5)), 1)
    for g, w in zip(got[1::2], (x0, np.ones_like(x0), 2 * x0 / valid)):
        assert np.allclose(g, w, rtol=1e-6, atol=0)


def test_optimizer_write_keeps_the_parameter_a_leaf():
    with tmx.cpu():
        w = tmx.nd.array(_x())
        mom = tmx.nd.zeros(w.shape)
        w.attach_grad()
        for _ in range(2):
            with tmx.autograd.record():
                loss = tmx.nd.sum(w * w)
            loss.backward()
            tmx.nd.sgd_mom_update(w, w.grad, mom, lr=0.1, momentum=0.9,
                                  out=w)
            assert w._data.is_leaf and w._data.requires_grad
            assert not mom._data.requires_grad


# ---------------------------------------------------------------------------
# the slice: imperative SGD-momentum steps of the transformer LM
# ---------------------------------------------------------------------------
SPEC = tlm.lm_spec(num_layers=2, num_hidden=64, num_heads=4, vocab_size=256)
SEQ, BATCH, STEPS = 16, 4, 3
LR, MOMENTUM = 0.005, 0.9


def _lm_steps(pkg, params, batches):
    """STEPS imperative steps; returns the losses and the final
    parameters.  The JAX package runs the port's ``imperative_loss`` too:
    it only calls ``pkg.nd`` ops."""
    w = {k: pkg.nd.array(v) for k, v in params.items()}
    mom = {k: pkg.nd.zeros(v.shape) for k, v in params.items()}
    for v in w.values():
        v.attach_grad()
    losses = []
    for X, y in batches:
        data, label = pkg.nd.array(X), pkg.nd.array(y)
        with pkg.autograd.record():
            loss = tlm.imperative_loss(pkg.nd, w, data, label, SEQ, SPEC)
        loss.backward()
        losses.append(loss.asnumpy())
        for k in w:
            pkg.nd.sgd_mom_update(w[k], w[k].grad, mom[k], lr=LR,
                                  momentum=MOMENTUM, rescale_grad=1 / BATCH,
                                  out=w[k])
    return dict(loss=np.concatenate(losses), **w)


def test_imperative_lm_training_matches_jax():
    """Three imperative SGD-momentum steps of the LM from identical
    parameters: loss and every parameter within 1e-5 x max|ref|."""
    params = tlm.random_params(SPEC, seed=4)
    rs = np.random.RandomState(5)
    batches = []
    for _ in range(STEPS):
        X = rs.randint(0, SPEC["vocab_size"], (BATCH, SEQ))
        batches.append((X.astype(np.float32),
                        ((X + 1) % SPEC["vocab_size"]).astype(np.float32)))
    want, got = _both(lambda pkg: _lm_steps(pkg, params, batches))
    assert set(got) == set(params) | {"loss"}
    _close(got, want)
    assert got["loss"][-1] < got["loss"][0]
