"""The imperative plane in mixed precision: ``mx.nd.Cast`` under
``mx.autograd.record()`` and ``mx.nd.softmax_cross_entropy`` on bf16
logits, the port against the JAX package on the CPU.

First the two repairs the path needs: ``NDArray.dtype`` of a bf16 array
(``ml_dtypes``' dtype where that imports, a stand-in that every dtype
argument takes back where it does not), and ``NDArray.astype`` as a
copy outside the tape, with ``Cast`` the recorded cast, as in the
reference.  Then ``Cast`` / ``cast`` against the reference's, values
and gradients, imperative and symbolic.  Then the bf16 plain versions of
``softmax_xent_loss`` against the Pallas kernels in interpret mode: the
loss float32 within ``1e-5`` x max|ref| (both widen to fp32 and sum in
another order), the gradient bf16 within one bf16 ulp of max|ref| (both
round once).  Last, imperative bf16 steps of the tiny LM
(``imperative_loss(..., compute_dtype='bfloat16')``) on both packages
from identical parameters, with the reference's Pallas route forced
(``MXNET_PALLAS=2``): the route whose arithmetic the port's kernels
follow (see ``test_bf16_loss_op_against_the_reference_default_route``
for the other).
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.pallas_ops import softmax_xent as jsx
from mxnet_tpu_torch.kernels import _build, softmax_xent
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.ndarray import NamedDtype, _torch_dtype
from test_torch_cuda import bf16_ulp

BF16 = torch.bfloat16
LOSS_TOL = 2e-2    # of |ref|: the repo's bf16 bound on the logits and loss
GRAD_TOL = 5e-2    # of max|ref| per gradient (tests/test_torch_train_bf16.py)
PARAM_TOL = 1e-2   # of max|ref| per parameter after three steps (the same)


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


def _f32(a):
    """An array of either package (bf16 widened) as fp32 numpy."""
    return np.asarray(a.asnumpy(), np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the repairs: NDArray.dtype of bf16, astype outside the tape
# ---------------------------------------------------------------------------
def test_bf16_dtype_is_ml_dtypes_bfloat16_where_that_imports():
    """With ``ml_dtypes`` importable the port returns the reference's
    dtype object."""
    x = np.ones(3, np.float32)
    with tmx.cpu():
        got = tmx.nd.array(x).astype("bfloat16").dtype
    with jmx.cpu():
        want = jmx.nd.array(x).astype("bfloat16").dtype
    assert got == want == np.dtype(ml_dtypes.bfloat16)
    assert isinstance(got, np.dtype) and got.name == "bfloat16"


def test_bf16_dtype_without_ml_dtypes_is_a_stand_in_taken_back(
        monkeypatch):
    """Where ``ml_dtypes`` does not import (the card machine), the dtype
    is a stand-in equal to ``'bfloat16'`` that ``_torch_dtype``,
    ``nd.array(..., dtype=)``, ``astype`` and ``Cast`` take back."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with tmx.cpu():
        x = tmx.nd.array(np.float32([1.5, -2.25, 3.0])).astype("bfloat16")
        dt = x.dtype
        assert isinstance(dt, NamedDtype)
        assert dt == "bfloat16" and dt.name == "bfloat16" and dt.itemsize == 2
        assert _torch_dtype(dt) == BF16
        for y in (tmx.nd.array(np.ones(3), dtype=dt), x.astype(dt),
                  tmx.nd.Cast(x, dtype=dt), tmx.nd.cast(x, dtype=dt),
                  tmx.nd.zeros((2,), dtype=dt)):
            assert y._data.dtype == BF16 and y.dtype == "bfloat16"
        assert tmx.nd.array(np.ones(2)).dtype == np.float32


def test_bf16_dtype_in_a_process_that_never_imported_ml_dtypes():
    """The card machine's case end to end: a fresh interpreter with
    ``ml_dtypes`` hidden before numpy has heard of bfloat16 (this
    process's numpy learnt the name when JAX imported ``ml_dtypes``)."""
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import numpy as np, mxnet_tpu_torch as mx\n"
        "with mx.cpu():\n"
        "    x = mx.nd.array([1.0, 2.0]).astype('bfloat16')\n"
        "    d = x.dtype\n"
        "    y = mx.nd.Cast(mx.nd.array(np.ones(2), dtype=d), dtype=d)\n"
        "    z = y.astype(d)\n"
        "print(d, d == 'bfloat16', z.dtype, 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.split() == ["bfloat16", "True", "bfloat16", "False"]


@pytest.mark.parametrize("how", ["astype", "Cast", "cast"])
def test_astype_is_outside_the_tape_and_cast_recorded(how):
    """The reference's probe: ``(w.astype('bfloat16') * 2).sum()`` under
    ``record()`` leaves ``w.grad`` at zero; through ``Cast`` it is 2,
    float32, in both packages."""
    res = []
    for pkg in (jmx, tmx):
        with pkg.cpu():
            w = pkg.nd.array(np.arange(4, dtype=np.float32))
            w.attach_grad()
            with pkg.autograd.record():
                c = (w.astype("bfloat16") if how == "astype"
                     else getattr(pkg.nd, how)(w, dtype="bfloat16"))
                y = (c * 2).sum()
            y.backward()
            assert c.dtype == "bfloat16" and w.grad.dtype == np.float32
            res.append(w.grad.asnumpy())
    want = np.zeros(4) if how == "astype" else np.full(4, 2.0)
    assert np.array_equal(res[0], want) and np.array_equal(res[1], want)


# ---------------------------------------------------------------------------
# Cast / cast
# ---------------------------------------------------------------------------
CAST_SRC = (np.random.RandomState(0).randn(4, 5) * 300).astype(np.float32)


@pytest.mark.parametrize("chain", [("bfloat16", "float32"), ("float16",),
                                   ("int32",), ("int32", "float32"),
                                   ("bfloat16",), ("float32",)])
def test_cast_values_and_dtypes_match_jax(chain):
    """fp32 -> bf16 -> fp32, fp32 -> fp16, fp32 -> int32 (truncation)
    and back: the same values (bf16 widened) and dtype names."""
    res = []
    for pkg in (jmx, tmx):
        with pkg.cpu():
            x = pkg.nd.array(CAST_SRC)
            for i, dt in enumerate(chain):
                x = (pkg.nd.Cast if i % 2 else pkg.nd.cast)(x, dtype=dt)
            res.append((str(x.dtype), x.shape, _f32(x)))
    assert res[0][:2] == res[1][:2] == (chain[-1], CAST_SRC.shape)
    assert np.array_equal(res[0][2], res[1][2])


@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
def test_cast_gradient_reaches_the_fp32_leaf_exactly(dt):
    """``sum(Cast(w, dt) * v)`` with ``v`` in ``dt``: the gradient is ``v``
    cast back, float32, bit for bit the reference's."""
    v = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    res = []
    for pkg in (jmx, tmx):
        with pkg.cpu():
            w = pkg.nd.array(CAST_SRC / 300)
            vv = pkg.nd.array(v).astype(dt)
            w.attach_grad()
            with pkg.autograd.record():
                y = (pkg.nd.Cast(w, dtype=dt) * vv).sum()
            y.backward()
            assert w.grad.dtype == np.float32
            res.append((w.grad.asnumpy(), _f32(vv)))
    assert np.array_equal(res[0][0], res[1][0])
    assert np.array_equal(res[1][0], res[1][1])


def test_sym_cast_through_the_executor_matches_jax():
    """``MakeLoss(sum(square(Cast(Cast(data, bf16), fp32))))`` bound and
    run by each package's executor: the output and the data gradient
    (rounded to bf16 on its way back through the inner Cast) equal."""
    res = []
    for pkg in (jmx, tmx):
        d = pkg.sym.Variable("data")
        inner = pkg.sym.cast(pkg.sym.Cast(d, dtype="bfloat16"),
                             dtype="float32")
        net = pkg.sym.MakeLoss(pkg.sym.sum(pkg.sym.square(inner)))
        ex = net.simple_bind(pkg.cpu(), data=CAST_SRC.shape)
        ex.arg_dict["data"][:] = CAST_SRC / 100
        ex.forward(is_train=True)
        out = ex.outputs[0].asnumpy()
        ex.backward()
        grad = ex.grad_dict["data"]
        assert grad.dtype == np.float32
        res.append((out, grad.asnumpy()))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-6)
    assert np.array_equal(res[1][1], res[0][1])
    b16 = torch.from_numpy(CAST_SRC / 100).to(BF16)
    assert np.array_equal(res[1][1], (2 * b16.float()).to(BF16).float()
                          .numpy())


def test_cast_needs_its_dtype():
    with tmx.cpu(), pytest.raises(tmx.base.MXNetError, match="dtype"):
        tmx.nd.Cast(tmx.nd.ones((2,)))


# ---------------------------------------------------------------------------
# softmax_xent_loss on bf16 logits: the plain versions vs Pallas interpret
# ---------------------------------------------------------------------------
def _xent_case(rows, cols, seed):
    """bf16 logits (fp32 numpy rounded alike on both sides), float32
    labels random then at 0, the last column and outside on both sides,
    and a per-row cotangent."""
    rs = np.random.RandomState(seed)
    x = (3 * rs.randn(rows, cols)).astype(np.float32)
    lbl = rs.randint(0, cols, rows).astype(np.float32)
    lbl[:4] = [0, cols - 1, -1, cols]
    g = rs.uniform(0.5, 2.0, rows).astype(np.float32)
    xt = torch.from_numpy(x).to(BF16)
    return jnp.asarray(x).astype(jnp.bfloat16), xt, lbl, g


@pytest.mark.parametrize("rows,cols", [(12, 2), (16, 256), (9, 13)])
def test_bf16_xent_plain_versions_match_pallas_interpret(rows, cols):
    """``softmax_xent.py:194 softmax_xent_loss`` on bf16 logits: the loss
    float32 within 1e-5 x max|ref|, the gradient bf16 within one bf16
    ulp of max|ref|, through the wrappers and the autograd pair."""
    jx, tx, lbl, g = _xent_case(rows, cols, rows * cols)
    want, vjp = jax.vjp(lambda a: jsx.softmax_xent_loss(
        a, jnp.asarray(lbl), 8, True), jx)
    (want_grad,) = vjp(jnp.asarray(g))
    assert want.dtype == jnp.float32 and want_grad.dtype == jnp.bfloat16
    want = np.asarray(want)
    want_grad = np.asarray(want_grad.astype(jnp.float32))
    tl, tg = torch.from_numpy(lbl), torch.from_numpy(g)
    leaf = tx.clone().requires_grad_(True)
    loss = softmax_xent.softmax_xent_loss(leaf, tl)
    loss.backward(tg)
    for got_loss, got_grad in (
            (loss.detach(), leaf.grad),
            (softmax_xent.xent_loss_rows(tx, tl),
             softmax_xent.softmax_xent_loss_grad(tx, tl, tg))):
        assert got_loss.dtype == torch.float32 and got_grad.dtype == BF16
        assert np.abs(got_loss.numpy() - want).max() <= \
            1e-5 * np.abs(want).max()
        assert np.abs(got_grad.float().numpy() - want_grad).max() <= \
            bf16_ulp(np.abs(want_grad).max())


def _op_loss(pkg, x, lbl):
    """Loss and bf16 data gradient of ``nd.softmax_cross_entropy`` on
    bf16 logits under the package's autograd, widened to fp32."""
    with pkg.cpu():
        data = pkg.nd.array(x).astype("bfloat16")
        label = pkg.nd.array(lbl)
        data.attach_grad()
        with pkg.autograd.record():
            loss = pkg.nd.softmax_cross_entropy(data, label)
        loss.backward()
        assert loss.dtype == data.grad.dtype == "bfloat16"
        return _f32(loss), _f32(data.grad)


def test_bf16_loss_op_matches_the_reference_kernel_route(monkeypatch):
    """The op on bf16 logits against the reference's Pallas route, the
    route it takes for bf16 (``ops/softmax.py:270-288``): the summed
    loss comes back bf16, as ``jnp.sum(loss).astype(data.dtype)``, and
    the gradient bf16, each within one bf16 ulp."""
    monkeypatch.setenv("MXNET_PALLAS", "2")
    _, tx, lbl, _ = _xent_case(24, 64, 3)
    x = tx.float().numpy()
    want_loss, want_grad = _op_loss(jmx, x, lbl)
    got_loss, got_grad = _op_loss(tmx, x, lbl)
    assert got_loss.shape == (1,)
    assert np.abs(got_loss - want_loss).max() <= bf16_ulp(abs(want_loss[0]))
    assert np.abs(got_grad - want_grad).max() <= \
        bf16_ulp(np.abs(want_grad).max())


def test_bf16_loss_op_against_the_reference_default_route(monkeypatch):
    """The reference's default CPU route is not the oracle for the bf16
    kernels: ``_sce_fc``'s XLA route (``mxnet_tpu/ops/softmax.py:284-287``)
    computes ``log_softmax`` and the one-hot sum in bf16 itself, where
    the kernels widen to fp32 and round once.  The port stays within
    2e-2 x max|ref| of it on in-range labels (a few bf16 ulps), and
    closer to the fp32 loss than it is."""
    monkeypatch.setenv("MXNET_PALLAS", "0")
    _, tx, lbl, _ = _xent_case(24, 64, 4)
    lbl = np.clip(lbl, 0, 63)      # the XLA route's one_hot drops the rest
    x = tx.float().numpy()
    want_loss, want_grad = _op_loss(jmx, x, lbl)
    got_loss, got_grad = _op_loss(tmx, x, lbl)
    assert _rel(got_loss, want_loss) <= LOSS_TOL
    assert _rel(got_grad, want_grad) <= LOSS_TOL
    exact = float(softmax_xent.xent_loss_rows_reference(
        torch.from_numpy(x), torch.from_numpy(lbl)).sum())
    assert abs(got_loss[0] - exact) <= abs(want_loss[0] - exact) + \
        bf16_ulp(exact)


# ---------------------------------------------------------------------------
# the wrappers' refusals (the card route's checks, called directly)
# ---------------------------------------------------------------------------
def test_loss_kernels_take_a_float32_label_and_g_and_nothing_looser():
    """bf16 or fp32 logits with float32 ``label`` and ``g``; a bf16
    label or ``g``, fp16 logits, a vector of the wrong length or on
    another device, a 1D ``x`` are refused, naming what was wrong."""
    check = softmax_xent._check_loss_args
    x, lbl = torch.zeros(4, 8, dtype=BF16), torch.zeros(4)
    for name in ("softmax_xent_loss", "softmax_xent_loss_grad"):
        check(name, x, lbl, lbl)
        check(name, x.float(), lbl, lbl)
        with pytest.raises(_build.KernelError, match="float32.*bfloat16"):
            check(name, x, lbl.to(BF16))
        with pytest.raises(_build.KernelError, match="float32.*bfloat16"):
            check(name, x, lbl, lbl.to(BF16))
        with pytest.raises(_build.KernelError, match="float16"):
            check(name, x.half(), lbl)
        with pytest.raises(_build.KernelError, match="per-row"):
            check(name, x, torch.zeros(5))
        with pytest.raises(_build.KernelError, match="must be on"):
            check(name, x, torch.zeros(4, device="meta"))
        with pytest.raises(_build.KernelError, match="2D"):
            check(name, x[0], lbl)
        with pytest.raises(_build.KernelError, match="contiguous"):
            check(name, torch.zeros(8, 4, dtype=BF16).t(), lbl)


@pytest.fixture
def card_route(monkeypatch):
    """Fake the card route of the norm and loss wrappers: ``route``
    answers True and ``launch`` records ``(name, entry)`` instead of
    calling the library; flash attention stays on its plain version."""
    from mxnet_tpu_torch.kernels import norm
    launches = []

    def fake_launch(x, name, entry, *args):
        launches.append((name, entry))

    for mod in (norm, softmax_xent):
        monkeypatch.setattr(mod, "route", lambda name, x: True)
        monkeypatch.setattr(mod, "launch", fake_launch)
    monkeypatch.setattr(norm, "sm_count", lambda index: 132)
    return launches


def test_imperative_bf16_step_launches_the_bf16_kernels(card_route):
    """One imperative bf16 step of the tiny LM reaches each kernel under
    its bf16 name and C entry point, and no fp32 one; the loss kernels
    get the bf16 logits and float32 label and cotangent."""
    seen = []
    fwd, bwd = (softmax_xent.SoftmaxXentLoss.forward,
                softmax_xent.SoftmaxXentLoss.backward)

    def spy_fwd(ctx, logits, label):
        seen.append(("forward", logits.dtype, label.dtype))
        return fwd(ctx, logits, label)

    def spy_bwd(ctx, g):
        seen.append(("backward", g.dtype))
        return bwd(ctx, g)

    params = _params()
    X, y = _batches()[0]
    with pytest.MonkeyPatch.context() as mp, tmx.cpu():
        mp.setattr(softmax_xent.SoftmaxXentLoss, "forward",
                   staticmethod(spy_fwd))
        mp.setattr(softmax_xent.SoftmaxXentLoss, "backward",
                   staticmethod(spy_bwd))
        w = {k: tmx.nd.array(v) for k, v in params.items()}
        for v in w.values():
            v.attach_grad()
        with tmx.autograd.record():
            loss = tlm.imperative_loss(tmx.nd, w, tmx.nd.array(X),
                                       tmx.nd.array(y), SEQ, SPEC,
                                       compute_dtype="bfloat16")
        loss.backward()
    nl = SPEC["num_layers"]
    want = {("rms_norm_bf16", "mxt_rms_norm_bf16"): 2 * nl,
            ("rms_norm_bwd_bf16", "mxt_rms_norm_bwd_bf16"): 2 * nl,
            ("layer_norm_bf16", "mxt_layer_norm_bf16"): 1,
            ("layer_norm_bwd_bf16", "mxt_layer_norm_bwd_bf16"): 1,
            ("softmax_xent_loss_bf16", "mxt_softmax_xent_loss_bf16"): 1,
            ("softmax_xent_loss_grad_bf16",
             "mxt_softmax_xent_loss_grad_bf16"): 1}
    got = {}
    for key in card_route:
        got[key] = got.get(key, 0) + 1
    assert got == want
    assert seen == [("forward", BF16, torch.float32),
                    ("backward", torch.float32)]
    assert all(name in tmx.kernels.KERNELS for name, _ in want)
    assert all(entry in _build._SIGNATURES for _, entry in want)


# ---------------------------------------------------------------------------
# the slice: imperative bf16 steps of the transformer LM
# ---------------------------------------------------------------------------
SPEC = tlm.lm_spec(num_layers=2, num_hidden=64, num_heads=4, vocab_size=256)
SEQ, BATCH, STEPS = 16, 4, 3
LR, MOMENTUM = 0.005, 0.9


def _params():
    """``tlm.random_params`` with the FFN biases at 1, so every ReLU
    input lies far from zero (as tests/test_torch_train_bf16.py and
    chip_smoke.py phase 7 do): at a kink, an input that bf16 rounding
    puts on the other side passes or stops a whole gradient term, and
    there either package's bf16 step lies 13% of max|ref| from its own
    fp32 step."""
    params = tlm.random_params(SPEC, seed=4)
    for name in params:
        if name.endswith("_ffn1_bias"):
            params[name] = params[name] + np.float32(1.0)
    return params


def _batches():
    """STEPS batches of the successor language (``x[t+1] = x[t] + 1 mod
    V``, the label the next token), so that three steps can lower a loss
    that bf16 holds to 8 bits."""
    rs = np.random.RandomState(5)
    V = SPEC["vocab_size"]
    out = []
    for _ in range(STEPS):
        X = (rs.randint(0, V, (BATCH, 1)) + np.arange(SEQ)) % V
        out.append((X.astype(np.float32), ((X + 1) % V).astype(np.float32)))
    return out


def _bf16_steps(pkg, params, batches):
    """STEPS imperative bf16 SGD-momentum steps as a user writes them:
    fp32 master weights and momenta, ``imperative_loss(...,
    compute_dtype='bfloat16')`` under ``record()``, ``backward``,
    ``sgd_mom_update(..., out=w)``.  Returns the losses, the first
    step's gradients, the final parameters, every master array's dtype,
    and the fp32 loss of the first batch before and after the steps
    (``fell``: the bf16 sum of 64 token losses near 354 moves in steps
    of 2, more than three steps at this rate lower it)."""

    def fp32_loss(w):
        X, y = batches[0]
        return float(tlm.imperative_loss(
            pkg.nd, w, pkg.nd.array(X), pkg.nd.array(y), SEQ,
            SPEC).asnumpy()[0])

    with pkg.cpu():
        w = {k: pkg.nd.array(v) for k, v in params.items()}
        mom = {k: pkg.nd.zeros(v.shape) for k, v in params.items()}
        for v in w.values():
            v.attach_grad()
        fell = [fp32_loss(w)]
        losses, grads = [], None
        for X, y in batches:
            with pkg.autograd.record():
                loss = tlm.imperative_loss(pkg.nd, w, pkg.nd.array(X),
                                           pkg.nd.array(y), SEQ, SPEC,
                                           compute_dtype="bfloat16")
            loss.backward()
            losses.append((str(loss.dtype), float(_f32(loss)[0])))
            if grads is None:
                grads = {k: v.grad.asnumpy() for k, v in w.items()}
            for k in w:
                pkg.nd.sgd_mom_update(w[k], w[k].grad, mom[k], lr=LR,
                                      momentum=MOMENTUM,
                                      rescale_grad=1 / BATCH, out=w[k])
        dtypes = {str(a.dtype) for d in (w, mom) for a in d.values()}
        dtypes |= {str(v.grad.dtype) for v in w.values()}
        fell.append(fp32_loss(w))
        return dict(losses=losses, grads=grads, dtypes=dtypes, fell=fell,
                    params={k: v.asnumpy() for k, v in w.items()})


@pytest.fixture(scope="module")
def steps():
    """Both packages' three bf16 steps from the same parameters and
    batches, the reference on its Pallas route in interpret mode."""
    params, batches = _params(), _batches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_PALLAS", "2")
        want = _bf16_steps(jmx, params, batches)
        got = _bf16_steps(tmx, params, batches)
    return got, want


def test_imperative_bf16_first_step_matches_jax(steps):
    """The first step: the loss bf16 within 2e-2 x |ref|, every gradient
    float32 within 5e-2 x its max|ref|."""
    got, want = steps
    (dt, loss), (wdt, wloss) = got["losses"][0], want["losses"][0]
    assert dt == wdt == "bfloat16"
    assert abs(loss - wloss) <= LOSS_TOL * abs(wloss)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for name, ref in want["grads"].items():
        assert got["grads"][name].dtype == ref.dtype == np.float32
        assert _rel(got["grads"][name], ref) <= GRAD_TOL, name


def test_imperative_bf16_three_steps_match_jax_and_keep_fp32_masters(
        steps):
    """Three SGD-momentum steps: every parameter within 1e-2 x max|ref|,
    each step's bf16 loss within 2e-2 x |ref|, the loss of the first
    batch lower after the steps, and the master weights, gradients and
    momenta float32 in both packages."""
    got, want = steps
    assert got["dtypes"] == want["dtypes"] == {"float32"}
    for name, ref in want["params"].items():
        assert got["params"][name].dtype == np.float32
        assert _rel(got["params"][name], ref) <= PARAM_TOL, name
    for (_, a), (_, b) in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= LOSS_TOL * abs(b)
    for res in (got, want):
        assert res["fell"][1] < res["fell"][0]
