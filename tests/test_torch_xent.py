"""The port's softmax / cross-entropy kernels' plain versions and the
``softmax_cross_entropy`` op against the JAX package.

The kernel functions run their plain PyTorch versions here (CPU
tensors) and are held against the Pallas kernels of
``mxnet_tpu.pallas_ops.softmax_xent`` in interpret mode, as
``tests/test_pallas_kernels.py`` runs them: forward values and the
gradient for a seeded cotangent, within 1e-5 of the largest reference
value (the two sum each row in another order).

The op follows the Pallas kernel for a label outside the classes (the
row's loss is its logsumexp), where the JAX package's plain XLA route
gives 0: in-range labels are held against the JAX package's default
route, out-of-range ones against its kernel route (``MXNET_PALLAS=2``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.pallas_ops import softmax_xent as jsx
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.kernels import softmax_xent as tsx

REL = 1e-5   # of max|ref|

# (rows, classes, labels): in range, with a fraction (truncated), and
# outside [0, classes)
CASES = {
    "in_range": (24, 64, None),
    "odd_width": (6, 40, None),
    "fractional": (5, 9, [0.0, 8.0, 3.7, 2.2, 8.9]),
    "out_of_range": (6, 16, [-1.0, 16.0, 19.0, 0.0, 15.0, -0.5]),
    "two_classes": (4, 2, [1.0, 0.0, 2.0, 1.0]),
}


def _case(name, seed=0):
    rows, cols, labels = CASES[name]
    rs = np.random.RandomState(seed)
    x = (3 * rs.randn(rows, cols)).astype(np.float32)
    if labels is None:
        labels = rs.randint(0, cols, rows)
    g = rs.uniform(0.5, 2.0, rows).astype(np.float32)
    dy = rs.randn(rows, cols).astype(np.float32)
    return x, np.asarray(labels, np.float32), g, dy


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_softmax_xent_loss_matches_pallas(name):
    x, lbl, g, _ = _case(name)
    want, vjp = jax.vjp(lambda a: jsx.softmax_xent_loss(
        a, jnp.asarray(lbl), 8, True), jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tsx.softmax_xent_loss(xt, torch.from_numpy(lbl))
    (got_grad,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    _close(got, want)
    _close(got_grad, want_grad)
    _close(tsx.xent_loss_rows(torch.from_numpy(x), torch.from_numpy(lbl)),
           want)
    _close(tsx.softmax_xent_loss_grad(torch.from_numpy(x),
                                      torch.from_numpy(lbl),
                                      torch.from_numpy(g)), want_grad)


@pytest.mark.parametrize("name", ["in_range", "odd_width", "two_classes"])
def test_fused_softmax_matches_pallas(name):
    x, _, _, dy = _case(name, seed=1)
    want, vjp = jax.vjp(lambda a: jsx.fused_softmax(a, 8, True),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tsx.fused_softmax(xt)
    (got_dx,) = torch.autograd.grad(got, xt, torch.from_numpy(dy))
    _close(got, want)
    _close(got_dx, want_dx)
    _close(tsx.softmax_rows_bwd(got.detach(), torch.from_numpy(dy)),
           want_dx)


def test_plain_versions_refuse_nothing_on_cpu_and_kernels_check_shapes():
    """The shape checks belong to the CUDA path; a CPU tensor always
    takes the plain version."""
    x = torch.randn(3, 5)
    assert tsx.xent_loss_rows(x, torch.zeros(3)).shape == (3,)
    with pytest.raises(tsx.KernelError, match="2D"):
        tsx._check_2d("softmax_xent_loss", x[0])
    with pytest.raises(tsx.KernelError, match="per-row"):
        tsx._check_labels("softmax_xent_loss", x, torch.zeros(4))


def _op_loss(pkg, x, lbl):
    """Loss and data gradient of ``nd.softmax_cross_entropy`` under the
    package's autograd."""
    with pkg.cpu():
        data, label = pkg.nd.array(x), pkg.nd.array(lbl)
        data.attach_grad()
        with pkg.autograd.record():
            loss = pkg.nd.softmax_cross_entropy(data, label)
        loss.backward()
        return loss.asnumpy(), data.grad.asnumpy()


@pytest.mark.parametrize("name", ["in_range", "odd_width", "fractional",
                                  "two_classes"])
def test_softmax_cross_entropy_op_matches_jax_default_route(name,
                                                            monkeypatch):
    monkeypatch.delenv("MXNET_PALLAS", raising=False)
    x, lbl, _, _ = _case(name, seed=2)
    lbl = np.minimum(lbl, CASES[name][1] - 1)
    want_loss, want_grad = _op_loss(jmx, x, lbl)
    got_loss, got_grad = _op_loss(tmx, x, lbl)
    assert got_loss.shape == (1,) and got_loss.dtype == np.float32
    _close(got_loss, want_loss)
    _close(got_grad, want_grad)


def test_softmax_cross_entropy_op_matches_jax_kernel_route(monkeypatch):
    """Labels outside the classes: the JAX package's Pallas route
    (forced into interpret mode), which the port's kernel follows."""
    x, lbl, _, _ = _case("out_of_range", seed=3)
    monkeypatch.setenv("MXNET_PALLAS", "2")
    want_loss, want_grad = _op_loss(jmx, x, lbl)
    got_loss, got_grad = _op_loss(tmx, x, lbl)
    _close(got_loss, want_loss)
    _close(got_grad, want_grad)
    monkeypatch.setenv("MXNET_PALLAS", "0")
    xla_loss, _ = _op_loss(jmx, x, lbl)
    assert not np.allclose(xla_loss, got_loss)   # the reference's trap


@pytest.mark.parametrize("shape", [(2, 3, 5), (7,)])
def test_softmax_cross_entropy_op_plain_formula_matches_jax(shape,
                                                            monkeypatch):
    """Shapes outside the kernel's condition take the reference's
    ``-sum(onehot * log_softmax)`` in both packages."""
    monkeypatch.setenv("MXNET_PALLAS", "0")
    rs = np.random.RandomState(4)
    x = rs.randn(*shape).astype(np.float32)
    lbl = rs.randint(0, shape[-1], shape[:-1] or (1,)).astype(np.float32)
    if len(shape) == 1:
        lbl = lbl[0]
    want_loss, want_grad = _op_loss(jmx, x, np.asarray(lbl))
    got_loss, got_grad = _op_loss(tmx, x, np.asarray(lbl))
    _close(got_loss, want_loss)
    _close(got_grad, want_grad)


def _executor_run(pkg, x, lbl, head):
    net = pkg.sym.MakeLoss(pkg.sym.softmax_cross_entropy(
        pkg.sym.Variable("data"), pkg.sym.Variable("label")),
        grad_scale=0.5)
    ex = net.simple_bind(pkg.cpu(), data=x.shape, label=lbl.shape)
    ex.arg_dict["data"][:] = x
    ex.arg_dict["label"][:] = lbl
    ex.forward(is_train=True)
    out = ex.outputs[0].asnumpy()
    ex.backward([pkg.nd.array(head, ctx=pkg.cpu())])
    return out, {k: v.asnumpy() for k, v in ex.grad_dict.items()}


def test_make_loss_of_softmax_cross_entropy_through_the_executor(
        monkeypatch):
    """The symbolic form: ``MakeLoss(softmax_cross_entropy(...))`` bound
    and run by each package's Executor; the head gradient is ignored."""
    monkeypatch.setenv("MXNET_PALLAS", "0")
    x, lbl, _, _ = _case("in_range", seed=5)
    head = np.full((1,), 7.0, np.float32)
    want_out, want_grads = _executor_run(jmx, x, lbl, head)
    got_out, got_grads = _executor_run(tmx, x, lbl, head)
    _close(got_out, want_out)
    assert sorted(got_grads) == sorted(want_grads) == ["data", "label"]
    for k in want_grads:
        _close(got_grads[k], want_grads[k])
    assert not np.any(got_grads["label"])


# softmax_rows' planner: (classes, dtype) -> the body on 16-byte aligned
# rows; the widths of the paths (ResNet-50's 1000, the transformer LM's
# 8192, the LSTM LM's 10000), the chunk's edges, the widest registers
# rows (fp32 16384, bf16 8192) and one past them
F32, BF16 = torch.float32, torch.bfloat16
ROWS_PLANS = [
    (1, F32, ("two_pass", 0)), (3, F32, ("two_pass", 0)),
    (1000, F32, ("regs", 1)), (1001, F32, ("two_pass", 0)),
    (1024, F32, ("regs", 1)), (1028, F32, ("regs", 2)),
    (8192, F32, ("regs", 8)), (10000, F32, ("regs", 10)),
    (10240, F32, ("regs", 10)), (10244, F32, ("regs", 16)),
    (16384, F32, ("regs", 16)), (16385, F32, ("two_pass", 0)),
    (16388, F32, ("two_pass", 1)),
    (1, BF16, ("two_pass", 0)), (3, BF16, ("two_pass", 0)),
    (1000, BF16, ("regs", 1)), (1001, BF16, ("two_pass", 0)),
    (6144, BF16, ("regs", 4)), (8192, BF16, ("regs", 4)),
    (8200, BF16, ("two_pass", 0)), (10000, BF16, ("two_pass", 0)),
    (16384, BF16, ("two_pass", 0))]


@pytest.mark.parametrize("cols,dtype,want", ROWS_PLANS,
                         ids=["%d-%s" % (c, str(d)[6:]) for c, d, _
                              in ROWS_PLANS])
def test_softmax_rows_plan(cols, dtype, want):
    """The body for aligned rows, and the two-pass body for the same rows
    one element off 16-byte alignment; a registers plan's loads hold the
    row, and the next smaller instance would not."""
    plan = tsx._plan(cols, 16, dtype)
    assert tuple(plan) == want
    elem = torch.empty((), dtype=dtype).element_size()
    assert tuple(tsx._plan(cols, elem, dtype)) == ("two_pass", 0)
    if plan.body == "regs":
        held = 16 // elem * tsx.ROWS_THREADS
        loads = tsx.ROWS_REGS_LOADS[dtype]
        assert plan.loads in loads and cols <= held * plan.loads
        i = loads.index(plan.loads)
        assert i == 0 or cols > held * loads[i - 1]


def test_softmax_rows_plan_reads_alignment_from_the_tensors():
    """An aligned buffer and the same buffer offset by one element."""
    for dtype in (F32, BF16):
        buf = torch.zeros(4 * 1000 + 8, dtype=dtype)
        aligned, offset = buf[:4000], buf[1:4001]
        assert _build.align_bytes(aligned) == 16
        assert _build.align_bytes(offset) == buf.element_size()
        assert tsx._plan(1000, _build.align_bytes(aligned),
                         dtype).body == "regs"
        assert tsx._plan(1000, _build.align_bytes(offset),
                         dtype).body == "two_pass"


def test_softmax_rows_card_route_launches_the_planned_body(monkeypatch):
    """The card route (faked on CPU tensors) makes one launch with the
    plan's path and loads, and counts it under its body as well as
    under its name."""
    launches = []
    monkeypatch.setattr(tsx, "route", lambda name, x: True)
    monkeypatch.setattr(tsx, "launch", lambda *a: launches.append(a))
    buf = torch.zeros(4 * 10000 + 8)
    cases = [(buf[:40000].view(4, 10000), ("regs", 10)),
             (buf[1:40001].view(4, 10000), ("two_pass", 0)),
             (buf[:40000].view(4, 10000).to(BF16), ("two_pass", 0)),
             (buf[:4000].view(4, 1000).to(BF16), ("regs", 1))]
    kernels.reset_launch_counts()
    for x, (body, loads) in cases:
        launches.clear()
        tsx.softmax_rows(x)
        ((_, name, entry, _x, _p, rows, cols, path, got_loads),) = launches
        tag, sfx = ("", "_f32") if x.dtype == F32 else ("_bf16", "_bf16")
        assert (name, entry) == ("softmax_rows" + tag,
                                 "mxt_softmax_rows" + sfx)
        assert (rows, cols) == tuple(x.shape)
        assert (path, got_loads) == (tsx._ROWS_PATH[body], loads)
    assert kernels.body_counts() == {
        "softmax_rows[regs]": 1, "softmax_rows[two_pass]": 1,
        "softmax_rows_bf16[two_pass]": 1, "softmax_rows_bf16[regs]": 1}
    kernels.reset_launch_counts()
    assert kernels.body_counts() == {}
