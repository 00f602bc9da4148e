"""The training path's kernel modules against the JAX package's kernels.

On the CPU each wrapper takes its plain PyTorch version.  These tests
differentiate those plain versions through the port's
``torch.autograd.Function``s and hold forward values and gradients
against ``jax.vjp`` of the JAX package's Pallas functions run in
interpret mode, on the same seeded numpy inputs.  The CUDA kernels are
held against the plain versions on a card by ``tests/test_torch_cuda.py``.
"""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.pallas_ops import norm as jax_norm
from mxnet_tpu.pallas_ops.flash_attention import \
    flash_attention as jax_flash_attention
from mxnet_tpu.pallas_ops.softmax_xent import \
    softmax_output_head as jax_softmax_output_head
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import flash_attention, norm, softmax_xent

NORM_SHAPES = [(16, 64), (6, 40), (32, 512)]


def _leaves(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
            for a in arrays]


def _close(got, want, rel):
    """max |got - want| <= rel * max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _norm_case(seed, rows, width):
    rs = np.random.RandomState(seed)
    return (rs.randn(rows, width).astype(np.float32),
            rs.uniform(0.5, 1.5, width).astype(np.float32),
            rs.randn(width).astype(np.float32),
            rs.randn(rows, width).astype(np.float32))


@pytest.mark.parametrize("rows,width", NORM_SHAPES)
def test_rms_norm_grads_match_pallas_interpret(rows, width):
    x, g, _, dy = _norm_case(rows + 3 * width, rows, width)
    want_y, vjp = jax.vjp(
        lambda a, b: jax_norm.rms_norm(a, b, 1e-6, 8, True), x, g)
    want_dx, want_dg = vjp(dy)
    tx, tg = _leaves(x, g)
    y = norm.RMSNorm.apply(tx, tg, 1e-6)
    y.backward(torch.from_numpy(dy))
    _close(y.detach().numpy(), want_y, 1e-5)
    _close(tx.grad.numpy(), want_dx, 1e-5)
    _close(tg.grad.numpy(), want_dg, 1e-5)


@pytest.mark.parametrize("rows,width", NORM_SHAPES)
def test_layer_norm_grads_match_pallas_interpret(rows, width):
    x, g, b, dy = _norm_case(rows * width + 1, rows, width)
    x = x + 3.0   # an offset mean: the variance must be mean((x-mu)^2)
    want_y, vjp = jax.vjp(
        lambda a, c, d: jax_norm.layer_norm(a, c, d, 1e-5, 8, True), x, g, b)
    want_dx, want_dg, want_db = vjp(dy)
    tx, tg, tb = _leaves(x, g, b)
    y = norm.LayerNorm.apply(tx, tg, tb, 1e-5)
    y.backward(torch.from_numpy(dy))
    _close(y.detach().numpy(), want_y, 1e-5)
    _close(tx.grad.numpy(), want_dx, 1e-5)
    _close(tg.grad.numpy(), want_dg, 1e-5)
    _close(tb.grad.numpy(), want_db, 1e-5)


def test_norm_bwd_wrappers_return_the_function_grads():
    """The ``*_bwd`` wrappers are what the Functions' backwards call."""
    x, g, b, dy = _norm_case(5, 9, 24)
    tx, tg, tb, tdy = (torch.from_numpy(a) for a in (x, g, b, dy))
    dx, dg = norm.rms_norm_bwd(tx, tg, tdy, 1e-6)
    lx, lg = _leaves(x, g)
    norm.RMSNorm.apply(lx, lg, 1e-6).backward(tdy)
    assert torch.equal(dx, lx.grad) and torch.equal(dg, lg.grad)
    dx, dg, db = norm.layer_norm_bwd(tx, tg, tdy, 1e-5)
    lx, lg, lb = _leaves(x, g, b)
    norm.LayerNorm.apply(lx, lg, lb, 1e-5).backward(tdy)
    assert torch.equal(dx, lx.grad) and torch.equal(dg, lg.grad)
    assert torch.equal(db, lb.grad)


@pytest.mark.parametrize("rows,classes", [(24, 50), (7, 130)])
@pytest.mark.parametrize("per_row", [False, True])
def test_softmax_output_head_matches_pallas_interpret(rows, classes,
                                                      per_row):
    """Forward probabilities, and the backward under a random head
    cotangent, which the head must ignore; scale 1 or 1/rows."""
    scale = 1.0 / rows if per_row else 1.0
    rs = np.random.RandomState(rows * classes)
    data = (3 * rs.randn(rows, classes)).astype(np.float32)
    label = rs.randint(0, classes, rows).astype(np.float32)
    cot = rs.randn(rows, classes).astype(np.float32)
    want_p, vjp = jax.vjp(lambda d: jax_softmax_output_head(
        d, label, scale, 8, True), data)
    (want_g,) = vjp(cot)
    (td,) = _leaves(data)
    p = softmax_xent.SoftmaxOutputHead.apply(td, torch.from_numpy(label),
                                             scale)
    p.backward(torch.from_numpy(cot))
    _close(p.detach().numpy(), want_p, 1e-5)
    _close(td.grad.numpy(), want_g, 1e-5)
    # the cotangent is ignored: ones give the same gradient
    (t1,) = _leaves(data)
    softmax_xent.SoftmaxOutputHead.apply(
        t1, torch.from_numpy(label), scale).sum().backward()
    assert torch.equal(t1.grad, td.grad)


def test_softmax_output_head_gives_label_no_gradient():
    data, label = _leaves(np.zeros((3, 4), np.float32),
                          np.array([0, 1, 3], np.float32))
    softmax_xent.softmax_output_head(data, label).sum().backward()
    assert label.grad is None
    assert data.grad is not None


def test_xent_grad_truncates_float_labels():
    """Labels arrive as float32 and are truncated as astype(int32)."""
    p = torch.full((2, 5), 0.2)
    got = softmax_xent.xent_grad_from_probs(
        p, torch.tensor([2.9, 0.2]), 1.0)
    assert got[0, 2].item() == pytest.approx(-0.8)
    assert got[1, 0].item() == pytest.approx(-0.8)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_interpret(causal):
    B, H, L, D = 2, 2, 32, 16
    rs = np.random.RandomState(int(causal))
    q, k, v, cot = (rs.randn(B, H, L, D).astype(np.float32)
                    for _ in range(4))
    want, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(
        a, b, c, causal=causal, block_q=16, block_k=16, interpret=True),
        q, k, v)
    want_grads = vjp(cot)
    tq, tk, tv = _leaves(q, k, v)
    out = flash_attention.FlashAttention.apply(tq, tk, tv, causal,
                                               1.0 / D ** 0.5)
    out.backward(torch.from_numpy(cot))
    assert np.abs(out.detach().numpy() - np.asarray(want)).max() <= 1e-5
    for t, w in zip((tq, tk, tv), want_grads):
        assert np.abs(t.grad.numpy() - np.asarray(w)).max() <= 1e-4


@pytest.mark.parametrize("block", [8, 32, 64])
def test_blockwise_attention_block_size_free(block):
    """The plain recurrence gives the same attention for any key block,
    a last block shorter than the others included."""
    rs = np.random.RandomState(block)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 40, 8).astype(np.float32))
               for _ in range(3))
    s = torch.matmul(q, k.transpose(-1, -2)) / 8 ** 0.5
    s = s.masked_fill(torch.ones(40, 40).triu(1).bool(), float("-inf"))
    want = torch.matmul(torch.softmax(s, -1), v)
    got = flash_attention.blockwise_attention(q, k, v, True,
                                              block_size=block)
    assert (got - want).abs().max().item() <= 1e-5


def test_training_wrappers_refuse_what_the_kernels_do_not_take():
    """A CUDA launch would be refused for these; the checks run before
    any device work."""
    bad = torch.zeros(2, 2, 4, 6)
    with pytest.raises(kernels._build.KernelError, match="multiple of 4"):
        flash_attention._check(bad, bad, bad)
    x = torch.zeros(4, 8)
    with pytest.raises(kernels._build.KernelError, match="float32"):
        norm._check_rows("rms_norm_bwd", x.double(), torch.zeros(8),
                         like=(x,))
    with pytest.raises(kernels._build.KernelError, match="contiguous"):
        norm._check_rows("layer_norm_bwd", x, torch.zeros(8), like=(x.t(),))
    meta = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        softmax_xent.softmax_rows(meta)


def test_plain_versions_count_no_launches():
    kernels.reset_launch_counts()
    x, g, b, dy = (torch.from_numpy(a) for a in _norm_case(2, 4, 16))
    norm.rms_norm_bwd(x, g, dy)
    norm.layer_norm_bwd(x, g, dy)
    p = softmax_xent.softmax_rows(x)
    softmax_xent.xent_grad_from_probs(p, torch.zeros(4))
    q = x.reshape(1, 1, 4, 16)
    flash_attention.flash_attention(q, q, q, True)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
