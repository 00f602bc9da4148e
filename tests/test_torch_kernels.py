"""The port's kernel modules against the JAX package's kernels.

On the CPU each wrapper takes its plain PyTorch version; these tests
hold those plain versions against the JAX package's Pallas kernels run
in interpret mode and against its dense twins, on the same seeded numpy
inputs.  The CUDA kernels themselves are held against these plain
versions on a card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.pallas_ops import norm as jax_norm
from mxnet_tpu.pallas_ops.flash_attention import pltpu
from mxnet_tpu.pallas_ops.paged_attention import (
    flash_attention_paged as jax_flash_attention_paged,
    paged_attention_reference as jax_paged_attention_reference)
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import norm, paged_attention
from mxnet_tpu_torch.ops import nn as ops_nn
from mxnet_tpu_torch.ops.attention import sdp_attention_paged
from test_torch_cuda import paged_case

NORM_SHAPES = [(16, 64), (6, 40), (32, 512)]
# the three cases of tests/test_paged_decode.py's kernel parity test
PAGED_CASES = [(0, 1, [5, 9, 17]), (1, 4, [0, 3, 12]), (2, 8, [8, 1, 15])]


def _norm_inputs(seed, rows, width):
    rs = np.random.RandomState(seed)
    return (rs.randn(rows, width).astype(np.float32),
            rs.uniform(0.5, 1.5, width).astype(np.float32),
            rs.randn(width).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("rows,width", NORM_SHAPES)
def test_rms_norm_plain_matches_pallas_interpret(rows, width):
    x, g, _ = _norm_inputs(rows + width, rows, width)
    want = np.asarray(jax_norm.rms_norm(x, g, 1e-6, 8, True))
    got = norm.rms_norm(*_t(x, g), eps=1e-6).numpy()
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("rows,width", NORM_SHAPES)
def test_layer_norm_plain_matches_pallas_interpret(rows, width):
    x, g, b = _norm_inputs(rows * width, rows, width)
    x = x + 3.0   # an offset mean: the variance must be mean((x-mu)^2)
    want = np.asarray(jax_norm.layer_norm(x, g, b, 1e-5, 8, True))
    got = norm.layer_norm(*_t(x, g, b), eps=1e-5).numpy()
    assert np.abs(got - want).max() <= 1e-5


def test_norm_doors_reshape_nd_inputs():
    """ops/nn's doors normalise the last axis of an N-d input."""
    x, g, b = _norm_inputs(7, 2 * 3, 32)
    x3 = torch.from_numpy(x.reshape(2, 3, 32))
    tg, tb = _t(g, b)
    got = ops_nn.rms_norm(x3, tg)
    assert got.shape == (2, 3, 32)
    want = norm.rms_norm_reference(torch.from_numpy(x), tg, 1e-6)
    assert torch.equal(got.reshape(6, 32), want)
    got = ops_nn.layer_norm(x3, tg, tb)
    want = norm.layer_norm_reference(torch.from_numpy(x), tg, tb, 1e-5)
    assert torch.equal(got.reshape(6, 32), want)


@pytest.mark.parametrize("seed,lq,positions", PAGED_CASES)
def test_paged_plain_matches_jax_kernel_and_twin(seed, lq, positions):
    q, kp, vp, tbl, pos = paged_case(seed, B=3, H=2, T=4, D=8, bs=8,
                                     num_blocks=12, positions=positions,
                                     lq=lq)
    got = paged_attention.flash_attention_paged(*_t(q, kp, vp, tbl, pos),
                                                8).numpy()
    want = np.asarray(jax_paged_attention_reference(q, kp, vp, tbl, pos, 8))
    assert np.abs(got - want).max() <= 1e-5
    if pltpu is not None:
        kern = np.asarray(jax_flash_attention_paged(
            q, kp, vp, tbl, pos, 8, block_q=4, interpret=True))
        assert np.abs(got - kern).max() <= 1e-5


def test_paged_plain_ignores_trash_and_junk_blocks():
    """Junk planted in the trash block and in blocks no table references
    must not reach the output."""
    q, kp, vp, tbl, pos = paged_case(4, B=2, H=2, T=3, D=8, bs=8,
                                     num_blocks=8, positions=[4, 10], lq=1)
    base = paged_attention.paged_attention_reference(
        *_t(q, kp, vp, tbl, pos), 8)
    kj, vj = kp.copy(), vp.copy()
    for blk in set(range(8)) - (set(tbl.ravel()) - {0}):
        kj[:, blk * 8:(blk + 1) * 8] = 1e4
        vj[:, blk * 8:(blk + 1) * 8] = -1e4
    got = paged_attention.paged_attention_reference(
        *_t(q, kj, vj, tbl, pos), 8)
    assert (got - base).abs().max().item() < 2e-6


def test_sdp_attention_paged_default_scale():
    q, kp, vp, tbl, pos = paged_case(5, B=2, H=2, T=3, D=16, bs=8,
                                     num_blocks=8, positions=[3, 9], lq=2)
    tq, tk, tv, tt, tp = _t(q, kp, vp, tbl, pos)
    want = paged_attention.paged_attention_reference(tq, tk, tv, tt, tp, 8,
                                                     scale=0.25)
    assert torch.equal(sdp_attention_paged(tq, tk, tv, tt, tp, 8), want)


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for a CPU tensor; any other
    device gets the kernel or an error, never a silent fallback."""
    x = torch.zeros(2, 4, device="meta")
    g = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        norm.rms_norm(x, g)
    with pytest.raises(ValueError, match="no kernel"):
        norm.layer_norm(x, g, g)
    q = torch.zeros(1, 1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        paged_attention.flash_attention_paged(q, q[0], q[0], q, q, 8)


def test_paged_kernel_argument_checks():
    """The checks that guard the CUDA launch refuse what the kernel does
    not take: wrong dtypes, non-contiguous tensors, ragged pools, head
    dims past 256."""
    q, kp, vp, tbl, pos = _t(*paged_case(0, B=2, H=2, T=3, D=8, bs=8,
                                         num_blocks=8, positions=[1, 2],
                                         lq=1))
    check = paged_attention._check
    check(q, kp, vp, tbl, pos, 8)
    with pytest.raises(ValueError, match="int32"):
        check(q, kp, vp, tbl.long(), pos, 8)
    with pytest.raises(ValueError, match="contiguous"):
        check(q.transpose(0, 1), kp, vp, tbl, pos, 8)
    with pytest.raises(ValueError, match="multiple"):
        check(q, kp[:, :60].contiguous(), vp[:, :60].contiguous(), tbl,
              pos, 8)
    big = torch.zeros(2, 2, 1, 264)
    with pytest.raises(ValueError, match="multiple of 4 up to 256"):
        check(big, kp, vp, tbl, pos, 8)
    with pytest.raises(ValueError, match="float32"):
        norm._check_rows("rms_norm", torch.zeros(2, 4, dtype=torch.float64),
                         torch.zeros(4, dtype=torch.float64))


def test_launch_counts_untouched_by_plain_versions():
    kernels.reset_launch_counts()
    x, g, b = _t(*_norm_inputs(1, 4, 16))
    norm.rms_norm(x, g)
    norm.layer_norm(x, g, b)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
