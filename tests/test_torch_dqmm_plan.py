"""The CUDA ``dequant_matmul``'s launch planner and its 2xTF32 arithmetic,
on the CPU.

The kernel itself runs only on a card (``tests/test_torch_cuda.py``).
What decides its launch and its numbers is checked here:

* ``_plan``: the decode GEMV for every decode bucket, the tensor-core
  tile above M 32, K slices that cover K once in multiples of 16, and a
  decode grid that fills an H100's 132 SMs;
* the prefill tile's arithmetic, emulated in plain numpy/torch: x split
  into two TF32 parts (rounded as ``cvt.rna`` rounds), each int8 code
  exact in TF32, and ``(hi @ c) + (lo @ c)`` scaled after the sum within
  1e-5 x max|ref| of the reference's ``dequant_matmul_dense``, where one
  TF32 pass is not.
"""
import importlib

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.kernels import dequant_matmul as dq

jdq = importlib.import_module("mxnet_tpu.pallas_ops.dequant_matmul")

H100_SMS = 132
# (N, K) of the LM's q/k/v/proj, ffn1, ffn2 and pred products at full width
LM_NK = [(512, 512), (2048, 512), (512, 2048), (8192, 512)]
DECODE_M = (1, 2, 4, 8, 16, 31, 32)
PREFILL_M = (33, 64, 128, 256, 512, 1024)


@pytest.mark.parametrize("M", DECODE_M + PREFILL_M)
@pytest.mark.parametrize("N,K", LM_NK + [(50, 48), (8, 16), (70, 80)])
def test_plan_regime_slices_and_grid(M, N, K):
    plan = dq._plan(M, N, K, H100_SMS)
    if M > dq.GEMV_MAX_M:                          # the tile: K unsplit
        assert plan == dq.Plan(0, 1)
        return
    ks = plan.k_slice
    assert ks % 16 == 0 and 16 <= ks
    assert plan.splits <= dq.GEMV_MAX_SPLITS       # one cluster a slab
    bounds = [(s * ks, min(K, (s + 1) * ks)) for s in range(plan.splits)]
    covered = np.concatenate([np.arange(a, b) for a, b in bounds])
    assert np.array_equal(covered, np.arange(K))   # each k once, in order
    assert all((b - a) % 16 == 0 and b > a for a, b in bounds)
    if N == 512:                                   # 32 slabs x splits
        assert -(-N // dq.GEMV_COLS) * plan.splits >= H100_SMS


def test_plan_small_k_takes_16_wide_slices():
    assert dq._plan(32, 7, 48, H100_SMS) == dq.Plan(16, 3)  # one slab


def test_plan_caps_the_cluster_at_8_slices():
    assert dq._plan(1, 16, 4096, H100_SMS) == dq.Plan(512, 8)
    # 512 slabs fill the card unsplit
    assert dq._plan(32, 8192, 512, H100_SMS) == dq.Plan(512, 1)


@pytest.fixture
def card_route(monkeypatch):
    """The wrapper's card route on CPU tensors, with the launches
    recorded instead of made."""
    launches = []
    monkeypatch.setattr(dq, "route", lambda name, x: True)
    monkeypatch.setattr(dq, "_sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(dq, "launch", lambda *a: launches.append(a))
    return launches


@pytest.mark.parametrize("M,N", [(3, 0), (0, 32), (0, 0)])
def test_empty_output_makes_no_launch(card_route, M, N):
    out = dq.dequant_matmul(torch.zeros(M, 32), torch.zeros(N, 32, dtype=
                            torch.int8), torch.ones(N))
    assert out.shape == (M, N) and out.dtype == torch.float32
    assert card_route == []


def test_card_route_refuses_k_zero(card_route):
    with pytest.raises(dq.KernelError, match="positive multiple of 16"):
        dq.dequant_matmul(torch.zeros(2, 0), torch.zeros(4, 0, dtype=
                          torch.int8), torch.ones(4))
    assert card_route == []


def test_card_route_passes_the_plan(card_route):
    dq.dequant_matmul(torch.zeros(2, 512), torch.zeros(512, 512, dtype=
                      torch.int8), torch.ones(512))
    (args,) = card_route
    assert args[1:3] == ("dequant_matmul", "mxt_dequant_matmul_f32")
    assert args[-5:] == (2, 512, 512) + tuple(dq._plan(2, 512, 512,
                                                       H100_SMS))


def tf32(a):
    """Round fp32 to TF32 as ``cvt.rna.tf32.f32`` does: to the nearest
    value with 10 mantissa bits, halves away from zero (the low 13 bits
    of the pattern cleared)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def test_tf32_rounding_is_round_half_away():
    one = np.float32(1.0)
    half_ulp = np.float32(2.0 ** -11)   # half a TF32 ulp at 1
    below = np.nextafter(one + half_ulp, np.float32(0))
    got = tf32(np.array([one + half_ulp, below, -(one + half_ulp), -below,
                         np.float32(3.0)], np.float32))
    assert got.tolist() == [1 + 2.0 ** -10, 1.0, -(1 + 2.0 ** -10), -1.0,
                            3.0]


def _xavier_case(M, N, K):
    rs = np.random.RandomState(M * 7 + N + K)
    x = rs.randn(M, K).astype(np.float32)
    lim = np.sqrt(6.0 / (N + K))
    codes, scales = dq.quantize_int8(
        rs.uniform(-lim, lim, (N, K)).astype(np.float32), "row")
    return x, codes, scales


@pytest.mark.parametrize("M", [32, 1024])
@pytest.mark.parametrize("N,K", LM_NK)
def test_two_tf32_passes_keep_fp32_accuracy(M, N, K):
    x, codes, scales = _xavier_case(M, N, K)
    ref = np.asarray(jdq.dequant_matmul_dense(x, codes, scales))
    tol = 1e-5 * np.abs(ref).max()
    c = codes.astype(np.float32)
    assert np.array_equal(tf32(c), c)          # every code exact in TF32
    hi = tf32(x)
    lo = tf32(x - hi)                          # x - hi is exact in fp32
    ct = torch.from_numpy(c).t()
    s = torch.from_numpy(scales)
    two = ((torch.from_numpy(hi) @ ct) + (torch.from_numpy(lo) @ ct)) * s
    assert np.abs(two.numpy() - ref).max() <= tol
    one = (torch.from_numpy(hi) @ ct) * s      # a single TF32 pass
    assert np.abs(one.numpy() - ref).max() > tol
