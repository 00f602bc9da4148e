"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  The module imports neither JAX nor the JAX package,
so on a GPU machine without JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import (_build, dequant_matmul, flash_attention,
                                     norm, paged_attention, softmax_xent)
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.serving import GenerationEngine, ModelRegistry

NORM_SHAPES = [(16, 64), (6, 40), (32, 512), (1, 7), (33, 1000)]
SERVE_KERNELS = ("rms_norm", "layer_norm", "flash_attention_paged")
# (rows, width): the training path's 4096 x 512, odd sizes and each edge
# of the backward's paths: the register cap 1024 (v2) and 1028 (v1), a
# width not a multiple of 4 (v1), one row past 4096
NORM_BWD_SHAPES = [(4096, 512), (33, 1000), (1, 7), (17, 40), (64, 1024),
                   (64, 1028), (9, 1002), (4097, 512)]
PAGED_CASES = [(0, 1, [5, 9, 17]), (1, 4, [0, 3, 12]), (2, 8, [8, 1, 15]),
               (3, 17, [0, 30, 7]), (4, 32, [2, 0, 40])]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def paged_case(seed, B, H, T, D, bs, num_blocks, positions, lq):
    """One randomized paged attention case (numpy), laid out like the JAX
    package's case builder: every sequence after the first shares
    sequence 0's first physical block, unused table entries point at the
    trash block 0, and pool rows past every frontier hold junk that must
    never leak."""
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, lq, D).astype(np.float32)
    k_pool = rs.randn(H, num_blocks * bs, D).astype(np.float32)
    v_pool = rs.randn(H, num_blocks * bs, D).astype(np.float32)
    tables = np.zeros((B, T), np.int32)
    pos = np.asarray(positions, np.int32)
    nxt = 1
    for b in range(B):
        for j in range(-(-int(pos[b] + lq) // bs)):
            if b > 0 and j == 0:
                tables[b, j] = tables[0, 0]
            else:
                tables[b, j] = nxt
                nxt += 1
    assert nxt <= num_blocks, "case needs a bigger pool"
    return q, k_pool, v_pool, tables, pos


def bf16_ulp(x):
    """One bf16 ulp at magnitude ``x``: ``2**(floor(log2 x) - 7)`` (8
    significant bits), between 2**-8 and 2**-7 of ``x``."""
    return float(2.0 ** (np.floor(np.log2(max(float(x), 1e-30))) - 7))


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width", NORM_SHAPES)
def test_norm_kernels_match_plain(cuda_device, rows, width):
    rs = np.random.RandomState(rows * width)
    x, g, b = _on(cuda_device, rs.randn(rows, width).astype(np.float32),
                  rs.uniform(0.5, 1.5, width).astype(np.float32),
                  rs.randn(width).astype(np.float32))
    before = kernels.launch_counts()
    for got, want in ((norm.rms_norm(x, g), norm.rms_norm_reference(x, g)),
                      (norm.layer_norm(x + 3.0, g, b),
                       norm.layer_norm_reference(x + 3.0, g, b))):
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= \
            1e-5 * want.abs().max().item()
    after = kernels.launch_counts()
    assert after["rms_norm"] == before["rms_norm"] + 1
    assert after["layer_norm"] == before["layer_norm"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 64, 100, 256])
@pytest.mark.parametrize("seed,lq,positions", PAGED_CASES)
def test_paged_kernel_matches_plain(cuda_device, D, seed, lq, positions):
    q, kp, vp, tbl, pos = _on(cuda_device, *paged_case(
        seed, B=3, H=2, T=10, D=D, bs=8, num_blocks=40,
        positions=positions, lq=lq))
    got = paged_attention.flash_attention_paged(q, kp, vp, tbl, pos, 8)
    want = paged_attention.paged_attention_reference(q, kp, vp, tbl, pos, 8)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_paged_kernel_block_larger_than_key_tile(cuda_device):
    """A 64-token block spans two 32-key shared-memory tiles, and a
    partial last block masks the rest of its tile."""
    q, kp, vp, tbl, pos = _on(cuda_device, *paged_case(
        7, B=4, H=3, T=5, D=64, bs=64, num_blocks=20,
        positions=[0, 63, 64, 200], lq=9))
    got = paged_attention.flash_attention_paged(q, kp, vp, tbl, pos, 64)
    want = paged_attention.paged_attention_reference(q, kp, vp, tbl, pos, 64)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_engine_on_card_matches_cpu_and_launches_kernels(cuda_device):
    spec = tlm.lm_spec(num_layers=2, num_hidden=64, num_heads=4,
                       vocab_size=97)
    params = tlm.random_params(spec, seed=5)
    kw = dict(batch_buckets=(1, 2, 4), prompt_buckets=(8,), kv_block=8,
              kv_max=48, prefill_chunk=8)
    rs = np.random.RandomState(6)
    reqs = [dict(tokens=[int(t) for t in rs.randint(0, 97, n)],
                 max_tokens=mt) for n, mt in ((3, 10), (12, 20), (17, 8))]
    streams = {}
    for dev in ("cpu", "cuda"):
        reg = ModelRegistry()
        reg.add_generative_model("m", params, spec,
                                 device=None if dev == "cuda" else "cpu",
                                 **kw)
        kernels.reset_launch_counts()
        eng = GenerationEngine(reg)
        try:
            streams[dev] = [f.result(120).tokens for f in
                            [eng.submit("m", **r) for r in reqs]]
        finally:
            eng.close()
        counts = kernels.launch_counts()
        assert all((counts[k] > 0) == (dev == "cuda") for k in SERVE_KERNELS)
        assert all(counts[k] == 0 for k in set(counts) - set(SERVE_KERNELS))
    assert streams["cuda"] == streams["cpu"]


def _rel(got, want):
    return (got - want).abs().max().item() / want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width", NORM_BWD_SHAPES)
def test_norm_bwd_kernels_match_plain(cuda_device, rows, width):
    rs = np.random.RandomState(rows + width)
    x, g, dy = _on(cuda_device, rs.randn(rows, width).astype(np.float32),
                   rs.uniform(0.5, 1.5, width).astype(np.float32),
                   rs.randn(rows, width).astype(np.float32))
    before = kernels.launch_counts()
    for got, want in (
            (norm.rms_norm_bwd(x, g, dy), norm.rms_norm_bwd_reference(x, g,
                                                                      dy)),
            (norm.layer_norm_bwd(x + 3.0, g, dy),
             norm.layer_norm_bwd_reference(x + 3.0, g, dy))):
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert _rel(a, b) <= 1e-5
    after = kernels.launch_counts()
    assert after["rms_norm_bwd"] == before["rms_norm_bwd"] + 1
    assert after["layer_norm_bwd"] == before["layer_norm_bwd"] + 1


@pytest.mark.cuda
def test_norm_bwd_unaligned_rows_take_v1(cuda_device):
    """Contiguous rows 4 bytes off 16-byte alignment (a slice of a larger
    buffer) take the v1 path and agree with the plain versions."""
    rows, width = 300, 512
    assert norm._bwd_plan(rows, width, 4,
                          norm.sm_count(cuda_device.index)).path == "v1"
    rs = np.random.RandomState(3)
    buf = torch.zeros(2, rows * width + 1, device=cuda_device)
    x, dy = (b[1:].view(rows, width) for b in buf)
    x.copy_(torch.from_numpy(rs.randn(rows, width).astype(np.float32)))
    dy.copy_(torch.from_numpy(rs.randn(rows, width).astype(np.float32)))
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    (g,) = _on(cuda_device, rs.uniform(0.5, 1.5, width).astype(np.float32))
    before = kernels.launch_counts()
    for got, want in (
            (norm.rms_norm_bwd(x, g, dy), norm.rms_norm_bwd_reference(x, g,
                                                                      dy)),
            (norm.layer_norm_bwd(x + 3.0, g, dy),
             norm.layer_norm_bwd_reference(x + 3.0, g, dy))):
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert _rel(a, b) <= 1e-5
    after = kernels.launch_counts()
    assert after["rms_norm_bwd"] == before["rms_norm_bwd"] + 1
    assert after["layer_norm_bwd"] == before["layer_norm_bwd"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [512, 1002])
def test_norm_bwd_is_deterministic(cuda_device, width, dtype):
    """The weight gradients sum fixed partials in a fixed order, with no
    atomics: two launches give the same bits, on every path (fp32: v2 at
    512, v1 at 1002; bf16: v3 at 512, v1 at 1002)."""
    rs = np.random.RandomState(0)
    x, g, dy = (t.to(dtype) for t in _on(
        cuda_device, rs.randn(4096, width).astype(np.float32),
        rs.rand(width).astype(np.float32),
        rs.randn(4096, width).astype(np.float32)))
    for bwd in (norm.rms_norm_bwd, norm.layer_norm_bwd):
        a = bwd(x, g, dy)
        b = bwd(x, g, dy)
        assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.fixture
def forced_path(monkeypatch):
    """``forced_path(path)``: every norm backward launch from here on
    takes ``path`` with that path's grid."""
    def force(path):
        monkeypatch.setattr(
            norm, "_bwd_plan", lambda rows, width, align, sms, dtype, layer:
            norm._bwd_grid(path, rows, width, sms, layer))
    return force


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width", [(4096, 512), (4097, 1024), (33, 8)])
def test_fp32_bits_equal_a_forced_v2_launch_and_v3_agrees(
        cuda_device, forced_path, rows, width):
    """fp32 rows stay on v2: the wrapper's bits equal a launch forced onto
    v2.  bf16 rows on v3 agree with a launch forced onto v2 within one
    bf16 ulp of max|ref| (both sum in fp32 and round once)."""
    rs = np.random.RandomState(rows + width)
    x, g, dy = _on(cuda_device, rs.randn(rows, width).astype(np.float32),
                   rs.uniform(0.5, 1.5, width).astype(np.float32),
                   rs.randn(rows, width).astype(np.float32))
    xb, gb, dyb = (t.to(torch.bfloat16) for t in (x, g, dy))
    planned = [bwd(a, b, c) for bwd in (norm.rms_norm_bwd,
                                        norm.layer_norm_bwd)
               for a, b, c in ((x, g, dy), (xb, gb, dyb))]
    forced_path("v2")
    forced = [bwd(a, b, c) for bwd in (norm.rms_norm_bwd,
                                       norm.layer_norm_bwd)
              for a, b, c in ((x, g, dy), (xb, gb, dyb))]
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(zip(planned, forced)):
        for a, b in zip(got, want):
            if i % 2 == 0:                     # fp32
                assert torch.equal(a, b)
            else:
                _within_bf16_ulp(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,classes", [(4096, 8192), (3, 1000), (5, 7)])
def test_loss_head_kernels_match_plain(cuda_device, rows, classes):
    rs = np.random.RandomState(rows)
    x, lbl = _on(cuda_device,
                 (3 * rs.randn(rows, classes)).astype(np.float32),
                 rs.randint(0, classes, rows).astype(np.float32))
    p = softmax_xent.softmax_rows(x)
    assert _rel(p, softmax_xent.softmax_rows_reference(x)) <= 1e-5
    for scale in (1.0, 1.0 / rows):
        got = softmax_xent.xent_grad_from_probs(p, lbl, scale)
        want = softmax_xent.xent_grad_from_probs_reference(p, lbl, scale)
        assert _rel(got, want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,Lq,Lk,D", [(16, 8, 256, 256, 64),
                                         (2, 3, 40, 40, 8),
                                         (1, 2, 70, 70, 100),
                                         (2, 1, 33, 33, 256),
                                         (1, 2, 16, 48, 32),
                                         (2, 3, 40, 40, 12),
                                         (1, 2, 70, 70, 128),
                                         (1, 2, 1024, 1024, 64),
                                         (2, 2, 64, 256, 64)])
def test_flash_attention_kernel_matches_plain(cuda_device, causal, B, H, Lq,
                                              Lk, D):
    """D <= 128 runs the 3xTF32 tensor-core body, D 256 the CUDA-core
    one; lengths off the 64-row and 64-key tiles, and Lq != Lk."""
    q, k, v = _flash_case(cuda_device, B, H, Lq, Lk, D)
    got = flash_attention.flash_attention(q, k, v, causal)
    want = flash_attention.blockwise_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


def _flash_case(dev, B, H, Lq, Lk, D):
    rs = np.random.RandomState(Lq + D)
    q = rs.randn(B, H, Lq, D).astype(np.float32)
    k, v = (rs.randn(B, H, Lk, D).astype(np.float32) for _ in range(2))
    return _on(dev, q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 100])
def test_flash_attention_kernel_is_deterministic(cuda_device, causal, D):
    """A fixed order of every sum, no atomics and no split of the keys:
    two launches on the same inputs give the same bits."""
    q, k, v = _flash_case(cuda_device, 4, 8, 256, 256, D)
    first = flash_attention.flash_attention(q, k, v, causal)
    assert torch.equal(flash_attention.flash_attention(q, k, v, causal),
                       first)


@pytest.mark.cuda
def test_flash_attention_is_one_launch_a_call(cuda_device):
    q, k, v = _flash_case(cuda_device, 2, 2, 200, 200, 64)
    for causal in (True, False):
        before = kernels.launch_counts()["flash_attention"]
        flash_attention.flash_attention(q, k, v, causal)
        assert kernels.launch_counts()["flash_attention"] == before + 1


@pytest.mark.cuda
def test_flash_attention_leaves_the_offset_count(cuda_device):
    """flash_attention_offset keeps its own body and count: a
    flash_attention call at any D moves neither."""
    before = kernels.launch_counts()["flash_attention_offset"]
    for D in (12, 64, 128, 256):
        q, k, v = _flash_case(cuda_device, 1, 2, 33, 33, D)
        flash_attention.flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_offset"] == before


@pytest.mark.cuda
def test_flash_attention_backward_on_card_matches_cpu(cuda_device):
    rs = np.random.RandomState(3)
    arrays = [rs.randn(2, 2, 64, 32).astype(np.float32) for _ in range(4)]
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        q, k, v, g = _on(dev, *arrays)
        for t in (q, k, v):
            t.requires_grad_(True)
        out = flash_attention.FlashAttention.apply(q, k, v, True, 0.2)
        out.backward(g)
        grads[dev.type] = [t.grad.cpu() for t in (q, k, v)]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert (a - b).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_training_step_on_card_matches_cpu_and_launches(cuda_device):
    """One Module step of a small LM: the card's probabilities and
    gradients equal the CPU's, and every training kernel launched the
    expected number of times."""
    L, nl = 32, 2
    net = mx.models.transformer_lm(seq_len=L, num_layers=nl, num_hidden=64,
                                   num_heads=2, vocab_size=97)
    params = tlm.random_params(tlm.lm_spec(nl, 64, 2, 97), seed=1)
    rs = np.random.RandomState(2)
    X = rs.randint(0, 97, (4, L)).astype(np.float32)
    y = ((X + 1) % 97).astype(np.float32)
    res = {}
    for dev in (cuda_device, torch.device("cpu")):
        it = mx.io.NDArrayIter(X, y, batch_size=4)
        mod = mx.Module(net, context=dev)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params=params)
        kernels.reset_launch_counts()
        mod.forward_backward(next(iter(it)))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        ex = mod._exec_group.executor
        res[dev.type] = [ex.outputs[0]._data.cpu()] + [
            ex.grad_dict[n]._data.cpu() for n in sorted(ex.grad_dict)]
        want = dict.fromkeys(counts, 0)
        if dev.type == "cuda":
            want.update(rms_norm=2 * nl, rms_norm_bwd=2 * nl, layer_norm=1,
                        layer_norm_bwd=1, softmax_rows=1,
                        xent_grad_from_probs=1, flash_attention=nl)
        assert counts == want
    for a, b in zip(res["cuda"], res["cpu"]):
        assert _rel(a, b) <= 1e-3


# ---------------------------------------------------------------------------
# int8 serving and the contiguous plane
# ---------------------------------------------------------------------------
# (N, K) of the LM's q/k/v/proj, ffn1, ffn2 and pred products at full width
LM_NK = [(512, 512), (2048, 512), (512, 2048), (8192, 512)]
# both regimes of the kernel: the decode GEMV (M <= 32) and the prefill
# tensor-core tile, at the LM's shapes, odd shapes and K tails of 16
DQ_SHAPES = [(M, N, K) for M in (1, 2, 8, 16, 31, 32, 33, 64, 256, 512,
                                  1024)
             for N, K in LM_NK] + [(7, 50, 48), (1, 8, 16), (65, 70, 80),
                                   (40, 136, 1040), (3, 100, 1040)]


def _dq_case(dev, granularity, M, N, K):
    rs = np.random.RandomState(M + N + K)
    codes, scales = dequant_matmul.quantize_int8(
        rs.randn(N, K).astype(np.float32), granularity)
    return _on(dev, rs.randn(M, K).astype(np.float32), codes, scales)


@pytest.mark.cuda
@pytest.mark.parametrize("granularity", ["row", "tensor"])
@pytest.mark.parametrize("M,N,K", DQ_SHAPES)
def test_dequant_matmul_kernel_matches_plain(cuda_device, granularity, M, N,
                                             K):
    x, c, s = _dq_case(cuda_device, granularity, M, N, K)
    before = kernels.launch_counts()["dequant_matmul"]
    got = dequant_matmul.dequant_matmul(x, c, s)
    want = dequant_matmul.dequant_matmul_dense(x, c, s)
    torch.cuda.synchronize()
    assert got.shape == (M, N)
    assert _rel(got, want) <= 1e-5
    assert kernels.launch_counts()["dequant_matmul"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", [(1, 8192, 512), (32, 512, 2048),
                                   (7, 50, 48), (1024, 512, 2048),
                                   (65, 70, 80)])
def test_dequant_matmul_kernel_is_deterministic(cuda_device, M, N, K):
    """The split-K GEMV adds its slices in a fixed order and the tile its
    k tiles, so every launch on the same inputs gives the same bits."""
    x, c, s = _dq_case(cuda_device, "row", M, N, K)
    first = dequant_matmul.dequant_matmul(x, c, s)
    for _ in range(4):
        assert torch.equal(dequant_matmul.dequant_matmul(x, c, s), first)


@pytest.mark.cuda
def test_dequant_matmul_kernel_refuses_ragged_k(cuda_device):
    x, c, s = _on(cuda_device, np.zeros((3, 24), np.float32),
                  np.zeros((5, 24), np.int8), np.ones(5, np.float32))
    with pytest.raises(ValueError, match="multiple of 16"):
        dequant_matmul.dequant_matmul(x, c, s)


@pytest.mark.cuda
def test_dequant_matmul_kernel_empty_output_and_k_zero(cuda_device):
    before = kernels.launch_counts()["dequant_matmul"]
    x, c, s = _on(cuda_device, np.zeros((3, 32), np.float32),
                  np.zeros((0, 32), np.int8), np.ones(0, np.float32))
    assert dequant_matmul.dequant_matmul(x, c, s).shape == (3, 0)
    x, c, s = _on(cuda_device, np.zeros((3, 0), np.float32),
                  np.zeros((5, 0), np.int8), np.ones(5, np.float32))
    with pytest.raises(ValueError, match="positive multiple of 16"):
        dequant_matmul.dequant_matmul(x, c, s)
    assert kernels.launch_counts()["dequant_matmul"] == before


def int8_paged_case(seed, B, H, T, D, bs, num_blocks, positions, lq):
    """paged_case's layout over int8 code pools; every (head, block)
    has its own scale."""
    q, _, _, tables, pos = paged_case(seed, B, H, T, D, bs, num_blocks,
                                      positions, lq)
    rs = np.random.RandomState(seed + 1000)
    kc, vc = (rs.randint(-127, 128, (H, num_blocks * bs, D)).astype(np.int8)
              for _ in range(2))
    sk, sv = (rs.uniform(0.005, 0.02, (H, num_blocks)).astype(np.float32)
              for _ in range(2))
    return q, kc, vc, tables, pos, sk, sv


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64, 128, 256])
@pytest.mark.parametrize("seed,lq,positions", PAGED_CASES)
def test_int8_paged_kernel_matches_plain(cuda_device, D, seed, lq,
                                         positions):
    q, kc, vc, tbl, pos, sk, sv = _on(cuda_device, *int8_paged_case(
        seed, B=3, H=2, T=10, D=D, bs=8, num_blocks=40, positions=positions,
        lq=lq))
    before = kernels.launch_counts()
    got = paged_attention.flash_attention_paged(q, kc, vc, tbl, pos, 8,
                                                kv_scales=(sk, sv))
    want = paged_attention.paged_attention_reference(q, kc, vc, tbl, pos, 8,
                                                     kv_scales=(sk, sv))
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4
    after = kernels.launch_counts()
    assert after["flash_attention_paged_int8"] == \
        before["flash_attention_paged_int8"] + 1
    assert after["flash_attention_paged"] == before["flash_attention_paged"]


@pytest.mark.cuda
def test_int8_paged_kernel_block_larger_than_key_tile(cuda_device):
    """A 64-token block spans two 32-key tiles; a 16-token block puts
    two physical blocks, with two scales, in one tile."""
    for bs, positions in ((64, [0, 63, 64, 200]), (16, [5, 17, 40, 70])):
        q, kc, vc, tbl, pos, sk, sv = _on(cuda_device, *int8_paged_case(
            7, B=4, H=3, T=-(-300 // bs), D=64, bs=bs, num_blocks=80,
            positions=positions, lq=9))
        got = paged_attention.flash_attention_paged(q, kc, vc, tbl, pos, bs,
                                                    kv_scales=(sk, sv))
        want = paged_attention.paged_attention_reference(
            q, kc, vc, tbl, pos, bs, kv_scales=(sk, sv))
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 1e-4


# head dims of the paged kernel's new bodies (the decode body and the
# tile: D <= 128) by pool dtype, each a multiple of its 16-byte row; 256
# takes v1
PAGED_BODY_DIMS = {torch.float32: (8, 64, 100), torch.bfloat16: (8, 64, 104),
                   torch.int8: (16, 64, 112)}


def _paged_body_cases():
    """(dtype, D, Lq): each side of the decode body's threshold, the
    prefill chunk Lq 32 and one past it."""
    for dtype, dims in PAGED_BODY_DIMS.items():
        m = paged_attention.DECODE_MAX_LQ[dtype]
        for D in dims + (256,):
            for lq in sorted({m, m + 1, 32, 33}):
                yield dtype, D, lq


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,lq", list(_paged_body_cases()))
def test_paged_bodies_match_plain_v1_and_themselves(cuda_device, monkeypatch,
                                                    dtype, D, lq):
    """The body ``_plan`` picks against the plain version (1e-4; bf16: one
    ulp of max|ref| plus 1e-4) and against v1 on the same inputs, with
    positions 0 and T * bs - Lq; two launches give the same bits."""
    B, H, T, bs = 3, 2, 10, 8
    positions = [0, T * bs - lq, 17]
    if dtype == torch.int8:
        q, kp, vp, tbl, pos, sk, sv = _on(cuda_device, *int8_paged_case(
            lq + D, B, H, T, D, bs, 40, positions, lq))
        kw = {"kv_scales": (sk, sv)}
    else:
        q, kp, vp, tbl, pos = _on(cuda_device, *paged_case(
            lq + D, B, H, T, D, bs, 40, positions, lq))
        q, kp, vp = (t.to(dtype) for t in (q, kp, vp))
        kw = {}
    name = paged_attention._VARIANTS[dtype][0]
    path = paged_attention._plan(B, H, lq, D, dtype, 132).path
    assert path == ("v1" if D > 128 else "decode"
                    if lq <= paged_attention.DECODE_MAX_LQ[dtype] else "tile")
    want = paged_attention.paged_attention_reference(q, kp, vp, tbl, pos, bs,
                                                     **kw).float()
    tol = (bf16_ulp(want.abs().max().item()) if dtype == torch.bfloat16
           else 0.0) + 1e-4
    before = kernels.launch_counts()[name]
    got = paged_attention.flash_attention_paged(q, kp, vp, tbl, pos, bs, **kw)
    again = paged_attention.flash_attention_paged(q, kp, vp, tbl, pos, bs,
                                                  **kw)
    monkeypatch.setattr(paged_attention, "_plan",
                        lambda B, H, Lq, D, dt, sms:
                        paged_attention._path_plan("v1", B, H, Lq, sms))
    v1 = paged_attention.flash_attention_paged(q, kp, vp, tbl, pos, bs, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 3
    assert got.dtype == q.dtype and bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    assert (got.float() - want).abs().max().item() <= tol
    assert (v1.float() - want).abs().max().item() <= tol
    assert (got.float() - v1.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_int8_paged_kernel_refuses_head_dim(cuda_device):
    q, kc, vc, tbl, pos, sk, sv = _on(cuda_device, *int8_paged_case(
        0, B=2, H=2, T=4, D=8, bs=8, num_blocks=12, positions=[3, 9], lq=1))
    with pytest.raises(ValueError, match="multiple of 16"):
        paged_attention.flash_attention_paged(q, kc, vc, tbl, pos, 8,
                                              kv_scales=(sk, sv))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Lq,Lk,D,offsets", [
    (32, 8, 1, 1024, 64, None), (3, 2, 1, 40, 8, [39, 0, 17]),
    (2, 3, 5, 70, 100, [0, 60]), (2, 1, 33, 96, 256, [10, 63]),
    (1, 2, 16, 48, 32, [32])])
def test_offset_kernel_matches_plain(cuda_device, B, H, Lq, Lk, D, offsets):
    rs = np.random.RandomState(Lk + D)
    if offsets is None:
        offsets = rs.randint(0, Lk, B)
    q = rs.randn(B, H, Lq, D).astype(np.float32)
    k, v = (rs.randn(B, H, Lk, D).astype(np.float32) for _ in range(2))
    q, k, v, ofs = _on(cuda_device, q, k, v, np.asarray(offsets, np.int32))
    before = kernels.launch_counts()
    got = flash_attention.flash_attention_offset(q, k, v, ofs)
    want = flash_attention.offset_attention_reference(q, k, v, ofs)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4
    after = kernels.launch_counts()
    assert after["flash_attention_offset"] == \
        before["flash_attention_offset"] + 1
    assert after["flash_attention"] == before["flash_attention"]


@pytest.mark.cuda
def test_offset_kernel_refuses_head_dim(cuda_device):
    q, ofs = _on(cuda_device, np.zeros((2, 1, 1, 6), np.float32),
                 np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="multiple of 4"):
        flash_attention.flash_attention_offset(q, q, q, ofs)


@pytest.mark.cuda
@pytest.mark.parametrize("plane", ["int8", "contiguous"])
def test_int8_and_contiguous_engines_on_card_match_cpu(cuda_device, plane):
    spec = tlm.lm_spec(num_layers=2, num_hidden=64, num_heads=4,
                       vocab_size=97)
    params = tlm.random_params(spec, seed=5)
    kw = dict(batch_buckets=(1, 2, 4), prompt_buckets=(8, 24), kv_block=8,
              kv_max=48, prefill_chunk=8)
    if plane == "int8":
        kw.update(compute_dtype="int8", kv_dtype="int8")
        used = {"rms_norm", "layer_norm", "dequant_matmul",
                "flash_attention_paged_int8"}
    else:
        kw.update(paged=False)
        used = {"rms_norm", "layer_norm", "flash_attention",
                "flash_attention_offset"}
    rs = np.random.RandomState(6)
    reqs = [dict(tokens=[int(t) for t in rs.randint(0, 97, n)],
                 max_tokens=mt) for n, mt in ((3, 10), (12, 20), (17, 8))]
    streams = {}
    for dev in ("cpu", "cuda"):
        reg = ModelRegistry()
        reg.add_generative_model("m", params, spec,
                                 device=None if dev == "cuda" else "cpu",
                                 **kw)
        kernels.reset_launch_counts()
        eng = GenerationEngine(reg)
        try:
            streams[dev] = [f.result(120).tokens for f in
                            [eng.submit("m", **r) for r in reqs]]
        finally:
            eng.close()
        counts = kernels.launch_counts()
        assert all((counts[k] > 0) == (dev == "cuda") for k in used)
        assert all(counts[k] == 0 for k in set(counts) - used)
    assert streams["cuda"] == streams["cpu"]


# ---------------------------------------------------------------------------
# the imperative plane: softmax_xent_loss, fused_softmax, rtc
# ---------------------------------------------------------------------------
def _xent_labels(rs, rows, classes):
    """Random labels, then the edges: column 0, the last column, out of
    range on both sides and a fraction."""
    lbl = rs.randint(0, classes, rows).astype(np.float32)
    edges = [0.0, classes - 1.0, -1.0, float(classes), classes + 7.0, 1.5]
    lbl[:min(rows, len(edges))] = edges[:rows]
    return lbl


@pytest.mark.cuda
@pytest.mark.parametrize("rows,classes", [(4096, 8192), (3, 1000), (6, 7),
                                          (5, 8), (2, 2)])
def test_softmax_xent_loss_kernels_match_plain(cuda_device, rows, classes):
    rs = np.random.RandomState(rows + classes)
    x, lbl, g = _on(cuda_device,
                    (3 * rs.randn(rows, classes)).astype(np.float32),
                    _xent_labels(rs, rows, classes),
                    rs.uniform(0.5, 2.0, rows).astype(np.float32))
    before = kernels.launch_counts()
    loss = softmax_xent.xent_loss_rows(x, lbl)
    grad = softmax_xent.softmax_xent_loss_grad(x, lbl, g)
    torch.cuda.synchronize()
    assert _rel(loss, softmax_xent.xent_loss_rows_reference(x, lbl)) <= 1e-5
    assert _rel(grad, softmax_xent.softmax_xent_loss_grad_reference(
        x, lbl, g)) <= 1e-5
    after = kernels.launch_counts()
    for name in ("softmax_xent_loss", "softmax_xent_loss_grad"):
        assert after[name] == before[name] + 1


@pytest.mark.cuda
def test_softmax_xent_loss_kernels_take_unaligned_rows(cuda_device):
    """A row start off 16 bytes takes the scalar loop."""
    rs = np.random.RandomState(9)
    (base,) = _on(cuda_device, rs.randn(5 * 8 + 1).astype(np.float32))
    x = base[1:].reshape(5, 8)
    lbl = torch.tensor([0.0, 7.0, 3.0, 9.0, -2.0], device=cuda_device)
    g = torch.ones(5, device=cuda_device)
    assert _rel(softmax_xent.xent_loss_rows(x, lbl),
                softmax_xent.xent_loss_rows_reference(x, lbl)) <= 1e-5
    assert _rel(softmax_xent.softmax_xent_loss_grad(x, lbl, g),
                softmax_xent.softmax_xent_loss_grad_reference(x, lbl,
                                                              g)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("rows,classes", [(4096, 8192), (3, 1000), (5, 7)])
def test_fused_softmax_kernels_match_plain(cuda_device, rows, classes):
    rs = np.random.RandomState(rows * 3 + classes)
    x, dy = _on(cuda_device, (3 * rs.randn(rows, classes)).astype(np.float32),
                rs.randn(rows, classes).astype(np.float32))
    xl = x.clone().requires_grad_(True)
    p = softmax_xent.fused_softmax(xl)
    (dx,) = torch.autograd.grad(p, xl, dy)
    pr = softmax_xent.softmax_rows_reference(x)
    assert _rel(p, pr) <= 1e-5
    assert _rel(dx, softmax_xent.softmax_rows_bwd_reference(p.detach(),
                                                            dy)) <= 1e-5


@pytest.mark.cuda
def test_softmax_cross_entropy_op_on_card_matches_cpu(cuda_device):
    rs = np.random.RandomState(4)
    x = (3 * rs.randn(64, 300)).astype(np.float32)
    lbl = _xent_labels(rs, 64, 300)
    res = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        data, label = mx.nd.array(x, ctx=ctx), mx.nd.array(lbl, ctx=ctx)
        data.attach_grad()
        with mx.autograd.record():
            loss = mx.nd.softmax_cross_entropy(data, label)
        loss.backward()
        res[ctx.device_type] = (loss._data.cpu(), data.grad._data.cpu())
    for a, b in zip(res["gpu"], res["cpu"]):
        assert _rel(a, b) <= 1e-5


@pytest.mark.cuda
def test_imperative_lm_step_on_card_matches_cpu_and_launches(cuda_device):
    spec = tlm.lm_spec(2, 64, 2, 97)
    params = tlm.random_params(spec, seed=6)
    rs = np.random.RandomState(7)
    X = rs.randint(0, 97, (4, 32)).astype(np.float32)
    y = ((X + 1) % 97).astype(np.float32)
    res = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        with ctx:
            w = {k: mx.nd.array(v) for k, v in params.items()}
            for v in w.values():
                v.attach_grad()
            kernels.reset_launch_counts()
            with mx.autograd.record():
                loss = tlm.imperative_loss(mx.nd, w, mx.nd.array(X),
                                           mx.nd.array(y), 32, spec)
            loss.backward()
            mx.nd.waitall()
            counts = kernels.launch_counts()
        res[ctx.device_type] = [loss._data.cpu()] + [
            w[k].grad._data.cpu() for k in sorted(w)]
        want = dict.fromkeys(counts, 0)
        if ctx.device_type == "gpu":
            want.update(rms_norm=4, rms_norm_bwd=4, layer_norm=1,
                        layer_norm_bwd=1, softmax_xent_loss=1,
                        softmax_xent_loss_grad=1, flash_attention=2)
        assert counts == want
    for a, b in zip(res["gpu"], res["cpu"]):
        assert _rel(a, b) <= 1e-3


RTC_FMA1 = r'''
extern "C" __global__ void fma1(const float* x, const float* y, float* o,
                                int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] * y[i] + 1.0f;
}
'''

RTC_SPLIT = r'''
extern "C" __global__ void split(const int* a, float* lo, int* hi, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    lo[i] = static_cast<float>(a[i] & 0xff);
    hi[i] = a[i] >> 8;
  }
}
'''


@pytest.mark.cuda
def test_rtc_kernel_launches_and_matches_addcmul(cuda_device):
    rs = np.random.RandomState(8)
    with mx.gpu(0):
        x = mx.nd.array(rs.randn(1000, 7).astype(np.float32))
        y = mx.nd.array(rs.randn(1000, 7).astype(np.float32))
        k = mx.rtc.CudaKernel("fma1", RTC_FMA1)
        before = kernels.launch_counts()["rtc"]
        out = k.push([x, y], [mx.nd.empty(x.shape)])
        called = k(x, y)
        grid = k.push([x, y], mx.nd.zeros(x.shape), grid_dims=(7,),
                      block_dims=(1000,))
    want = torch.addcmul(torch.ones_like(x._data), x._data, y._data)
    ulp = torch.nextafter(want.abs(), torch.tensor(float("inf"),
                                                   device=cuda_device)) - \
        want.abs()
    prod = (x._data * y._data).abs()
    bound = 2 * torch.maximum(ulp, torch.nextafter(
        prod, torch.tensor(float("inf"), device=cuda_device)) - prod)
    for got in (out, called, grid):
        assert bool(((got._data - want).abs() <= bound).all())
    assert kernels.launch_counts()["rtc"] == before + 3


@pytest.mark.cuda
def test_rtc_kernel_with_int_inputs_and_two_outputs(cuda_device):
    a = np.arange(-300, 700, dtype=np.int32) * 37
    with mx.gpu(0):
        k = mx.rtc.CudaKernel("split", RTC_SPLIT)
        lo, hi = k.push(mx.nd.array(a), [mx.nd.zeros(a.shape),
                                         mx.nd.zeros(a.shape,
                                                     dtype="int32")],
                        grid_dims=(2,), block_dims=(64,))
    assert np.array_equal(lo.asnumpy(), (a & 0xff).astype(np.float32))
    assert np.array_equal(hi.asnumpy(), a >> 8)


@pytest.mark.cuda
def test_rtc_kernel_of_the_wrong_arity_fails_to_build(cuda_device):
    with mx.gpu(0):
        k = mx.rtc.CudaKernel("fma1", RTC_FMA1)
        x = mx.nd.ones((4,))
        with pytest.raises(kernels._build.KernelError, match="nvcc failed"):
            k.push([x], [x])


# ---------------------------------------------------------------------------
# bf16 serving: the bf16 norms and paged attention, and the Embedding rule
# ---------------------------------------------------------------------------
def _bf16_on(dev, *arrays):
    return [t.to(torch.bfloat16) for t in _on(dev, *arrays)]


def _within_bf16_ulp(got, want, extra=0.0):
    """max|got - want| within one bf16 ulp of max|want| (plus
    ``extra``): the kernel and its plain version sum in another order
    before the one rounding to bf16."""
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= bf16_ulp(want.float().abs().max().item()) + extra, err


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width,offset", [
    (16, 64, 0), (6, 40, 0), (32, 512, 0), (4096, 512, 0), (1, 7, 0),
    (33, 1000, 0), (5, 16, 1)])
def test_bf16_norm_kernels_match_plain(cuda_device, rows, width, offset):
    """bf16 RMSNorm and LayerNorm forward, the 16-byte path (width a
    multiple of 8) and the element path (width 7, or rows that start
    off a 16-byte boundary), counted under their bf16 names."""
    rs = np.random.RandomState(rows * width)
    xa, g, b = _bf16_on(cuda_device,
                        rs.randn(rows + offset, width).astype(np.float32),
                        rs.uniform(0.5, 1.5, width).astype(np.float32),
                        rs.randn(width).astype(np.float32))
    x = xa[offset:]
    before = kernels.launch_counts()
    _within_bf16_ulp(norm.rms_norm(x, g), norm.rms_norm_reference(x, g))
    x3 = (x.float() + 3.0).to(torch.bfloat16)
    got = norm.layer_norm(x3, g, b)
    assert got.dtype == torch.bfloat16
    _within_bf16_ulp(got, norm.layer_norm_reference(x3, g, b))
    after = kernels.launch_counts()
    assert after["rms_norm_bf16"] == before["rms_norm_bf16"] + 1
    assert after["layer_norm_bf16"] == before["layer_norm_bf16"] + 1
    assert after["rms_norm"] == before["rms_norm"]
    assert after["layer_norm"] == before["layer_norm"]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 64, 104, 256])
@pytest.mark.parametrize("seed,lq,positions", PAGED_CASES)
def test_bf16_paged_kernel_matches_plain(cuda_device, D, seed, lq,
                                         positions):
    q, kp, vp = _bf16_on(cuda_device, *paged_case(
        seed, B=3, H=2, T=10, D=D, bs=8, num_blocks=40,
        positions=positions, lq=lq)[:3])
    tbl, pos = _on(cuda_device, *paged_case(
        seed, B=3, H=2, T=10, D=D, bs=8, num_blocks=40,
        positions=positions, lq=lq)[3:])
    before = kernels.launch_counts()
    got = paged_attention.flash_attention_paged(q, kp, vp, tbl, pos, 8)
    assert got.dtype == torch.bfloat16
    _within_bf16_ulp(got, paged_attention.paged_attention_reference(
        q, kp, vp, tbl, pos, 8), 1e-4)
    after = kernels.launch_counts()
    assert after["flash_attention_paged_bf16"] == \
        before["flash_attention_paged_bf16"] + 1
    assert after["flash_attention_paged"] == before["flash_attention_paged"]


@pytest.mark.cuda
def test_bf16_paged_kernel_block_larger_than_key_tile(cuda_device):
    case = paged_case(7, B=4, H=3, T=5, D=64, bs=64, num_blocks=20,
                      positions=[0, 63, 64, 200], lq=9)
    q, kp, vp = _bf16_on(cuda_device, *case[:3])
    tbl, pos = _on(cuda_device, *case[3:])
    _within_bf16_ulp(
        paged_attention.flash_attention_paged(q, kp, vp, tbl, pos, 64),
        paged_attention.paged_attention_reference(q, kp, vp, tbl, pos, 64),
        1e-4)


@pytest.mark.cuda
def test_int8_pool_takes_a_bf16_query(cuda_device):
    """bf16 compute over an int8 pool: q is widened for the int8 kernel
    (exactly) and the output rounded back to bf16."""
    q, _, _, tbl, pos = paged_case(1, B=3, H=2, T=10, D=64, bs=8,
                                   num_blocks=40, positions=[0, 3, 12], lq=4)
    rs = np.random.RandomState(3)
    kc, vc = (rs.randint(-127, 128, (2, 320, 64)).astype(np.int8)
              for _ in range(2))
    sk, sv = (rs.uniform(0.005, 0.02, (2, 40)).astype(np.float32)
              for _ in range(2))
    (qb,) = _bf16_on(cuda_device, q)
    kc, vc, tbl, pos, sk, sv = _on(cuda_device, kc, vc, tbl, pos, sk, sv)
    before = kernels.launch_counts()
    got = paged_attention.flash_attention_paged(qb, kc, vc, tbl, pos, 8,
                                                kv_scales=(sk, sv))
    want = paged_attention.flash_attention_paged(qb.float(), kc, vc, tbl, pos,
                                                 8, kv_scales=(sk, sv))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))
    after = kernels.launch_counts()
    assert after["flash_attention_paged_int8"] == \
        before["flash_attention_paged_int8"] + 2
    assert after["flash_attention_paged_bf16"] == \
        before["flash_attention_paged_bf16"]


@pytest.mark.cuda
@pytest.mark.parametrize("compute,kv", [("bfloat16", "bfloat16"),
                                        ("bfloat16", "int8"),
                                        ("int8", "bfloat16")])
def test_bf16_paged_step_on_card_matches_cpu(cuda_device, compute, kv):
    """One prefill chunk and one decode step of a bf16 store on the card
    and on the CPU: logits within 2e-2 x max|ref|, the bf16 kernels
    launched and their fp32 forms not."""
    spec = tlm.lm_spec(num_layers=2, num_hidden=64, num_heads=4,
                       vocab_size=97)
    params = tlm.random_params(spec, seed=5)
    kw = dict(batch_buckets=(4,), prompt_buckets=(8,), kv_block=8, kv_max=48,
              prefill_chunk=8, compute_dtype=compute, kv_dtype=kv,
              warmup=False)
    rs = np.random.RandomState(9)
    tables = np.arange(1, 4 * 6 + 1, dtype=np.int32).reshape(4, 6)
    chunk = rs.randint(0, 97, (4, 8)).astype(np.int32)
    valid = np.array([8, 5, 1, 8], np.int32)
    logits = {}
    for dev in ("cpu", "cuda"):
        store = ModelRegistry().add_generative_model(
            "m", params, spec, device=None if dev == "cuda" else "cpu", **kw)
        pools = store.new_pool()
        scales = store.new_scale_pool() if kv == "int8" else None
        kernels.reset_launch_counts()
        out = []
        for toks, p0, val in ((chunk, np.zeros(4, np.int32), valid),
                              (chunk[:, :1], valid, np.ones(4, np.int32))):
            res = store.run_paged_step(*pools, tables, toks, p0, val,
                                       scales=scales)
            out.append(res[0].cpu())
        logits[dev] = out
        counts = kernels.launch_counts()
    for a, b in zip(logits["cuda"], logits["cpu"]):
        assert bool(torch.isfinite(a).all())
        assert _rel(a, b) <= 2e-2
    used = {"rms_norm_bf16", "layer_norm_bf16"} if compute == "bfloat16" \
        else {"rms_norm", "layer_norm", "dequant_matmul"}
    used.add("flash_attention_paged_bf16" if kv == "bfloat16"
             else "flash_attention_paged_int8")
    assert all(counts[k] > 0 for k in used)
    assert all(counts[k] == 0 for k in set(counts) - used)


@pytest.mark.cuda
def test_embedding_ids_outside_the_table_on_card(cuda_device):
    """Ids outside [0, n) are clamped before the gather (no device-side
    assert): [-n, 0) wraps, anything else is a NaN row."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3) + 1
    ids = np.array([-5, -4, -1, 0, 3, 4], np.float32)
    with mx.gpu(0):
        out = mx.nd.Embedding(mx.nd.array(ids), mx.nd.array(table),
                              input_dim=4, output_dim=3).asnumpy()
        after = (mx.nd.array(table) * 2).asnumpy()     # the context lives
    assert np.array_equal(out[1:5], table[[0, 3, 0, 3]])
    assert np.isnan(out[0]).all() and np.isnan(out[5]).all()
    assert np.array_equal(after, table * 2)


# ---------------------------------------------------------------------------
# flash attention's bodies (decode, tile, wgmma, v1) in fp32 and bf16
# ---------------------------------------------------------------------------
FLASH_DTYPES = (torch.float32, torch.bfloat16)


def _flash_body_cases():
    """(dtype, offset entry point, Lq, Lk, D): Lq on each side of the
    decode threshold and of the tile's 64 rows, Lk off the 64-key tile,
    D 64 and 128 (decode and tile) and 136 (v1)."""
    for dtype in FLASH_DTYPES:
        m = flash_attention.DECODE_MAX_LQ[dtype]
        for offset in (True, False):
            for lq in sorted({m, m + 1, 64, 65}):
                for D in (64, 128, 136):
                    yield dtype, offset, lq, (lq + 35 if offset else lq), D


def _flash_run(offset, q, k, v, ofs):
    if offset:
        return flash_attention.flash_attention_offset(q, k, v, ofs)
    return flash_attention.flash_attention(q, k, v, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,offset,lq,lk,D", list(_flash_body_cases()))
def test_flash_bodies_match_plain_v1_and_themselves(cuda_device, monkeypatch,
                                                    dtype, offset, lq, lk, D):
    """The body ``_plan`` picks and every other body of the entry point,
    against the plain version (fp32 1e-4; bf16 one ulp of max|ref| plus
    1e-4) and against v1, with offsets 0 and Lk - Lq; each launch is one
    count under its name, and two launches give the same bits."""
    B, H = 3, 2
    rs = np.random.RandomState(lq + lk + D)
    q = rs.randn(B, H, lq, D).astype(np.float32)
    k, v = (rs.randn(B, H, lk, D).astype(np.float32) for _ in range(2))
    ofs = np.asarray([0, lk - lq, (lk - lq) // 2], np.int32)
    q, k, v, ofs = _on(cuda_device, q, k, v, ofs)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    want = (flash_attention.offset_attention_reference(q, k, v, ofs)
            if offset else flash_attention.blockwise_attention(q, k, v, True)
            ).float()
    tol = (bf16_ulp(want.abs().max().item()) if dtype == torch.bfloat16
           else 0.0) + 1e-4
    name = flash_attention._VARIANTS[dtype][1 if offset else 0][0]
    plan = flash_attention._plan(B, H, lq, lk, D, dtype, 132, offset=offset)
    wgmma = dtype == torch.bfloat16 and not offset
    assert plan.path == ("v1" if D > 128 else "decode"
                         if lq <= flash_attention.DECODE_MAX_LQ[dtype]
                         else "wgmma" if wgmma else "tile")
    outs = {}
    plan_fn = flash_attention._plan
    for path in ("planned", "v1", "decode", "tile", "wgmma"):
        if path != "planned":
            if (D > 128 and path != "v1") or (path == "wgmma" and not wgmma):
                continue
            monkeypatch.setattr(
                flash_attention, "_plan",
                lambda B, H, Lq, Lk, D, dt, sms, offset=False, p=path:
                flash_attention._path_plan(p, B, H, Lq))
        before = kernels.launch_counts()[name]
        got = _flash_run(offset, q, k, v, ofs)
        again = _flash_run(offset, q, k, v, ofs)
        torch.cuda.synchronize()
        assert kernels.launch_counts()[name] == before + 2
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        assert torch.equal(got, again), path
        assert (got.float() - want).abs().max().item() <= tol, path
        outs[path] = got.float()
        monkeypatch.setattr(flash_attention, "_plan", plan_fn)
    for path, got in outs.items():
        assert (got - outs["v1"]).abs().max().item() <= tol, path


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lk", [(32, 1024), (16, 512)])
def test_fp32_offset_decode_body_agrees_with_v1(cuda_device, monkeypatch, B,
                                               Lk):
    """At the serving shapes (H8 Lq1 D64, ragged offsets) the fp32
    decode body agrees with v1, the body of earlier slices, within
    1e-4, and the bf16 decode body with the bf16 plain version."""
    rs = np.random.RandomState(B + Lk)
    q = rs.randn(B, 8, 1, 64).astype(np.float32)
    k, v = (rs.randn(B, 8, Lk, 64).astype(np.float32) for _ in range(2))
    ofs = rs.randint(0, Lk, B).astype(np.int32)
    q, k, v, ofs = _on(cuda_device, q, k, v, ofs)
    assert flash_attention._plan(B, 8, 1, Lk, 64, torch.float32,
                                 132).path == "decode"
    got = flash_attention.flash_attention_offset(q, k, v, ofs)
    monkeypatch.setattr(flash_attention, "_plan",
                        lambda B, H, Lq, Lk, D, dt, sms, offset=False:
                        flash_attention._path_plan("v1", B, H, Lq))
    v1 = flash_attention.flash_attention_offset(q, k, v, ofs)
    torch.cuda.synchronize()
    assert (got - v1).abs().max().item() <= 1e-4
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    monkeypatch.undo()
    _within_bf16_ulp(flash_attention.flash_attention_offset(qb, kb, vb, ofs),
                     flash_attention.offset_attention_reference(qb, kb, vb,
                                                                ofs), 1e-4)


# bf16 flash_attention's wgmma body at chip_smoke.py phase 2's shapes:
# (B, H, Lq, Lk, D, causal), the paths' and the ragged edges
WGMMA_CASES = [(4, 8, 512, 512, 64, True), (16, 8, 512, 512, 64, True),
               (16, 8, 256, 256, 64, True), (16, 8, 256, 256, 64, False),
               (2, 2, 70, 70, 16, True), (2, 2, 33, 100, 64, False),
               (2, 2, 20, 20, 128, True), (3, 2, 130, 300, 128, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Lq,Lk,D,causal", WGMMA_CASES)
def test_wgmma_body_matches_plain_and_tile(cuda_device, monkeypatch, B, H, Lq,
                                           Lk, D, causal):
    """The wgmma body against the plain version and the mma.sync tile
    (one bf16 ulp of max|ref| plus 1e-4); one launch a call, the same
    bits twice."""
    rs = np.random.RandomState(B + Lq + Lk + D)
    q = rs.randn(B, H, Lq, D).astype(np.float32)
    k, v = (rs.randn(B, H, Lk, D).astype(np.float32) for _ in range(2))
    q, k, v = (t.to(torch.bfloat16) for t in _on(cuda_device, q, k, v))
    want = flash_attention.blockwise_attention(q, k, v, causal).float()
    tol = bf16_ulp(want.abs().max().item()) + 1e-4
    plan = flash_attention._plan(B, H, Lq, Lk, D, torch.bfloat16, 132)
    assert (plan.path, plan.block_q) == ("wgmma", 64)
    outs = {}
    for path in ("wgmma", "tile"):
        if path == "tile":
            monkeypatch.setattr(
                flash_attention, "_plan",
                lambda B, H, Lq, Lk, D, dt, sms, offset=False:
                flash_attention._path_plan("tile", B, H, Lq))
        before = kernels.launch_counts()["flash_attention_bf16"]
        got = flash_attention.flash_attention(q, k, v, causal)
        again = flash_attention.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        monkeypatch.undo()
        assert kernels.launch_counts()["flash_attention_bf16"] == before + 2
        assert got.dtype == torch.bfloat16 and torch.equal(got, again)
        assert (got.float() - want).abs().max().item() <= tol, path
        outs[path] = got.float()
    assert (outs["wgmma"] - outs["tile"]).abs().max().item() <= tol


@pytest.mark.cuda
def test_bf16_flash_kernel_refuses_head_dim(cuda_device):
    q, ofs = _on(cuda_device, np.zeros((2, 1, 1, 12), np.float32),
                 np.zeros(2, np.int32))
    q = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention.flash_attention_offset(q, q, q, ofs)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention.flash_attention(q, q, q, True)


@pytest.mark.cuda
@pytest.mark.parametrize("compute,kv", [("bfloat16", "bfloat16"),
                                        ("float32", "bfloat16"),
                                        ("bfloat16", "float32"),
                                        ("int8", "bfloat16")])
def test_bf16_contiguous_engine_on_card(cuda_device, compute, kv):
    """The contiguous plane in every bf16 mix on the card: one prefill
    and three decode steps against the CPU's (logits within 2e-2 x
    max|ref|), and the kernels of the mix launched, their other forms
    not."""
    spec = tlm.lm_spec(num_layers=2, num_hidden=64, num_heads=4,
                       vocab_size=97)
    params = tlm.random_params(spec, seed=5)
    kw = dict(batch_buckets=(4,), prompt_buckets=(8,), kv_block=8,
              kv_max=48, paged=False, compute_dtype=compute, kv_dtype=kv,
              warmup=False)
    rs = np.random.RandomState(9)
    tokens = rs.randint(0, 97, (4, 8)).astype(np.int32)
    lengths = np.array([8, 5, 1, 8], np.int32)
    logits = {}
    for dev in ("cpu", "cuda"):
        store = ModelRegistry().add_generative_model(
            "m", params, spec, device=None if dev == "cuda" else "cpu", **kw)
        kernels.reset_launch_counts()
        first, ck, cv = store.run_prefill(tokens, lengths)
        assert ck.dtype == cv.dtype == getattr(torch, kv)
        # room for three more tokens past the prompt bucket
        ck, cv = (torch.nn.functional.pad(c, (0, 0, 0, 8)) for c in (ck, cv))
        out = [first.cpu()]
        lens = lengths.copy()
        for step in range(3):
            res, ck, cv = store.run_decode(ck, cv, tokens[:, step], lens)
            out.append(res.cpu())
            lens = lens + 1
        logits[dev] = out
        counts = kernels.launch_counts()
    for a, b in zip(logits["cuda"], logits["cpu"]):
        assert bool(torch.isfinite(a).all())
        assert _rel(a, b) <= 2e-2
    used = {"rms_norm_bf16", "layer_norm_bf16"} if compute == "bfloat16" \
        else {"rms_norm", "layer_norm"}
    if compute == "int8":
        used.add("dequant_matmul")
    used.add("flash_attention_bf16" if compute == "bfloat16"
             else "flash_attention")
    used.add("flash_attention_offset_bf16" if kv == "bfloat16"
             else "flash_attention_offset")
    assert all(counts[k] > 0 for k in used)
    assert all(counts[k] == 0 for k in set(counts) - used)


# ---------------------------------------------------------------------------
# bf16 training: the norm backwards, SoftmaxOutput's head and the step
# ---------------------------------------------------------------------------
# (rows, width, element offset): v3 at widths 8, 512 and 1024 and at 1,
# 33, 4096 and 4097 rows; v2 at widths 4 and 516 and 8 bytes off 16-byte
# alignment; v1 at widths 513 and 1028 and rows 2 bytes off
BF16_NORM_BWD_CASES = [(4096, 512, 0), (64, 4, 0), (64, 1024, 0),
                       (33, 513, 0), (64, 1028, 0), (300, 512, 4),
                       (300, 512, 1), (4097, 512, 0), (64, 8, 0),
                       (64, 516, 0), (1, 512, 0), (33, 512, 0)]


def _bf16_offset(t, offset):
    """A contiguous bf16 copy of ``t`` starting ``offset`` elements into
    a larger buffer."""
    buf = torch.empty(t.numel() + offset, dtype=torch.bfloat16,
                      device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width,offset", BF16_NORM_BWD_CASES)
def test_bf16_norm_bwd_kernels_match_plain(cuda_device, rows, width, offset):
    """bf16 dx and weight gradients within one bf16 ulp of the plain
    versions (both sum in fp32 and round once), on the path the planner
    gives the rows, counted under the bf16 names only."""
    rs = np.random.RandomState(rows + width + offset)
    xa, dya = _bf16_on(cuda_device, rs.randn(rows, width).astype(np.float32),
                       rs.randn(rows, width).astype(np.float32))
    (g,) = _bf16_on(cuda_device,
                    rs.uniform(0.5, 1.5, width).astype(np.float32))
    x, dy = _bf16_offset(xa, offset), _bf16_offset(dya, offset)
    x3 = _bf16_offset((xa.float() + 3.0).to(torch.bfloat16), offset)
    path = norm._bwd_plan(rows, width, norm._bwd_align(x, g, dy),
                          norm.sm_count(cuda_device.index),
                          torch.bfloat16).path
    fits = width <= 1024
    assert path == ("v3" if fits and width % 8 == 0 and offset % 8 == 0
                    else "v2" if fits and width % 4 == 0 and offset % 4 == 0
                    else "v1")
    before = kernels.launch_counts()
    for got, want in ((norm.rms_norm_bwd(x, g, dy),
                       norm.rms_norm_bwd_reference(x, g, dy)),
                      (norm.layer_norm_bwd(x3, g, dy),
                       norm.layer_norm_bwd_reference(x3, g, dy))):
        for a, b in zip(got, want):
            assert a.dtype == torch.bfloat16
            _within_bf16_ulp(a, b)
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"rms_norm_bwd_bf16": 1, "layer_norm_bwd_bf16": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("rows,classes", [(4096, 8192), (16, 2), (5, 8193),
                                          (7, 1000), (3, 4096), (3, 2048)])
def test_bf16_loss_head_kernels_match_plain(cuda_device, rows, classes):
    """The bf16 head: p within one bf16 ulp of the plain softmax (the
    row held in registers for widths a multiple of 8 up to 8192, the
    scalar loops else), and the gradient from that p within one ulp,
    float32 labels random, at the last column and outside the
    classes."""
    rs = np.random.RandomState(rows + classes)
    lbl = rs.randint(0, classes, rows).astype(np.float32)
    lbl[0], lbl[-1] = classes - 1, classes + 3
    (x,) = _bf16_on(cuda_device,
                    (3 * rs.randn(rows, classes)).astype(np.float32))
    (lbl,) = _on(cuda_device, lbl)
    before = kernels.launch_counts()
    p = softmax_xent.softmax_rows(x)
    assert p.dtype == torch.bfloat16
    _within_bf16_ulp(p, softmax_xent.softmax_rows_reference(x))
    for scale in (1.0, 1.0 / rows):
        got = softmax_xent.xent_grad_from_probs(p, lbl, scale)
        assert got.dtype == torch.bfloat16
        _within_bf16_ulp(got, softmax_xent.xent_grad_from_probs_reference(
            p, lbl, scale))
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"softmax_rows_bf16": 1, "xent_grad_from_probs_bf16": 2}


@pytest.mark.cuda
def test_training_kernels_refuse_fp16_naming_it(cuda_device):
    """fp16 is still to port: each training entry point refuses it,
    naming the dtype, and so does a bf16 label for the head."""
    x, g = _on(cuda_device, np.ones((4, 8), np.float32),
               np.ones(8, np.float32))
    lbl = torch.zeros(4, device=cuda_device)
    h, gh = x.half(), g.half()
    for call in (lambda: norm.rms_norm_bwd(h, gh, h),
                 lambda: norm.layer_norm_bwd(h, gh, h),
                 lambda: softmax_xent.softmax_rows(h),
                 lambda: softmax_xent.xent_grad_from_probs(h, lbl)):
        with pytest.raises(ValueError, match="float16"):
            call()
    with pytest.raises(ValueError, match="bfloat16"):
        softmax_xent.xent_grad_from_probs(x.to(torch.bfloat16),
                                          lbl.to(torch.bfloat16))
    with pytest.raises(ValueError, match="bfloat16"):
        softmax_xent.fused_softmax(x.to(torch.bfloat16))


@pytest.mark.cuda
def test_bf16_training_step_on_card_matches_cpu_and_launches(cuda_device):
    """One ``Module(compute_dtype='bfloat16')`` step of a small LM on the
    card and on the CPU: probabilities bf16 within 2e-2 x max|ref|,
    every gradient float32 within 5e-2 x its max|ref|, and exactly the
    bf16 kernels launched."""
    L, nl = 32, 2
    net = mx.models.transformer_lm(seq_len=L, num_layers=nl, num_hidden=64,
                                   num_heads=2, vocab_size=97)
    params = tlm.random_params(tlm.lm_spec(nl, 64, 2, 97), seed=1)
    for name in params:
        if name.endswith("_ffn1_bias"):
            params[name] = params[name] + np.float32(1.0)
    rs = np.random.RandomState(2)
    X = rs.randint(0, 97, (4, L)).astype(np.float32)
    y = ((X + 1) % 97).astype(np.float32)
    res = {}
    for dev in (cuda_device, torch.device("cpu")):
        it = mx.io.NDArrayIter(X, y, batch_size=4)
        mod = mx.Module(net, context=dev, compute_dtype="bfloat16")
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params=params)
        kernels.reset_launch_counts()
        mod.forward_backward(next(iter(it)))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        ex = mod._exec_group.executor
        assert ex.outputs[0]._data.dtype == torch.bfloat16
        assert all(g._data.dtype == torch.float32
                   for g in ex.grad_dict.values())
        res[dev.type] = [ex.outputs[0]._data.cpu()] + [
            ex.grad_dict[n]._data.cpu() for n in sorted(ex.grad_dict)]
        want = dict.fromkeys(counts, 0)
        if dev.type == "cuda":
            want.update(rms_norm_bf16=2 * nl, rms_norm_bwd_bf16=2 * nl,
                        layer_norm_bf16=1, layer_norm_bwd_bf16=1,
                        softmax_rows_bf16=1, xent_grad_from_probs_bf16=1,
                        flash_attention_bf16=nl)
        assert counts == want
    assert _rel(res["cuda"][0].float(), res["cpu"][0].float()) <= 2e-2
    for a, b in zip(res["cuda"][1:], res["cpu"][1:]):
        assert _rel(a, b) <= 5e-2


# ---------------------------------------------------------------------------
# the imperative plane in bf16: softmax_xent_loss on bf16 logits
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("rows,classes,offset", [
    (4096, 8192, 0), (64, 8193, 0), (4096, 2, 0), (5, 8, 0), (3, 2048, 0),
    (7, 1000, 0), (9, 8200, 0), (33, 512, 1), (33, 8192, 1)])
def test_bf16_softmax_xent_loss_kernels_match_plain(cuda_device, rows,
                                                    classes, offset):
    """``softmax_xent_loss`` on bf16 logits with float32 labels and g: the
    loss float32 within 1e-5 x max|ref|, the gradient bf16 within one
    bf16 ulp of max|ref| (the row in registers for widths a multiple of
    8 up to 8192 and 16-byte aligned rows; the scalar loops for 8193,
    8200, 1000 and rows 2 bytes off, ``offset`` 1); labels random, at 0,
    the last column, outside on both sides and a fraction."""
    rs = np.random.RandomState(rows * 3 + classes)
    (x,) = _bf16_on(cuda_device,
                    (3 * rs.randn(rows * classes + offset)).astype(np.float32))
    x = x[offset:].view(rows, classes)
    lbl, g = _on(cuda_device, _xent_labels(rs, rows, classes),
                 rs.uniform(0.5, 2.0, rows).astype(np.float32))
    before = kernels.launch_counts()
    loss = softmax_xent.xent_loss_rows(x, lbl)
    grad = softmax_xent.softmax_xent_loss_grad(x, lbl, g)
    torch.cuda.synchronize()
    assert loss.dtype == torch.float32 and grad.dtype == torch.bfloat16
    assert bool(torch.isfinite(loss).all())
    assert _rel(loss, softmax_xent.xent_loss_rows_reference(x, lbl)) <= 1e-5
    _within_bf16_ulp(grad, softmax_xent.softmax_xent_loss_grad_reference(
        x, lbl, g))
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"softmax_xent_loss_bf16": 1, "softmax_xent_loss_grad_bf16": 1}


@pytest.mark.cuda
def test_loss_kernels_refuse_fp16_and_a_bf16_label(cuda_device):
    """fp16 logits are refused naming the dtype; a bf16 label or g beside
    bf16 logits too; the op on fp16 logits raises rather than fall back."""
    x = torch.zeros(4, 8, device=cuda_device)
    lbl = torch.zeros(4, device=cuda_device)
    for call in (lambda: softmax_xent.xent_loss_rows(x.half(), lbl),
                 lambda: softmax_xent.softmax_xent_loss_grad(x.half(), lbl,
                                                             lbl),
                 lambda: mx.nd.softmax_cross_entropy(
                     mx.nd.NDArray(x.half()), mx.nd.NDArray(lbl))):
        with pytest.raises(ValueError, match="float16"):
            call()
    b = x.to(torch.bfloat16)
    for call in (lambda: softmax_xent.xent_loss_rows(b, lbl.bfloat16()),
                 lambda: softmax_xent.softmax_xent_loss_grad(
                     b, lbl, lbl.bfloat16())):
        with pytest.raises(ValueError, match="float32.*bfloat16"):
            call()


@pytest.mark.cuda
def test_imperative_bf16_lm_step_on_card_matches_cpu_and_launches(
        cuda_device):
    """One imperative bf16 step (``imperative_loss(...,
    compute_dtype='bfloat16')``) of a small LM on the card and on the
    CPU: the loss bf16 within 2e-2 x |ref|, every gradient float32
    within 5e-2 x its max|ref|, and exactly the bf16 kernels
    launched."""
    spec = tlm.lm_spec(2, 64, 2, 97)
    params = tlm.random_params(spec, seed=6)
    for name in params:
        if name.endswith("_ffn1_bias"):
            params[name] = params[name] + np.float32(1.0)
    rs = np.random.RandomState(7)
    X = rs.randint(0, 97, (4, 32)).astype(np.float32)
    y = ((X + 1) % 97).astype(np.float32)
    res = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        with ctx:
            w = {k: mx.nd.array(v) for k, v in params.items()}
            for v in w.values():
                v.attach_grad()
            kernels.reset_launch_counts()
            with mx.autograd.record():
                loss = tlm.imperative_loss(mx.nd, w, mx.nd.array(X),
                                           mx.nd.array(y), 32, spec,
                                           compute_dtype="bfloat16")
            loss.backward()
            mx.nd.waitall()
            counts = kernels.launch_counts()
        assert loss._data.dtype == torch.bfloat16
        assert all(v.grad._data.dtype == torch.float32 for v in w.values())
        res[ctx.device_type] = [loss._data.cpu().float()] + [
            w[k].grad._data.cpu() for k in sorted(w)]
        want = dict.fromkeys(counts, 0)
        if ctx.device_type == "gpu":
            want.update(rms_norm_bf16=4, rms_norm_bwd_bf16=4,
                        layer_norm_bf16=1, layer_norm_bwd_bf16=1,
                        softmax_xent_loss_bf16=1,
                        softmax_xent_loss_grad_bf16=1,
                        flash_attention_bf16=2)
        assert counts == want
    assert _rel(res["gpu"][0], res["cpu"][0]) <= 2e-2
    for a, b in zip(res["gpu"][1:], res["cpu"][1:]):
        assert _rel(a, b) <= 5e-2


# ---------------------------------------------------------------------------
# speculative decoding, and the saturating float-to-integer casts
# ---------------------------------------------------------------------------
SPEC_REQS = [dict(tokens=[7, 3, 11, 29, 4], max_tokens=12, seed=1),
             dict(tokens=[7, 3, 11, 29, 4], max_tokens=9, seed=2),
             dict(tokens=[2, 5], max_tokens=14, seed=3),
             dict(tokens=[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], max_tokens=7,
                  seed=4)]


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_spec_engine_on_card_keeps_the_greedy_streams(cuda_device,
                                                      monkeypatch, kv):
    """``tests/test_torch_spec_decode.py``'s sizes on the card (int8: hidden
    64, a head dim of 16): greedy streams with a self-draft and with a
    random draft equal the non-speculative engine's on the card and the
    CPU's, and every paged launch runs on the body ``_plan`` names, the
    verify at Lq 5."""
    hidden = 64 if kv == "int8" else 32
    spec = tlm.lm_spec(num_layers=2, num_hidden=hidden, num_heads=4,
                       vocab_size=50)
    params = tlm.random_params(spec, seed=3)
    dspec = tlm.lm_spec(num_layers=1, num_hidden=hidden // 2, num_heads=2,
                        vocab_size=50)
    dparams = tlm.random_params(dspec, seed=7)
    kw = dict(batch_buckets=(1, 2, 4), prompt_buckets=(4, 8, 24),
              kv_block=8, kv_max=64, paged=True, prefill_chunk=8,
              kv_dtype=kv)
    shapes = []
    launch = paged_attention.launch
    dtypes = {v[0]: k for k, v in paged_attention._VARIANTS.items()}

    def census(x, name, entry, *args):
        B, H, Lq, D = args[-10:-6]
        plan = paged_attention._plan(B, H, Lq, D, dtypes[name],
                                     _build.sm_count(x.device.index))
        shapes.append((Lq, tuple(args[-2:]) == (
            paged_attention._PATH[plan.path], plan.block_q)))
        return launch(x, name, entry, *args)
    monkeypatch.setattr(paged_attention, "launch", census)
    streams = {}
    for tag, dev, draft in (("cpu", "cpu", None), ("base", None, None),
                            ("self", None, (params, spec)),
                            ("rand", None, (dparams, dspec))):
        reg = ModelRegistry()
        reg.add_generative_model("m", params, spec, device=dev, **kw)
        if draft is not None:
            reg.add_draft_model("m", *draft, spec_k=4)
        with GenerationEngine(reg) as eng:
            streams[tag] = [f.result(120).tokens for f in
                            [eng.submit("m", **r) for r in SPEC_REQS]]
            st = eng.stats()
        assert (st["spec_steps"] > 0) == (draft is not None)
    assert streams["self"] == streams["rand"] == streams["base"] == \
        streams["cpu"]
    assert all(ok for _lq, ok in shapes)
    assert {lq for lq, _ok in shapes} >= {1, 5, 8}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint8", "int8", "int32"])
@pytest.mark.parametrize("src_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("how", ["Cast", "cast", "astype"])
def test_float_to_int_cast_saturates_on_card(cuda_device, how, src_dtype,
                                             dtype):
    """CUDA's conversion under the saturating cast: the card's result
    equals the CPU's (held to the reference's in
    ``tests/test_torch_cast_saturate.py``), NaN, infinities and
    out-of-range values included."""
    src = np.float32([-2.7, 300.7, np.nan, np.inf, -np.inf, 3e9, 0.49,
                      -0.51, 126.9, -127.9, 254.6, -3e9])
    out = []
    for ctx in (mx.gpu(0), mx.cpu()):
        x = mx.nd.array(src, ctx=ctx)
        if src_dtype != "float32":
            x = x.astype(src_dtype)
        y = x.astype(dtype) if how == "astype" else \
            getattr(mx.nd, how)(x, dtype=dtype)
        out.append((y._data.device.type, y.asnumpy()))
    assert [d for d, _ in out] == ["cuda", "cpu"]
    assert out[0][1].dtype == np.dtype(dtype)
    np.testing.assert_array_equal(out[0][1], out[1][1])


# ---------------------------------------------------------------------------
# the op library on the card: indices out of range and the tie orders
# ---------------------------------------------------------------------------
def _card_and_cpu(op, arrays, **attrs):
    """``mx.nd.<op>`` on the card and on the CPU, synchronised after the
    card's call so a device-side assert fails here; numpy outputs."""
    outs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        with ctx:
            res = getattr(mx.nd, op)(*[mx.nd.array(a, dtype=a.dtype)
                                       for a in arrays], **attrs)
            if ctx == mx.gpu(0):
                torch.cuda.synchronize()
        outs.append([r.asnumpy() for r in
                     (res if isinstance(res, list) else [res])])
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("op,attrs", [
    ("take", {}), ("take", {"mode": "wrap"}), ("take", {"mode": "raise"}),
    ("take", {"axis": 1}), ("pick", {"axis": 1}), ("pick", {"mode": "wrap"}),
    ("batch_take", {}), ("one_hot", {"depth": 6})])
def test_indices_out_of_range_on_card(cuda_device, op, attrs):
    """Indices past either end and negative give the CPU's values, with
    no device-side assert, and the context lives on."""
    rs = np.random.RandomState(0)
    data = rs.randn(5, 6).astype(np.float32)
    idx = np.array([0, 9, -1, -7, 5.5], np.float32)
    arrays = {"one_hot": [idx]}.get(op, [data, idx])
    card, cpu = _card_and_cpu(op, arrays, **attrs)
    for c, h in zip(card, cpu):
        np.testing.assert_array_equal(c, h)
    with mx.gpu(0):
        assert (mx.nd.array(data) * 2).asnumpy().tolist() == \
            (data * 2).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("op,attrs", [
    ("sort", {}), ("sort", {"is_ascend": False}), ("argsort", {}),
    ("argsort", {"is_ascend": False}), ("topk", {"k": 5}),
    ("topk", {"k": 5, "is_ascend": True}),
    ("topk", {"k": 7, "ret_typ": "both"}), ("topk", {"k": 3,
                                                     "ret_typ": "mask"})])
def test_tie_order_on_card(cuda_device, op, attrs):
    """Rows full of ties, 8192 columns: the card's order is the CPU's
    bit for bit (descending argsort: ties higher index first; topk:
    lower index first)."""
    rs = np.random.RandomState(1)
    x = (rs.randint(-2, 3, (4, 8192)) / 2.0).astype(np.float32)
    card, cpu = _card_and_cpu(op, [x], **attrs)
    for c, h in zip(card, cpu):
        np.testing.assert_array_equal(c, h)
    row = np.array([[1, 0, 1, 0, 1]], np.float32)
    (a,), _ = _card_and_cpu("argsort", [row], is_ascend=False)
    (t,), _ = _card_and_cpu("topk", [row], k=2)
    assert a.tolist() == [[4, 2, 0, 3, 1]] and t.tolist() == [[0, 2]]


# ---------------------------------------------------------------------------
# the image-classification slice: layers, BatchNorm's moving statistics,
# TF32 off, a ResNet step
# ---------------------------------------------------------------------------
def _rel_np(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("op,shapes,attrs", [
    ("Convolution", [(4, 16, 28, 28), (32, 16, 3, 3), (32,)],
     {"kernel": (3, 3), "num_filter": 32, "stride": (2, 2), "pad": (1, 1)}),
    ("Convolution", [(4, 16, 28, 28), (32, 4, 3, 3)],
     {"kernel": (3, 3), "num_filter": 32, "num_group": 4, "dilate": (2, 2),
      "pad": (2, 2), "no_bias": True}),
    ("Convolution", [(4, 8, 100), (16, 8, 5)],
     {"kernel": (5,), "num_filter": 16, "stride": (2,), "no_bias": True}),
    ("Convolution", [(2, 4, 8, 16, 16), (8, 4, 3, 3, 3)],
     {"kernel": (3, 3, 3), "num_filter": 8, "pad": (1, 1, 1),
      "no_bias": True}),
    ("Deconvolution", [(4, 16, 14, 14), (16, 8, 3, 3), (8,)],
     {"kernel": (3, 3), "num_filter": 8, "stride": (2, 2), "pad": (1, 1),
      "adj": (1, 1)}),
    ("Deconvolution", [(4, 16, 14, 14), (16, 8, 4, 4)],
     {"kernel": (4, 4), "num_filter": 8, "stride": (2, 2), "pad": (1, 1),
      "target_shape": (32, 32), "no_bias": True}),
    ("Pooling", [(4, 16, 28, 28)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)}),
    ("Pooling", [(4, 16, 27, 27)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "avg",
      "pooling_convention": "full"}),
    ("Pooling", [(4, 16, 28, 28)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (2, 2), "pool_type": "sum"}),
    ("Pooling", [(4, 64, 7, 7)],
     {"kernel": (7, 7), "global_pool": True, "pool_type": "avg"}),
    ("Pooling", [(4, 8, 101)],
     {"kernel": (3,), "stride": (2,), "pooling_convention": "full"}),
])
def test_layers_on_card_match_cpu(cuda_device, op, shapes, attrs):
    """The convolution, deconvolution and pooling modes on the card
    (cuDNN, TF32 off) against the CPU: within 1e-5 x max|ref|."""
    rs = np.random.RandomState(len(shapes) * 7 + len(attrs))
    arrays = [rs.randn(*s).astype(np.float32) for s in shapes]
    card, cpu = _card_and_cpu(op, arrays, **attrs)
    assert torch.backends.cudnn.allow_tf32 is False
    for c, h in zip(card, cpu):
        assert c.shape == h.shape
        assert _rel_np(c, h) <= 1e-5


@pytest.mark.cuda
def test_default_device_turns_cudnn_tf32_off(cuda_device):
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    assert mx.context.default_device("cuda") == cuda_device
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.cuda
@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_moving_stats_update_on_card(cuda_device, train):
    """BatchNorm under ``autograd.record()`` (or at inference) on the
    card: its output, its gradients and its moving statistics, updated
    in place on the card, within 1e-5 x max|ref| of the CPU's."""
    rs = np.random.RandomState(3)
    vals = [rs.randn(8, 16, 14, 14).astype(np.float32) * 2 + 0.5,
            rs.uniform(0.5, 1.5, 16).astype(np.float32),
            rs.randn(16).astype(np.float32),
            rs.uniform(-0.2, 0.2, 16).astype(np.float32),
            rs.uniform(0.5, 1.5, 16).astype(np.float32)]
    head = rs.randn(8, 16, 14, 14).astype(np.float32)
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        with ctx:
            data, gamma, beta, mm, mv = [mx.nd.array(v) for v in vals]
            for x in (data, gamma, beta):
                x.attach_grad()
            with mx.autograd.record(train_mode_=train):
                out = mx.nd.BatchNorm(data, gamma, beta, mm, mv,
                                      fix_gamma=False, momentum=0.9)
            out.backward(mx.nd.array(head))
            assert mm._data.device.type == ctx.device_type.replace(
                "gpu", "cuda")
            res.append([a.asnumpy() for a in (out, data.grad, gamma.grad,
                                              beta.grad, mm, mv)])
    for c, h in zip(*res):
        assert _rel_np(c, h) <= 1e-5
    assert train == (not np.array_equal(res[0][4], vals[3]))


@pytest.mark.cuda
def test_tiny_resnet_step_on_card_matches_cpu(cuda_device):
    """One SGD step of the cifar ResNet (8 layers, batch 4) on the card
    against the CPU from the same parameters: probabilities, updated
    parameters and moving statistics within 1e-4 x max|ref|; the
    head's kernel pair launched once."""
    net = mx.models.resnet(num_classes=10, num_layers=8,
                           image_shape="3,28,28")
    rs = np.random.RandomState(4)
    X = rs.uniform(-1, 1, (4, 3, 28, 28)).astype(np.float32)
    y = rs.randint(0, 10, 4).astype(np.float32)
    mx.random.seed(4)
    res = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        mod = mx.Module(net, context=ctx)
        it = mx.io.NDArrayIter(X, y, batch_size=4)
        mod.bind(it.provide_data, it.provide_label)
        if not res:
            mod.init_params(mx.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
            start = mod.get_params()
        else:
            mod.init_params(arg_params=start[0], aux_params=start[1])
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
        before = kernels.launch_counts()
        mod.forward_backward(next(iter(it)))
        mod.update()
        after = kernels.launch_counts()
        arg, aux = mod.get_params()
        res.append((mod.get_outputs()[0].asnumpy(),
                    {k: v.asnumpy() for k, v in arg.items()},
                    {k: v.asnumpy() for k, v in aux.items()}))
    assert after["softmax_rows"] - before["softmax_rows"] == 1
    assert after["xent_grad_from_probs"] - before["xent_grad_from_probs"] == 1
    (hp, harg, haux), (cp, carg, caux) = res
    assert _rel_np(cp, hp) <= 1e-4
    for got, want in ((carg, harg), (caux, haux)):
        for k, w in want.items():
            assert _rel_np(got[k], w) <= 1e-4, k


@pytest.mark.cuda
@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_bf16_on_card_matches_cpu(cuda_device, train):
    """BatchNorm on bf16 data with bf16 gamma, beta and moving statistics
    (as a ``compute_dtype='bfloat16'`` executor feeds it), in training
    and at inference: the output, the gradients and the moving
    statistics bf16 on both devices, the card within two bf16 ulps of
    max|ref| of the CPU."""
    rs = np.random.RandomState(5)
    vals = [rs.randn(8, 16, 14, 14).astype(np.float32) * 2 + 0.5,
            rs.uniform(0.5, 1.5, 16).astype(np.float32),
            rs.randn(16).astype(np.float32),
            rs.uniform(-0.2, 0.2, 16).astype(np.float32),
            rs.uniform(0.5, 1.5, 16).astype(np.float32)]
    head = rs.randn(8, 16, 14, 14).astype(np.float32)
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        with ctx:
            data, gamma, beta, mm, mv = [mx.nd.array(v, dtype="bfloat16")
                                         for v in vals]
            for x in (data, gamma, beta):
                x.attach_grad()
            with mx.autograd.record(train_mode_=train):
                out = mx.nd.BatchNorm(data, gamma, beta, mm, mv,
                                      fix_gamma=False, momentum=0.9)
            out.backward(mx.nd.array(head, dtype="bfloat16"))
            arrays = (out, data.grad, gamma.grad, beta.grad, mm, mv)
            assert {a._data.dtype for a in arrays} == {torch.bfloat16}
            res.append([a.asnumpy() for a in arrays])
    for c, h in zip(*res):
        assert np.abs(c - h).max() <= 2 * bf16_ulp(np.abs(h).max())
    assert train == (not np.array_equal(
        res[0][4], torch.tensor(vals[3]).bfloat16().float().numpy()))


@pytest.mark.cuda
def test_bf16_head_pair_at_the_resnet_head_matches_plain(cuda_device):
    """Row 10b at ResNet-50's head, 32 x 1000 bf16 (float32 labels): the
    probabilities and the gradient within one bf16 ulp of max|ref| of
    the plain versions, one launch each under the bf16 names; 1000
    classes on 16-byte aligned rows are the registers body's (8-element
    loads, one a lane)."""
    rs = np.random.RandomState(6)
    (x,) = _on(cuda_device, rs.randn(32, 1000).astype(np.float32))
    (label,) = _on(cuda_device, rs.randint(0, 1000, 32).astype(np.float32))
    x = x.to(torch.bfloat16)
    assert x.data_ptr() % 16 == 0 and 1000 % 8 == 0
    before = kernels.launch_counts()
    p = softmax_xent.softmax_rows(x)
    grad = softmax_xent.xent_grad_from_probs(p, label, 1.0 / 32)
    after = kernels.launch_counts()
    assert after["softmax_rows_bf16"] - before["softmax_rows_bf16"] == 1
    assert after["xent_grad_from_probs_bf16"] - \
        before["xent_grad_from_probs_bf16"] == 1
    assert p.dtype == grad.dtype == torch.bfloat16
    for got, want in ((p, softmax_xent.softmax_rows_reference(x)),
                      (grad, softmax_xent.xent_grad_from_probs_reference(
                          p, label, 1.0 / 32))):
        ref = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= \
            bf16_ulp(ref)


@pytest.mark.cuda
def test_bf16_tiny_resnet_predict_on_card_matches_cpu(cuda_device):
    """``predict`` of a ``compute_dtype='bfloat16'`` cifar ResNet (8
    layers) over 10 rows in batches of 4 on the card against the CPU's
    from the same parameters and moving statistics: bf16 outputs of 10
    rows, within 2e-2 x max|ref|; the head's bf16 forward launched once
    a batch."""
    net = mx.models.resnet(num_classes=10, num_layers=8,
                           image_shape="3,28,28")
    rs = np.random.RandomState(7)
    X = rs.uniform(-1, 1, (10, 3, 28, 28)).astype(np.float32)
    mx.random.seed(7)
    res = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        mod = mx.Module(net, context=ctx, label_names=None,
                        compute_dtype="bfloat16")
        mod.bind([("data", (4, 3, 28, 28))], for_training=False)
        if not res:
            mod.init_params(mx.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
            start = mod.get_params()
        else:
            mod.init_params(arg_params=start[0], aux_params=start[1])
        before = kernels.launch_counts()
        out = mod.predict(mx.io.NDArrayIter(X, batch_size=4))
        after = kernels.launch_counts()
        assert out._data.dtype == torch.bfloat16 and out.shape == (10, 10)
        res.append(out.asnumpy())
    assert after["softmax_rows_bf16"] - before["softmax_rows_bf16"] == 3
    assert _rel_np(res[1], res[0]) <= 2e-2


RNN_CASES = [(mode, bidir) for mode in ("lstm", "gru", "rnn_tanh",
                                        "rnn_relu")
             for bidir in (False, True)]


def _rnn_case(dev, mode, bidir, seed):
    from mxnet_tpu_torch.ops import rnn_op
    dev = mx.context.default_device(dev)    # cuDNN's TF32 off, as a module
    L, T, N, I, H = 2, 7, 3, 12, 16
    d = 2 if bidir else 1
    g = torch.Generator().manual_seed(seed)
    n = rnn_op.rnn_param_size(L, I, H, mode, bidir)
    ins = [torch.randn(T, N, I, generator=g),
           torch.empty(n).uniform_(-0.3, 0.3, generator=g),
           torch.randn(L * d, N, H, generator=g)]
    if mode == "lstm":
        ins.append(torch.randn(L * d, N, H, generator=g))
    attrs = dict(state_size=H, num_layers=L, mode=mode, bidirectional=bidir,
                 p=0.0, state_outputs=True, pkeep_=1.0, lstm_q_=False)
    return attrs, [t.to(dev).requires_grad_(True) for t in ins]


def _rnn_run(fn, attrs, ins, seed, **kw):
    outs = fn(attrs, *ins, **kw)
    g = torch.Generator().manual_seed(seed + 1)
    cots = [torch.randn(o.shape, generator=g).to(o.device) for o in outs]
    return [o.detach() for o in outs] + list(
        torch.autograd.grad(outs, ins, cots))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,bidir", RNN_CASES)
def test_rnn_op_cudnn_matches_plain_on_card(cuda_device, mode, bidir):
    """The ``RNN`` op's card route (cuDNN through ``torch._VF``) against
    its plain version (the per-step loop) on the card: outputs, last
    states and every input's gradient within 1e-4 x max|ref|, the bound
    of ``chip_smoke.py`` phase 19.  cuDNN's sigmoid and tanh are
    approximations: its fp32 route lies about 1e-5 of max|ref| from the
    loop in float64 (phase 19 prints the distance), the fp32 loop a few
    1e-7."""
    from mxnet_tpu_torch.ops import rnn_op
    attrs, ins = _rnn_case(cuda_device, mode, bidir, 20)
    got = _rnn_run(rnn_op.rnn_apply, attrs, ins, 20, is_train=True)
    want = _rnn_run(rnn_op.rnn_plain, attrs, ins, 20, is_train=True)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.is_cuda
        err = float((a - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), (mode, bidir, i, err)


@pytest.mark.cuda
def test_rnn_op_dropout_between_layers_on_card(cuda_device):
    """Training-time dropout between layers draws the same masks from
    the card's generator on both routes, so cuDNN's output equals the
    loop's with the same generator state (within the bound of the test
    above)."""
    from mxnet_tpu_torch.ops import rnn_op
    attrs, ins = _rnn_case(cuda_device, "lstm", True, 21)
    attrs = dict(attrs, p=0.4)
    res = []
    with torch.no_grad():
        for fn in (rnn_op.rnn_apply, rnn_op.rnn_plain):
            mx.random.seed(21)
            res.append(fn(attrs, *ins, is_train=True,
                          generator=mx.random.generator(cuda_device))[0])
        infer = rnn_op.rnn_apply(attrs, *ins)[0]
    err = float((res[0] - res[1]).abs().max())
    assert err <= 1e-4 * float(res[1].abs().max())
    assert not torch.allclose(infer, res[0])


@pytest.mark.cuda
def test_bucketing_lstm_step_on_card_matches_cpu(cuda_device):
    """One ``forward_backward`` + ``update`` of each of two buckets of a
    tiny LSTM LM through ``BucketingModule`` on the card against the CPU
    from the same parameters: outputs, gradients and parameters within
    1e-5 x max|ref|, and every bucket on the default bucket's tensors."""
    from mxnet_tpu_torch.models.lstm_lm import sym_gen_factory
    rs = np.random.RandomState(22)
    sent = [list(rs.randint(1, 50, rs.randint(2, 9))) for _ in range(24)]
    sym_gen = sym_gen_factory(num_layers=2, num_hidden=16, num_embed=16,
                              vocab_size=50)
    state, start, res = None, None, {}
    for ctx in (mx.gpu(0), mx.cpu()):
        it = mx.rnn.BucketSentenceIter(sent, 4, buckets=[4, 8],
                                       invalid_label=0)
        if state is not None:
            it.load_state(state)
        state = it.state_dict()
        first = {}
        for b in it:
            first.setdefault(b.bucket_key, b)
        mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                     context=ctx)
        mod.bind(it.provide_data, it.provide_label)
        if start is None:
            mod.init_params(mx.init.Xavier())
            start = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        else:
            mod.init_params(arg_params=start)
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        out = {}
        for key in (4, 8):
            mod.forward_backward(first[key])
            out["out%d" % key] = mod.get_outputs()[0].asnumpy()
            ex = mod._curr_module._exec_group.executor
            out.update(("d%s%d" % (n, key), g.asnumpy())
                       for n, g in ex.grad_dict.items())
            mod.update()
            out.update(("%s%d" % (n, key), v.asnumpy())
                       for n, v in mod.get_params()[0].items())
        ex4 = mod._buckets[4]._exec_group.executor
        ex8 = mod._buckets[8]._exec_group.executor
        for name in mod._buckets[8]._param_names:
            assert ex4.arg_dict[name]._data.data_ptr() == \
                ex8.arg_dict[name]._data.data_ptr()
        res[ctx.device_type] = out
    for name, want in res["cpu"].items():
        err = float(np.abs(res["gpu"][name] - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), (name, err)
