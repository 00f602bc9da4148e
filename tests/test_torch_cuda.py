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
from mxnet_tpu_torch.kernels import (flash_attention, norm, paged_attention,
                                     softmax_xent)
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.serving import GenerationEngine, ModelRegistry

NORM_SHAPES = [(16, 64), (6, 40), (32, 512), (1, 7), (33, 1000)]
SERVE_KERNELS = ("rms_norm", "layer_norm", "flash_attention_paged")
# (rows, width): the training path's 4096 x 512 and odd sizes
NORM_BWD_SHAPES = [(4096, 512), (33, 1000), (1, 7), (17, 40)]
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
def test_norm_bwd_is_deterministic(cuda_device):
    """The weight gradients sum fixed partials, with no atomics: two
    runs give the same bits."""
    rs = np.random.RandomState(0)
    x, g, dy = _on(cuda_device, rs.randn(4096, 512).astype(np.float32),
                   rs.rand(512).astype(np.float32),
                   rs.randn(4096, 512).astype(np.float32))
    a = norm.layer_norm_bwd(x, g, dy)
    b = norm.layer_norm_bwd(x, g, dy)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


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
                                         (1, 2, 16, 48, 32)])
def test_flash_attention_kernel_matches_plain(cuda_device, causal, B, H, Lq,
                                              Lk, D):
    rs = np.random.RandomState(Lq + D)
    q = rs.randn(B, H, Lq, D).astype(np.float32)
    k, v = (rs.randn(B, H, Lk, D).astype(np.float32) for _ in range(2))
    q, k, v = _on(cuda_device, q, k, v)
    got = flash_attention.flash_attention(q, k, v, causal)
    want = flash_attention.blockwise_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


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
