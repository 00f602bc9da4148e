"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  The module imports neither JAX nor the JAX package,
so on a GPU machine without JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import norm, paged_attention
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.serving import GenerationEngine, ModelRegistry

NORM_SHAPES = [(16, 64), (6, 40), (32, 512), (1, 7), (33, 1000)]
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
        assert all((n > 0) == (dev == "cuda") for n in counts.values())
    assert streams["cuda"] == streams["cpu"]
