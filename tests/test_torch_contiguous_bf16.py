"""bf16 serving on the contiguous plane (``paged=False``): the port against
the JAX package, on the CPU.

* The plain bf16 offset and causal attention (``offset_attention_reference``
  and ``blockwise_attention``, the CPU route and the card's yardstick)
  against the Pallas ``flash_attention_offset`` / ``flash_attention`` in
  interpret mode on the same bf16 arrays, within one bf16 ulp of
  max|ref| (both widen to fp32, sum in another order and round once).
* ``flash_attention``'s launch planner ``_plan`` (decode body, tile,
  wgmma for bf16 ``flash_attention``, v1) and the CUDA route's argument
  checks, and the card route's one launch with the plan's body.  Pure
  Python: no card.
* The bf16 tile's arithmetic emulated in torch as
  ``csrc/flash_attention.cu`` takes it (Q K^T exact in 16-wide k-steps,
  P split in two bf16 terms for P.V, 64-key tiles, one warp's online
  softmax a 16-row block), against the fp32 plain version and Pallas
  interpret within one bf16 ulp of max|ref| plus 1e-4, the card check's
  bound; P rounded once is recorded beside it.
* ``prefill_apply`` then three ``decode_apply`` steps for every dtype mix
  the reference serves on this plane, against ``mxnet_tpu``: the caches'
  dtype and values within one bf16 ulp of max|ref|, the logits within
  2e-2 x max|ref| (the bound of ``tests/test_torch_bf16.py``), and the
  q cast to the cache dtype before the decode attention.
* The bf16 store through the engine against the reference's: greedy
  streams equal but at a near tie inside the logits' bound, dtypes,
  weight bytes and bytes per slot (exactly half of the fp32 store's).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.pallas_ops.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_offset as jax_flash_attention_offset)
from mxnet_tpu.serving import GenerationEngine as JaxEngine
from mxnet_tpu.serving import ModelRegistry as JaxRegistry
from mxnet_tpu_torch.kernels._build import KernelError
from mxnet_tpu_torch.kernels import flash_attention as fa
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.serving import GenerationEngine, ModelRegistry
from test_torch_cuda import bf16_ulp
from test_torch_paged_plan import exact, mma_sum, p_once_bf16, p_split_bf16

jlm = importlib.import_module("mxnet_tpu.models.transformer_lm")

F32, BF16 = torch.float32, torch.bfloat16
H100_SMS = 132
NEG = -1e30
TOL = 1e-4
SPEC = tlm.lm_spec(num_layers=2, num_hidden=64, num_heads=4, vocab_size=256)
PARAMS = tlm.random_params(SPEC, seed=7)
KW = dict(batch_buckets=(1, 2, 4), prompt_buckets=(8, 16), kv_block=8,
          kv_max=40, paged=False)
LOGIT_TOL = 2e-2   # of max|ref|
# (compute dtype, kv dtype) mixes with bf16 that the reference serves on
# the contiguous plane (int8 KV needs the paged plane)
MIXES = [("bfloat16", "float32"), ("float32", "bfloat16"),
         ("bfloat16", "bfloat16"), ("int8", "bfloat16")]
TORCH_DTYPES = {"float32": F32, "bfloat16": BF16}


def _bf16(*arrays):
    """fp32 numpy arrays rounded to bf16 on both sides (the same RNE)."""
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)).to(BF16)
             for a in arrays])


def _f32(x):
    """A bf16 or fp32 array or tensor of either package as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within_ulp(got, want, extra=0.0):
    tol = bf16_ulp(np.abs(want).max()) + extra
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol)


# ---------------------------------------------------------------------------
# the plain versions in bf16 against Pallas interpret
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lq", [1, 4])
@pytest.mark.parametrize("lk", [64, 96])
def test_offset_plain_bf16_matches_pallas_interpret(lq, lk):
    """Offsets at 0, mid-cache and Lk - Lq."""
    rs = np.random.RandomState(lq * lk)
    q = rs.randn(3, 2, lq, 16).astype(np.float32)
    k, v = (rs.randn(3, 2, lk, 16).astype(np.float32) for _ in range(2))
    ofs = np.asarray([0, lk // 2, lk - lq], np.int32)
    (jq, jk, jv), (tq, tk, tv) = _bf16(q, k, v)
    got = fa.offset_attention_reference(tq, tk, tv, torch.from_numpy(ofs))
    want = jax_flash_attention_offset(jq, jk, jv, ofs, block_q=lq,
                                      block_k=32, interpret=True)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_ulp(_f32(got), _f32(want))
    # the wrapper's CPU route is the plain version
    assert torch.equal(fa.flash_attention_offset(tq, tk, tv,
                                                 torch.from_numpy(ofs)), got)


@pytest.mark.parametrize("L,D", [(40, 16), (96, 64)])
def test_causal_plain_bf16_matches_pallas_interpret(L, D):
    rs = np.random.RandomState(L + D)
    arrays = [rs.randn(2, 2, L, D).astype(np.float32) for _ in range(3)]
    (jq, jk, jv), (tq, tk, tv) = _bf16(*arrays)
    got = fa.blockwise_attention(tq, tk, tv, causal=True)
    want = jax_flash_attention(jq, jk, jv, causal=True, block_q=8,
                               block_k=8, interpret=True)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_ulp(_f32(got), _f32(want))
    assert torch.equal(fa.flash_attention(tq, tk, tv, causal=True), got)


# ---------------------------------------------------------------------------
# the planner and the card route's checks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Lq,D,dtype,want", [
    (1, 64, F32, ("decode", 1)), (6, 64, F32, ("decode", 1)),
    (7, 64, F32, ("tile", 64)), (6, 64, BF16, ("decode", 1)),
    (7, 64, BF16, ("wgmma", 64)),
    (512, 64, BF16, ("wgmma", 64)), (65, 128, F32, ("tile", 64)),
    (1, 128, BF16, ("decode", 1)), (1, 136, F32, ("v1", 32)),
    (64, 256, BF16, ("v1", 32))])
def test_plan_body_and_grid(Lq, D, dtype, want):
    """bf16 flash_attention takes the wgmma body above the decode
    threshold (tests/test_torch_fa_wgmma_plan.py has its rows rule)."""
    B, H = 3, 2
    plan = fa._plan(B, H, Lq, 96, D, dtype, H100_SMS)
    assert (plan.path, plan.block_q) == want
    tiles = -(-Lq // plan.block_q)
    assert plan.grid == ((B * H, tiles) if plan.path in ("tile", "wgmma")
                         else (tiles, B * H))


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plan_threshold_splits_lq(dtype):
    m = fa.DECODE_MAX_LQ[dtype]
    above = "wgmma" if dtype == BF16 else "tile"
    assert fa._plan(2, 8, m, 1024, 64, dtype, H100_SMS).path == "decode"
    assert fa._plan(2, 8, m + 1, 1024, 64, dtype, H100_SMS).path == above
    assert fa._plan(2, 8, m + 1, 1024, 64, dtype, H100_SMS,
                    offset=True).path == "tile"


def _qkv(D, dtype, B=2, Lq=1, Lk=8):
    return [torch.zeros(B, 2, L, D, dtype=dtype) for L in (Lq, Lk, Lk)]


def test_card_route_checks_name_the_rule():
    fa._check(*_qkv(64, BF16), torch.zeros(2, dtype=torch.int32))
    fa._check(*_qkv(12, F32))
    with pytest.raises(KernelError, match="bfloat16 head dim that is a "
                                          "multiple of 8"):
        fa._check(*_qkv(12, BF16))
    for dtype in (F32, BF16):
        with pytest.raises(KernelError, match="up to 256, got 264"):
            fa._check(*_qkv(264, dtype))
    with pytest.raises(KernelError, match="float32 or bfloat16"):
        fa._check(*_qkv(64, torch.float16))
    q, k, v = _qkv(64, BF16)
    with pytest.raises(KernelError, match="one dtype"):
        fa._check(q, k.float(), v)
    for bad in (torch.zeros(2, dtype=torch.int64),
                torch.zeros(3, dtype=torch.int32),
                torch.zeros(2, 1, dtype=torch.int32)):
        with pytest.raises(KernelError, match=r"offsets must be a "
                                              r"contiguous \(B,\)"):
            fa._check(q, k, v, bad)


@pytest.fixture
def card_route(monkeypatch):
    """The wrapper's card route on CPU tensors, with the launches
    recorded instead of made."""
    launches = []
    monkeypatch.setattr(fa, "route", lambda name, x: True)
    monkeypatch.setattr(fa, "sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(fa, "launch", lambda *a: launches.append(a))
    return launches


@pytest.mark.parametrize("dtype,lq,D", [(F32, 1, 64), (F32, 32, 64),
                                        (BF16, 1, 64), (BF16, 512, 64),
                                        (BF16, 3, 136)])
def test_card_route_makes_one_launch_with_the_plan(card_route, dtype, lq, D):
    B, H, Lk = 3, 2, 40
    q, k, v = (torch.zeros(B, H, L, D, dtype=dtype) for L in (lq, Lk, Lk))
    ofs = torch.zeros(B, dtype=torch.int32)
    body, ofs_body = (
        (fa._PATH[p.path], p.block_q) for p in (
            fa._plan(B, H, lq, Lk, D, dtype, H100_SMS, offset=o)
            for o in (False, True)))
    out = fa.flash_attention(q, k, v, causal=True)
    assert out.shape == q.shape and out.dtype == dtype
    out = fa.flash_attention_offset(q, k, v, ofs)
    assert out.shape == q.shape and out.dtype == dtype
    (flash, offset) = card_route
    names = fa._VARIANTS[dtype]
    # flash: ..., out, B*H, Lq, Lk, D, causal, scale, path, block_q
    assert flash[1:3] == names[0]
    assert flash[-8:-3] == (B * H, lq, Lk, D, 1) and flash[-2:] == body
    # offset: ..., offsets, out, B, H, Lq, Lk, D, scale, path, block_q
    assert offset[1:3] == names[1]
    assert offset[-8:-3] == (B, H, lq, Lk, D) and offset[-2:] == ofs_body


# ---------------------------------------------------------------------------
# the bf16 tile's arithmetic
# ---------------------------------------------------------------------------
def emulate_tile(q, k, v, causal, offsets=None, pv=p_split_bf16):
    """The bf16 tile body's forward on bf16 values carried in fp32: each
    16-row block of a 64-row CTA is one warp, walking 64-key tiles (32
    for D > 64) up to the last key its rows can see, with its own online
    softmax; Q K^T exact in 16-wide k-steps into the fp32 accumulator,
    P.V by ``pv`` (P split in two bf16 terms); the output rounded to
    bf16."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    DP = next(p for p in (16, 32, 64, 128) if D <= p)
    KT = 64 if DP <= 64 else 32
    scale = 1.0 / D ** 0.5
    masked = causal or offsets is not None
    out = torch.zeros(B, H, Lq, D)
    for b in range(B):
        ofs = 0 if offsets is None else int(offsets[b])
        for h in range(H):
            for r0 in range(0, Lq, 16):
                n = min(16, Lq - r0)
                Q = torch.zeros(16, DP)
                Q[:n, :D] = q[b, h, r0:r0 + n]
                row_pos = ofs + r0 + torch.arange(16)
                warp_keys = min(ofs + min(r0 + 16, Lq), Lk) if masked \
                    else Lk
                m = torch.full((16,), NEG)
                l = torch.zeros(16)
                o = torch.zeros(16, DP)
                for k0 in range(0, warp_keys, KT):
                    kpos = torch.arange(k0, k0 + KT)
                    live = kpos < Lk
                    K = torch.zeros(KT, DP)
                    V = torch.zeros(KT, DP)
                    K[live, :D] = k[b, h, kpos[live]]
                    V[live, :D] = v[b, h, kpos[live]]
                    s = mma_sum(torch.zeros(16, KT), Q, K.t(), 16, exact)
                    s = s * scale
                    vis = live[None] & ((kpos[None] <= row_pos[:, None]) |
                                        (not masked))
                    s = torch.where(vis, s, NEG)
                    m_new = torch.maximum(m, s.amax(1))
                    alpha = torch.exp(m - m_new)
                    p = torch.where(vis, torch.exp(s - m_new[:, None]), 0)
                    l = l * alpha + p.sum(1)
                    m = m_new
                    o = o * alpha[:, None] + mma_sum(torch.zeros(16, DP), p,
                                                     V, 16, pv)
                res = o / torch.where(l > 0, l, 1)[:, None]
                out[b, h, r0:r0 + n] = res[:n, :D]
    return out.to(BF16).float()


def _tile_case(B, H, Lq, Lk, D, seed):
    rs = np.random.RandomState(seed)
    arrays = [rs.randn(B, H, L, D).astype(np.float32)
              for L in (Lq, Lk, Lk)]
    (jq, jk, jv), tensors = _bf16(*arrays)
    return (jq, jk, jv), tensors


@pytest.mark.parametrize("Lq,Lk,D,causal", [(32, 32, 64, True),
                                            (70, 70, 16, True),
                                            (33, 100, 64, False),
                                            (20, 20, 128, True)])
def test_emulated_bf16_tile_matches_plain_and_pallas(Lq, Lk, D, causal):
    (jq, jk, jv), (tq, tk, tv) = _tile_case(2, 2, Lq, Lk, D, Lq + D)
    got = emulate_tile(tq.float(), tk.float(), tv.float(), causal)
    plain = fa.blockwise_attention(tq, tk, tv, causal).float()
    pallas = torch.from_numpy(np.array(_f32(jax_flash_attention(
        jq, jk, jv, causal=causal, block_q=Lq, block_k=Lk,
        interpret=True))))
    for want in (plain, pallas):
        assert (got - want).abs().max().item() <= \
            bf16_ulp(want.abs().max().item()) + TOL


def test_emulated_bf16_tile_with_offsets_matches_plain():
    """The tile under offsets (row r of b at offsets[b] + r): the mask,
    the tile skip and the per-warp key bound move by the offset."""
    (_, _, _), (tq, tk, tv) = _tile_case(3, 2, 20, 96, 64, 5)
    ofs = torch.tensor([0, 40, 76], dtype=torch.int32)
    got = emulate_tile(tq.float(), tk.float(), tv.float(), True, ofs)
    want = fa.offset_attention_reference(tq, tk, tv, ofs).float()
    assert (got - want).abs().max().item() <= \
        bf16_ulp(want.abs().max().item()) + TOL


def test_p_rounded_once_error_is_recorded(record_property):
    """P rounded once to bf16 in place of its two terms, at D 64, Lq 32:
    its error against the fp32 P.V beside the kernel's own, recorded
    (the kernel keeps the split whatever it is)."""
    (_, _, _), (tq, tk, tv) = _tile_case(2, 2, 32, 256, 64, 11)
    plain = fa.blockwise_attention(tq, tk, tv, False).float()
    args = (tq.float(), tk.float(), tv.float(), False)
    own = (emulate_tile(*args) - plain).abs().max().item()
    once = (emulate_tile(*args, pv=p_once_bf16) - plain).abs().max().item()
    bound = bf16_ulp(plain.abs().max().item()) + TOL
    record_property("kernel_err", own)
    record_property("p_once_err", once)
    record_property("bound", bound)
    assert own <= bound and np.isfinite(once)


# ---------------------------------------------------------------------------
# prefill_apply / decode_apply, every mix
# ---------------------------------------------------------------------------
def _models(compute):
    """The reference's param tree and the port's model for one compute
    dtype, from the same numpy weights."""
    if compute == "int8":
        jparams = jlm.quantize_lm_params(PARAMS, SPEC)
        pairs = {k: (v.codes, v.scales) if hasattr(v, "codes") else v
                 for k, v in jparams.items()}
        return jparams, tlm.TransformerLM.from_numpy(pairs, SPEC, "cpu")
    model = tlm.TransformerLM.from_numpy(PARAMS, SPEC, "cpu")
    if compute == "bfloat16":
        return ({k: jnp.asarray(v).astype(jnp.bfloat16)
                 for k, v in PARAMS.items()}, model.astype(BF16))
    return {k: jnp.asarray(v) for k, v in PARAMS.items()}, model


@pytest.mark.parametrize("compute,kv", MIXES)
def test_prefill_and_decode_match_jax(monkeypatch, compute, kv):
    """A padded prompt batch with ragged lengths, then three decode steps
    from each sequence's own frontier; the decode attention's q arrives
    in the cache dtype (fp32 compute over a bf16 cache rounds it)."""
    monkeypatch.setenv("MXNET_PALLAS", "0")
    seen = []
    door = tlm.sdp_attention

    def spy(q, *a, **kw):
        if kw.get("q_offsets") is not None:
            seen.append(q.dtype)
        return door(q, *a, **kw)

    monkeypatch.setattr(tlm, "sdp_attention", spy)
    jparams, model = _models(compute)
    rs = np.random.RandomState(2)
    tokens = rs.randint(0, 256, (3, 8)).astype(np.int32)
    lengths = np.array([8, 3, 5], np.int32)
    tokens[1, 3:] = 0
    tokens[2, 5:] = 0
    C = 16
    jl, jk, jv = jlm.prefill_apply(jparams, tokens, lengths, C, SPEC,
                                   cache_dtype=kv)
    with torch.no_grad():
        tl, tk, tv = tlm.prefill_apply(model.params(), tokens, lengths, C,
                                       SPEC, cache_dtype=TORCH_DTYPES[kv])

    def close(got, want):
        assert got.dtype == F32
        err = np.abs(got.numpy() - np.asarray(want)).max()
        assert err <= LOGIT_TOL * np.abs(np.asarray(want)).max(), err

    def caches(ck, cv, jk_, jv_):
        for got, want in ((ck, jk_), (cv, jv_)):
            assert str(got.dtype) == "torch." + str(want.dtype) == \
                "torch." + kv
            _within_ulp(_f32(got), _f32(want))

    close(tl, jl)
    caches(tk, tv, jk, jv)
    lens = lengths.copy()
    for _step in range(3):
        toks = rs.randint(0, 256, 3).astype(np.int32)
        jl, jk, jv = jlm.decode_apply(jparams, jk, jv, toks, lens, SPEC)
        with torch.no_grad():
            tl, tk2, tv2 = tlm.decode_apply(model.params(), tk, tv, toks,
                                            lens, SPEC)
        assert tk2 is tk and tv2 is tv           # updated in place
        close(tl, jl)
        caches(tk, tv, jk, jv)
        lens = lens + 1
    assert seen == [TORCH_DTYPES[kv]] * (3 * SPEC["num_layers"])


def test_fp32_compute_over_a_bf16_cache_rounds_q():
    """decode_apply's q rule at the attention: fp32 q cast to the bf16
    cache's dtype gives the reference's output; the unrounded q gives
    another."""
    rs = np.random.RandomState(4)
    q = torch.from_numpy(rs.randn(2, 2, 1, 16).astype(np.float32))
    k, v = (torch.from_numpy(rs.randn(2, 2, 24, 16).astype(np.float32))
            .to(BF16) for _ in range(2))
    ofs = torch.tensor([5, 23], dtype=torch.int32)
    rounded = fa.offset_attention_reference(q.to(BF16), k, v, ofs)
    widened = fa.offset_attention_reference(q, k, v, ofs)
    assert rounded.dtype == BF16 and widened.dtype == F32
    assert not torch.equal(rounded.float(), widened)
    want = jax_flash_attention_offset(
        jnp.asarray(q.numpy()).astype(jnp.bfloat16),
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (k, v)), ofs.numpy(), block_q=1, block_k=8,
        interpret=True)
    _within_ulp(_f32(rounded), _f32(want))


# ---------------------------------------------------------------------------
# the store and the engine
# ---------------------------------------------------------------------------
PROMPTS = [[7, 3, 11, 29, 4], [200, 1, 1, 9, 50, 77, 3, 3, 12, 250, 8]]


def _serve(engine, n_tokens=12):
    try:
        futs = [engine.submit("m", p, max_tokens=n_tokens) for p in PROMPTS]
        return [f.result(120).tokens for f in futs], engine.stats()
    finally:
        engine.close()


@pytest.mark.parametrize("compute,kv", MIXES)
def test_every_mix_builds_and_serves(compute, kv):
    reg = ModelRegistry()
    store = reg.add_generative_model("m", PARAMS, SPEC, device="cpu",
                                     compute_dtype=compute, kv_dtype=kv,
                                     warmup=False, **KW)
    out, stats = _serve(GenerationEngine(reg), n_tokens=3)
    assert [len(t) for t in out] == [3, 3]
    assert not store.paged and store.stats()["kv_dtype"] == kv
    assert stats["cache_hwm"]["m"]["cache_dtype"] == kv


def test_serve_dtype_knobs_build_the_bf16_contiguous_store(monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_DTYPE", "bfloat16")
    monkeypatch.setenv("MXNET_SERVE_KV_DTYPE", "bfloat16")
    monkeypatch.setenv("MXNET_SERVE_PAGED", "0")
    kw = {k: v for k, v in KW.items() if k != "paged"}
    store = ModelRegistry().add_generative_model("m", PARAMS, SPEC,
                                                 device="cpu", **kw)
    st = store.stats()
    assert not st["paged"] and st["compute_dtype"] == "bfloat16"
    assert st["kv_dtype"] == "bfloat16"
    assert store.new_cache(2, 8)[0].dtype == BF16


def _jax_margin(prompt, tokens):
    """The reference's top-2 logit margin, and its largest |logit|, for
    the token after ``prompt + tokens`` on the bf16 store's programs,
    replayed for one sequence: one prefill at the prompt's bucket, then
    one decode step a token."""
    jparams, _ = _models("bfloat16")
    jstore = JaxRegistry().add_generative_model(
        "m", PARAMS, SPEC, warmup=False, compute_dtype="bfloat16",
        kv_dtype="bfloat16", **KW)
    toks, lens = jstore.pad_prompts([prompt])
    C = jstore.kv_bucket(len(prompt) + len(tokens) + 1)
    logits, ck, cv = jlm.prefill_apply(jparams, toks, lens, C, SPEC,
                                       cache_dtype="bfloat16")
    logits = np.asarray(logits)[:, len(prompt) - 1]
    for i, t in enumerate(tokens):
        logits, ck, cv = jlm.decode_apply(
            jparams, ck, cv, np.asarray([t], np.int32),
            np.asarray([len(prompt) + i], np.int32), SPEC)
    logits = np.asarray(logits)[0]
    top = np.sort(logits)[::-1]
    return float(top[0] - top[1]), float(np.abs(logits).max())


def test_bf16_contiguous_engine_matches_jax():
    """Greedy streams equal the reference's but where its top-2 margin
    is inside the logits' tolerance; dtypes, weight bytes and the cache's
    bytes are the reference's, and a slot holds exactly half the fp32
    store's bytes."""
    bf16 = dict(KW, compute_dtype="bfloat16", kv_dtype="bfloat16")
    jreg = JaxRegistry()
    jreg.add_generative_model("m", PARAMS, SPEC, warmup=False, **bf16)
    want, jstats = _serve(JaxEngine(jreg))
    jst = jreg.gen_store("m").stats()
    reg = ModelRegistry()
    store = reg.add_generative_model("m", PARAMS, SPEC, device="cpu",
                                     warmup=False, **bf16)
    got, stats = _serve(GenerationEngine(reg))
    assert [len(t) for t in got] == [len(t) for t in want]
    for prompt, a, b in zip(PROMPTS, got, want):
        if a != b:
            k = next(j for j in range(len(a)) if a[j] != b[j])
            margin, top = _jax_margin(prompt, b[:k])
            assert margin < LOGIT_TOL * top, (k, margin, top)
    st = store.stats()
    for key in ("compute_dtype", "kv_dtype", "weight_bytes", "paged"):
        assert st[key] == jst[key], key
    assert st["compute_dtype"] == "bfloat16" and st["kv_dtype"] == "bfloat16"
    hwm, jhwm = stats["cache_hwm"]["m"], jstats["cache_hwm"]["m"]
    for key in ("cache_dtype", "cache_len", "cache_mb",
                "cache_bytes_per_slot", "slots"):
        assert hwm[key] == jhwm[key], key
    assert hwm["cache_dtype"] == "bfloat16"
    fp_reg = ModelRegistry()
    fp_store = fp_reg.add_generative_model("m", PARAMS, SPEC, device="cpu",
                                           warmup=False, **KW)
    _out, fp_stats = _serve(GenerationEngine(fp_reg))
    fp_hwm = fp_stats["cache_hwm"]["m"]
    assert fp_hwm["cache_len"] == hwm["cache_len"]
    assert fp_hwm["cache_bytes_per_slot"] == 2 * hwm["cache_bytes_per_slot"]
    assert fp_store.stats()["weight_bytes"]["total"] == \
        2 * st["weight_bytes"]["total"]
