"""The port's paged serving plane against the JAX package's, on the CPU.

Block bookkeeping must give the same block ids as the JAX classes for
the same operations, greedy token streams through the port's
``GenerationEngine`` must equal the JAX engine's token for token (the
request set of ``tests/test_paged_decode.py``'s stream tests, with a
shared-prefix trio), and sampled draws must follow the temperature /
top-k masked softmax.  The sizes are those of ``test_paged_decode.py``.
"""
import numpy as np
import pytest
import torch
from scipy import stats

from mxnet_tpu.models.transformer_lm import lm_spec, random_params
from mxnet_tpu.serving import GenerationEngine as JaxEngine
from mxnet_tpu.serving import ModelRegistry as JaxRegistry
from mxnet_tpu.serving import decode_engine as jax_engine
from mxnet_tpu.serving import program_store as jax_store
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (GenerationEngine, ModelRegistry,
                                     ServeOverloaded, TokenStream)
from mxnet_tpu_torch.serving import decode_engine, program_store

SPEC = lm_spec(num_layers=2, num_hidden=32, num_heads=4, vocab_size=50)
PARAMS = random_params(SPEC, seed=3)
KW = dict(batch_buckets=(1, 2, 4), prompt_buckets=(4, 8, 24), kv_block=8,
          kv_max=40, warmup_kv_depth=40)


def _rs_prompt(seed, n):
    return list(np.random.RandomState(seed).randint(0, 50, n))


def _requests():
    """test_paged_decode's greedy stream set, then a shared-prefix trio:
    a prompt, a prompt diverging in its tail, the first prompt again."""
    rs = np.random.RandomState(0)
    reqs = [dict(tokens=list(rs.randint(0, 50, n)), max_tokens=mt)
            for n, mt in ((3, 10), (8, 6), (12, 20), (5, 30), (17, 8))]
    P = _rs_prompt(3, 12)
    Pdiv = P[:10] + [(P[10] + 1) % 50, (P[11] + 3) % 50]
    return reqs + [dict(tokens=P, max_tokens=6),
                   dict(tokens=Pdiv, max_tokens=6),
                   dict(tokens=P, max_tokens=6)]


def _port_registry(**kw):
    reg = ModelRegistry()
    reg.add_generative_model("m", PARAMS, SPEC, device="cpu",
                             **dict(KW, prefill_chunk=8, **kw))
    return reg


def _run(engine, requests, serial=False):
    try:
        if serial:
            return [engine.submit("m", **kw).result(120).tokens
                    for kw in requests]
        futs = [engine.submit("m", **kw) for kw in requests]
        return [f.result(120).tokens for f in futs]
    finally:
        engine.close()


@pytest.fixture(scope="module")
def jax_streams():
    reg = JaxRegistry()
    reg.add_generative_model("m", PARAMS, SPEC, paged=True, prefill_chunk=8,
                             **KW)
    reqs = _requests()
    return {"batched": _run(JaxEngine(reg), reqs),
            "serial": _run(JaxEngine(reg), reqs, serial=True)}


# ---------------------------------------------------------------------------
# block bookkeeping
# ---------------------------------------------------------------------------
def _pool_script(mod):
    """One fixed sequence of allocator and prefix-cache operations; the
    trace of every returned block id and count."""
    pool = mod._BlockPool(9)
    prefix = mod._PrefixStore(pool, 4)
    seq = [pool.alloc() for _ in range(3)]
    prompt = list(range(10))
    prefix.register(prompt, seq + [0])   # 2 full blocks + the tail
    trace = seq + [pool.refcount(b) for b in range(9)]
    extra = pool.alloc()
    pool.ref(extra)
    trace += [extra, pool.shared(), pool.deref(extra), pool.deref(extra)]
    blocks, tail = prefix.match(prompt)
    trace += blocks + [tail]
    blocks, tail = prefix.match(prompt[:9] + [99])
    trace += blocks + [tail, prefix.evictable()]
    for b in seq:                        # the sequence retires
        pool.deref(b)
    trace += [prefix.evictable(), prefix.evict_one(), prefix.evict_one(),
              len(prefix), pool.used(), pool.free_count(), pool.hwm]
    trace += [pool.alloc() for _ in range(8)]
    return trace


def test_block_pool_and_prefix_store_match_jax():
    assert _pool_script(decode_engine) == _pool_script(jax_engine)


def test_bucket_helpers_match_jax():
    for edges in (None, (4, 1, 2, 2), [32]):
        assert program_store.bucket_edges(edges) == \
            jax_store.bucket_edges(edges)
    edges = program_store.bucket_edges((1, 2, 4, 8))
    for n in range(0, 11):
        assert program_store.bucket_for(n, edges) == \
            jax_store.bucket_for(n, edges)
    with pytest.raises(MXNetError):
        program_store.bucket_edges((0, 2))


# ---------------------------------------------------------------------------
# whole engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("serial", [False, True])
def test_greedy_streams_equal_jax_engine(jax_streams, serial):
    """Batched and one-at-a-time submission (the latter exercises prefix
    hits and copy-on-write forks) give the JAX engine's streams."""
    eng = GenerationEngine(_port_registry())
    got = _run(eng, _requests(), serial=serial)
    assert got == jax_streams["serial" if serial else "batched"]


def test_prefix_sharing_cow_and_chunk_counters():
    """The JAX test's counter contract: an exact re-prompt adopts its
    blocks and reruns only the last token; a diverging prompt shares
    only the first whole block; decode writes into shared blocks fork."""
    P = _rs_prompt(3, 12)
    Pdiv = P[:10] + [(P[10] + 1) % 50, (P[11] + 3) % 50]
    reg = _port_registry()
    eng = GenerationEngine(reg)
    try:
        eng.submit("m", P, max_tokens=6).result(60)
        s0 = eng.stats()
        assert s0["prefix_hits"] == 0
        eng.submit("m", P, max_tokens=6).result(60)
        s1 = eng.stats()
        assert s1["prefix_hits"] == 1
        assert s1["prefix_hit_blocks"] - s0["prefix_hit_blocks"] == 2
        assert s1["prefix_hit_tokens"] - s0["prefix_hit_tokens"] == 12
        assert s1["prefill_chunks"] - s0["prefill_chunks"] == 1
        eng.submit("m", Pdiv, max_tokens=6).result(60)
        s2 = eng.stats()
        assert s2["prefix_hit_tokens"] - s1["prefix_hit_tokens"] == 8
        assert s2["cow_forks"] >= 2
        cs = reg.gen_store("m").stats()["cache_state"]
        assert cs["prefix_entries"] >= 2 and cs["pool_blocks_used"] > 0
    finally:
        eng.close()


def test_chunk_counts_and_chunking_never_changes_numbers():
    rs = np.random.RandomState(2)
    reqs = [dict(tokens=list(rs.randint(0, 50, n)), max_tokens=6)
            for n in (13, 7, 20, 3)]
    outs, chunks = [], []
    for chunk in (4, 40):
        reg = ModelRegistry()
        reg.add_generative_model("m", PARAMS, SPEC, device="cpu",
                                 prefill_chunk=chunk, **KW)
        eng = GenerationEngine(reg)
        try:
            futs = [eng.submit("m", **kw) for kw in reqs]
            outs.append([f.result(60).tokens for f in futs])
            chunks.append(eng.stats()["prefill_chunks"])
        finally:
            eng.close()
    assert outs[0] == outs[1]
    assert chunks == [12, 4]


def test_small_pool_throttles_and_oversized_request_sheds():
    rs = np.random.RandomState(4)
    reqs = [dict(tokens=list(rs.randint(0, 50, 4)), max_tokens=8)
            for _ in range(6)]
    want = _run(GenerationEngine(_port_registry()), reqs)
    small = _port_registry(pool_blocks=6)
    eng = GenerationEngine(small)
    try:
        got = [f.result(60).tokens for f in
               [eng.submit("m", **kw) for kw in reqs]]
        cs = small.gen_store("m").stats()["cache_state"]
        assert cs["pool_blocks_hwm"] <= 5
        # 4 + 36 tokens fill 5 blocks, and the partial prompt tail needs
        # its fork block: 6 > 5 usable blocks
        fut = eng.submit("m", [1, 2, 3, 4], max_tokens=36)
        with pytest.raises(ServeOverloaded):
            fut.result(60)
        assert eng.stats()["shed_pool"] == 1
    finally:
        eng.close()
    assert got == want
    with pytest.raises(MXNetError):
        _port_registry(kv_max=80, pool_blocks=6)


def test_token_stream_submit_validation_and_close():
    reg = _port_registry()
    eng = GenerationEngine(reg)
    try:
        stream = TokenStream()
        fut = eng.submit("m", [5, 6, 7], max_tokens=5, stream=stream)
        assert list(stream) == fut.result(60).tokens
        assert fut.result().finish_reason == "length"
        for bad in (dict(tokens=[]), dict(tokens=[50]),
                    dict(tokens=[1], max_tokens=0),
                    dict(tokens=[1] * 30, max_tokens=20)):
            with pytest.raises(MXNetError):
                eng.submit("m", **bad)
        with pytest.raises(MXNetError):
            eng.submit("nope", [1])
        st = eng.stats()
        assert st["requests"] == st["finished"] == 1
        assert st["decode_steps"] == 4 and st["generated_tokens"] == 4
    finally:
        eng.close()
    with pytest.raises(MXNetError):
        eng.submit("m", [1])
    assert not eng.alive()


def test_slice_refuses_what_it_does_not_port(monkeypatch):
    for kw in (dict(compute_dtype="int8"), dict(compute_dtype="bfloat16"),
               dict(kv_dtype="int8"), dict(paged=False)):
        with pytest.raises(MXNetError, match="later serving slice"):
            ModelRegistry().add_generative_model("m", PARAMS, SPEC,
                                                 device="cpu", **kw)
    monkeypatch.setenv("MXNET_SERVE_DTYPE", "bfloat16")
    with pytest.raises(MXNetError, match="later serving slice"):
        ModelRegistry().add_generative_model("m", PARAMS, SPEC, device="cpu")


def test_no_silent_cpu(monkeypatch):
    """Without CUDA, the default device raises instead of serving on the
    CPU; device='cpu' is the only way there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = ModelRegistry()
    with pytest.raises(MXNetError, match="CUDA"):
        reg.add_generative_model("m", PARAMS, SPEC, **KW)
    assert reg.models() == []
    reg.add_generative_model("m", PARAMS, SPEC, device="cpu", **KW)
    assert reg.models() == ["m"] and "m" in reg
    reg.remove_model("m")
    assert len(reg) == 0


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def test_greedy_sampling_takes_the_first_maximum():
    logits = torch.tensor([[0.5, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]])
    toks = program_store.sample_tokens(logits, np.zeros(2), np.zeros(2),
                                       [None, None])
    assert toks.tolist() == [1, 0]


@pytest.mark.parametrize("temp,top_k", [(0.8, 4), (1.3, 0)])
def test_sampling_follows_masked_softmax(temp, top_k):
    """Chi-square of 6000 seeded draws against the temperature / top-k
    masked softmax; masked tokens never appear."""
    logits = np.array([1.0, 0.2, -0.5, 0.9, 0.0, -1.2, 0.6, 0.3], np.float32)
    z = logits / temp
    keep = np.ones(8, bool) if top_k == 0 else \
        z >= np.sort(z)[::-1][top_k - 1]
    want = np.where(keep, np.exp(z - z.max()), 0.0)
    want /= want.sum()
    rows = 300
    gens = [torch.Generator().manual_seed(1000 + i) for i in range(rows)]
    batch = torch.from_numpy(np.tile(logits, (rows, 1)))
    counts = np.zeros(8)
    for _ in range(20):
        toks = program_store.sample_tokens(
            batch, np.full(rows, temp), np.full(rows, top_k), gens,
            np.ones(rows, bool))
        counts += np.bincount(toks.numpy(), minlength=8)
    assert counts[~keep].sum() == 0
    exp = want[keep] * counts.sum()
    chi2 = ((counts[keep] - exp) ** 2 / exp).sum()
    assert stats.chi2.sf(chi2, keep.sum() - 1) > 1e-3


def test_sampled_streams_follow_their_seed():
    """Same seed, same stream; the greedy row beside it is unaffected by
    the sampled one."""
    reg = _port_registry()
    eng = GenerationEngine(reg)
    try:
        kw = dict(max_tokens=8, temperature=0.8, top_k=10)
        a = eng.submit("m", [4, 5, 6], seed=7, **kw).result(60).tokens
        b = eng.submit("m", [4, 5, 6], seed=7, **kw).result(60).tokens
        g1 = eng.submit("m", [4, 5, 6], max_tokens=8).result(60).tokens
    finally:
        eng.close()
    assert a == b and len(a) == 8
    eng = GenerationEngine(reg)
    g2 = _run(eng, [dict(tokens=[4, 5, 6], max_tokens=8)])[0]
    assert g1 == g2
