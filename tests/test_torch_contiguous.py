"""The port's contiguous KV plane against the JAX package's, on the CPU.

``flash_attention_offset``'s plain version against the reference's
dense offset-causal twin and its Pallas kernel in interpret mode;
``prefill_apply`` and ``decode_apply`` with fp32 and with int8 weights
against the reference's; the store's bucket helpers; and greedy token
streams through the port's contiguous ``GenerationEngine`` against the
reference engine's (``paged=False``).  Sizes are those of
``tests/test_torch_serving.py``.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.attention import _dense_attention
from mxnet_tpu.serving import GenerationEngine as JaxEngine
from mxnet_tpu.serving import ModelRegistry as JaxRegistry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import flash_attention as fa
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.ops.attention import sdp_attention
from mxnet_tpu_torch.serving import GenerationEngine, ModelRegistry

jlm = importlib.import_module("mxnet_tpu.models.transformer_lm")
jfa = importlib.import_module("mxnet_tpu.pallas_ops.flash_attention")

SPEC = tlm.lm_spec(num_layers=2, num_hidden=32, num_heads=4, vocab_size=50)
PARAMS = tlm.random_params(SPEC, seed=3)
KW = dict(batch_buckets=(1, 2, 4), prompt_buckets=(4, 8, 24), kv_block=8,
          kv_max=40, paged=False)
MARGIN = 1e-5   # a differing greedy token must sit on a near tie


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# flash_attention_offset
# ---------------------------------------------------------------------------
OFFSET_CASES = [(1, 16, [0, 5, 15]), (1, 40, [39, 0, 17]),
                (4, 24, [0, 3, 20]), (7, 16, [9, 0, 2])]


@pytest.mark.parametrize("lq,lk,offsets", OFFSET_CASES)
def test_offset_attention_plain_matches_jax(lq, lk, offsets):
    rs = np.random.RandomState(lq * lk)
    q = rs.randn(3, 2, lq, 8).astype(np.float32)
    k, v = (rs.randn(3, 2, lk, 8).astype(np.float32) for _ in range(2))
    ofs = np.asarray(offsets, np.int32)
    got = fa.flash_attention_offset(*_t(q, k, v, ofs)).numpy()
    scale = 1.0 / np.sqrt(8.0)
    dense = np.asarray(_dense_attention(q, k, v, True, scale, q_offsets=ofs))
    assert np.abs(got - dense).max() <= 1e-5
    kern = np.asarray(jfa.flash_attention_offset(
        q, k, v, ofs, scale=scale, block_q=4, block_k=8, interpret=True))
    assert np.abs(got - kern).max() <= 1e-5
    # the functional door routes q_offsets to it
    door = sdp_attention(*_t(q, k, v), q_offsets=ofs).numpy()
    assert np.array_equal(door, got)


def test_offset_attention_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(2, 1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_offset(q, q, q, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 4"):
        fa._check(torch.zeros(2, 1, 1, 6), torch.zeros(2, 1, 4, 6),
                  torch.zeros(2, 1, 4, 6))


# ---------------------------------------------------------------------------
# prefill_apply / decode_apply
# ---------------------------------------------------------------------------
def _param_sets():
    jq = jlm.quantize_lm_params(PARAMS, SPEC)
    qpairs = {k: (v.codes, v.scales) if hasattr(v, "codes") else v
              for k, v in jq.items()}
    return {"fp32": (PARAMS, PARAMS), "int8": (jq, qpairs)}


def _program(fn, *example):
    """``fn`` compiled for arguments like ``example`` as one program with
    XLA's algebraic simplifier off, so it computes what the reference
    computes op by op, at one compile in place of one a primitive and
    shape."""
    return jax.jit(fn).lower(*example).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})


@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_prefill_and_decode_match_jax(monkeypatch, weights):
    """A padded prompt batch with ragged lengths, then three decode steps
    from each sequence's own frontier: logits and both caches within
    1e-4 x max|ref| at every step."""
    monkeypatch.setenv("MXNET_PALLAS", "0")
    jparams, pparams = _param_sets()[weights]
    model = tlm.TransformerLM.from_numpy(pparams, SPEC, device="cpu")
    rs = np.random.RandomState(1)
    tokens = rs.randint(0, 50, (3, 8)).astype(np.int32)
    lengths = np.array([8, 3, 5], np.int32)
    tokens[1, 3:] = 0
    tokens[2, 5:] = 0
    C = 16
    jl, jk, jv = _program(
        lambda t, n: jlm.prefill_apply(jparams, t, n, C, SPEC), tokens,
        lengths)(tokens, lengths)
    with torch.no_grad():
        tl, tk, tv = tlm.prefill_apply(model.params(), tokens, lengths, C,
                                       SPEC)

    def close(got, want):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()

    for got, want in ((tl, jl), (tk, jk), (tv, jv)):
        close(got, want)
    lens = lengths.copy()
    decode = _program(
        lambda k, v, t, n: jlm.decode_apply(jparams, k, v, t, n, SPEC), jk,
        jv, lens, lens)
    for step in range(3):
        toks = rs.randint(0, 50, 3).astype(np.int32)
        jl, jk, jv = decode(jk, jv, toks, lens)
        with torch.no_grad():
            tl, tk2, tv2 = tlm.decode_apply(model.params(), tk, tv, toks,
                                            lens, SPEC)
        assert tk2 is tk and tv2 is tv           # updated in place
        for got, want in ((tl, jl), (tk, jk), (tv, jv)):
            close(got, want)
        lens = lens + 1


# ---------------------------------------------------------------------------
# store and engine
# ---------------------------------------------------------------------------
def _store(**kw):
    return ModelRegistry().add_generative_model(
        "m", PARAMS, SPEC, device="cpu", warmup=False, **dict(KW, **kw))


def test_store_buckets_match_jax():
    jreg = JaxRegistry()
    jstore = jreg.add_generative_model("m", PARAMS, SPEC, warmup=False, **KW)
    store = _store()
    for n in (1, 5, 8, 9, 24, 33):
        assert store.kv_bucket(n) == jstore.kv_bucket(n)
    prompts = [[1, 2, 3], [4] * 7, [5, 6]]
    for got, want in zip(store.pad_prompts(prompts),
                         jstore.pad_prompts(prompts)):
        assert np.array_equal(got, want) and got.dtype == want.dtype
    for s in (store, jstore):
        with pytest.raises(Exception, match="prompt bucket"):
            s.validate_request(25, 2)
        with pytest.raises(Exception, match="KV_MAX"):
            s.kv_bucket(41)
    st, jst = store.stats(), jstore.stats()
    assert st["paged"] is jst["paged"] is False
    assert "pool_blocks" not in st
    assert st["weight_bytes"] == jst["weight_bytes"]


def _requests():
    """test_torch_serving's stream set, with a prompt that fills the
    largest bucket and one that grows its cache over two kv blocks."""
    rs = np.random.RandomState(0)
    reqs = [dict(tokens=[int(t) for t in rs.randint(0, 50, n)],
                 max_tokens=mt)
            for n, mt in ((3, 10), (8, 6), (12, 20), (5, 30), (17, 8),
                          (24, 9))]
    return reqs


def _serve(engine, reqs, serial):
    try:
        if serial:
            out = [engine.submit("m", **kw).result(120).tokens
                   for kw in reqs]
        else:
            futs = [engine.submit("m", **kw) for kw in reqs]
            out = [f.result(120).tokens for f in futs]
        return out, engine.stats()
    finally:
        engine.close()


def _jax_margin(prompt, tokens):
    """The reference's top-2 logit margin for the token after ``prompt +
    tokens``: one prefill at the prompt's bucket, then one decode step
    per token (one sequence)."""
    jstore = JaxRegistry().add_generative_model("m", PARAMS, SPEC,
                                                warmup=False, **KW)
    toks, lens = jstore.pad_prompts([prompt])
    C = jstore.kv_bucket(len(prompt) + len(tokens) + 1)
    logits, ck, cv = jlm.prefill_apply(PARAMS, toks, lens, C, SPEC)
    logits = np.asarray(logits)[:, len(prompt) - 1]
    for i, t in enumerate(tokens):
        logits, ck, cv = jlm.decode_apply(
            PARAMS, ck, cv, np.asarray([t] + [0] * (len(lens) - 1), np.int32),
            np.asarray([len(prompt) + i] + [0] * (len(lens) - 1), np.int32),
            SPEC)
    top = np.sort(np.asarray(logits)[0])[::-1]
    return float(top[0] - top[1])


@pytest.fixture(scope="module")
def jax_streams():
    reg = JaxRegistry()
    reg.add_generative_model("m", PARAMS, SPEC, warmup_kv_depth=40, **KW)
    return {serial: _serve(JaxEngine(reg), _requests(), serial)
            for serial in (False, True)}


@pytest.mark.parametrize("serial", [False, True])
def test_contiguous_engine_streams_match_jax(jax_streams, serial):
    want, jstats = jax_streams[serial]
    reg = ModelRegistry()
    reg.add_generative_model("m", PARAMS, SPEC, device="cpu",
                             warmup_kv_depth=40, **KW)
    got, stats = _serve(GenerationEngine(reg), _requests(), serial)
    for kw, a, b in zip(_requests(), got, want):
        if a != b:
            k = next(j for j in range(min(len(a), len(b))) if a[j] != b[j])
            assert _jax_margin(kw["tokens"], b[:k]) < MARGIN, \
                "stream differs at step %d where the reference is not at " \
                "a near tie" % k
    assert [len(t) for t in got] == [len(t) for t in want]
    for key in ("prefills", "prefill_seqs", "decode_steps",
                "generated_tokens", "cache_grows", "slot_grows"):
        assert stats[key] == jstats[key], key
    hwm, jhwm = stats["cache_hwm"]["m"], jstats["cache_hwm"]["m"]
    for key in ("cache_len", "cache_mb", "cache_bytes_per_slot", "slots"):
        assert hwm[key] == jhwm[key], key
    assert stats["models"]["m"]["active"] == 0
    assert stats["models"]["m"]["paged"] is False


def test_contiguous_engine_samples_and_validates():
    """Seeded sampled streams repeat; a prompt past the largest bucket is
    refused at submit; every request ends with its max_tokens."""
    reg = ModelRegistry()
    store = reg.add_generative_model("m", PARAMS, SPEC, device="cpu", **KW)
    eng = GenerationEngine(reg)
    try:
        kw = dict(max_tokens=8, temperature=0.8, top_k=10)
        a = eng.submit("m", [4, 5, 6], seed=7, **kw).result(60)
        b = eng.submit("m", [4, 5, 6], seed=7, **kw).result(60)
        with pytest.raises(MXNetError, match="prompt bucket"):
            eng.submit("m", [1] * 25, max_tokens=2)
        assert store.stats()["paged"] is False
    finally:
        eng.close()
    assert a.tokens == b.tokens and len(a.tokens) == 8
    assert a.finish_reason == "length"
