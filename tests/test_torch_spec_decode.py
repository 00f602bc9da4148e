"""Speculative decoding on the port's paged plane against the JAX
package, on the CPU, at the sizes of ``tests/test_spec_decode.py``.

The accept/reject rule first: ``spec_verify``'s greedy rows bit-equal to
the reference's for every window size and ``valid``, ``_masked_dist``
within 1e-6 of the reference's, and the sampled rule's first emitted
token (and the token after an accepted proposal) distributed as the
target's density, by a chi-square test.  Then the engine: greedy
streams with a self-draft and with a random draft equal one JAX
non-speculative run token for token (and the port's own), the counters
(a self-draft accepts every proposal and takes at most 0.6x the target
steps), EOS inside a window, the token budget, seeded streams
repeatable, the ``auto`` fallback, ``MXNET_SERVE_SPEC=0``, the registry's
refusals, and the int8 pool.
"""
import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from mxnet_tpu.models.transformer_lm import lm_spec, random_params
from mxnet_tpu.serving import GenerationEngine as JaxEngine
from mxnet_tpu.serving import ModelRegistry as JaxRegistry
from mxnet_tpu.serving import program_store as jax_store
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (GenerationEngine,
                                     GenerativeProgramStore, ModelRegistry)
from mxnet_tpu_torch.serving import decode_engine, program_store

SPEC = lm_spec(num_layers=2, num_hidden=32, num_heads=4, vocab_size=50)
PARAMS = random_params(SPEC, seed=3)
DSPEC = lm_spec(num_layers=1, num_hidden=16, num_heads=2, vocab_size=50)
DPARAMS = random_params(DSPEC, seed=7)

KW = dict(batch_buckets=(1, 2, 4), prompt_buckets=(4, 8, 24),
          kv_block=8, kv_max=64, paged=True, prefill_chunk=8)

REQS = [dict(tokens=[7, 3, 11, 29, 4], max_tokens=12, seed=1),
        dict(tokens=[7, 3, 11, 29, 4], max_tokens=9, seed=2),
        dict(tokens=[2, 5], max_tokens=14, seed=3),
        dict(tokens=[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], max_tokens=7,
             seed=4)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its tests make thousands of
    tiny torch ops, and under a parallel run (several workers on the
    same cores) handing each op to a team of threads costs many times
    the op.  Restored when the module ends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(draft, kv_dtype="float32", temp=0.0, reqs=REQS, spec_k=3,
         **submit_kw):
    """One port engine lifecycle on the CPU: register, attach a draft
    (``"self"``: the target's weights, ``"rand"``: the small random LM)
    or none, generate; returns (streams, stats)."""
    reg = ModelRegistry()
    reg.add_generative_model("m", PARAMS, SPEC, kv_dtype=kv_dtype,
                             device="cpu", **KW)
    if draft == "self":
        reg.add_draft_model("m", PARAMS, SPEC, spec_k=spec_k)
    elif draft == "rand":
        reg.add_draft_model("m", DPARAMS, DSPEC, spec_k=spec_k)
    eng = GenerationEngine(reg)
    try:
        futs = [eng.submit("m", temperature=temp, **submit_kw, **kw)
                for kw in reqs]
        toks = [f.result(120).tokens for f in futs]
        st = eng.stats()
    finally:
        eng.close()
    return toks, st


@pytest.fixture(scope="module")
def jax_base():
    """The JAX engine's non-speculative greedy streams of REQS, once."""
    reg = JaxRegistry()
    reg.add_generative_model("m", PARAMS, SPEC, sample="graph", warmup=False,
                             **KW)
    eng = JaxEngine(reg)
    try:
        futs = [eng.submit("m", **kw) for kw in REQS]
        return [f.result(180).tokens for f in futs]
    finally:
        eng.close()


@pytest.fixture(scope="module")
def runs():
    """The port's greedy runs: no draft, a random draft, a self-draft."""
    return {tag: _run(d) for tag, d in
            (("base", None), ("rand", "rand"), ("self", "self"))}


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_spec_verify_greedy_bit_equal_to_jax(K):
    """Greedy rows: out_toks[:n_emit] and n_emit equal the reference's for
    every ``valid`` from 1 to K+1 crossed with every first mismatch
    (0..K-1, or none), on seeded logits."""
    V = 11
    rs = np.random.RandomState(K)
    valid, miss = (a.ravel().astype(np.int32) for a in np.meshgrid(
        np.arange(1, K + 2), np.arange(K + 1), indexing="ij"))
    B = len(valid)
    logits = rs.randn(B, K + 1, V).astype(np.float32)
    props = np.argmax(logits, -1)[:, :K].astype(np.int32)
    for b in range(B):
        if miss[b] < K:
            props[b, miss[b]] = (props[b, miss[b]] + 1 +
                                 rs.randint(V - 1)) % V
    zeros = np.zeros(B, np.float32)
    want_out, want_ne, _ = jax.jit(jax_store.spec_verify)(
        jnp.asarray(logits), jnp.asarray(props),
        jnp.zeros((B, K, V), jnp.float32), jnp.zeros((B, 2), jnp.uint32),
        jnp.asarray(zeros), jnp.zeros((B,), jnp.int32), jnp.asarray(valid))
    got_out, got_ne = program_store.spec_verify(
        torch.from_numpy(logits), torch.from_numpy(props),
        torch.zeros((B, K, V)), [None] * B, zeros, np.zeros(B, np.int32),
        valid)
    want_ne = np.asarray(want_ne)
    assert got_ne.dtype == got_out.dtype == torch.int32
    assert got_ne.numpy().tolist() == want_ne.tolist()
    assert want_ne.tolist() == np.minimum(valid, miss + 1).tolist()
    for b in range(B):
        n = want_ne[b]
        assert got_out[b, :n].tolist() == np.asarray(want_out)[b, :n].tolist()


def test_masked_dist_matches_jax():
    rs = np.random.RandomState(5)
    logits = (rs.randn(8, 50) * 3).astype(np.float32)
    logits[3, 7] = logits[3, 9] = logits[3].max() + 1    # a tie at the top
    temps = np.float32([0.0, 0.5, 1.0, 1.3, 0.8, 2.0, -1.0, 0.7])
    top_ks = np.int32([0, 0, 3, 1, 50, 60, 5, 7])
    want = np.asarray(jax_store._masked_dist(jnp.asarray(logits),
                                             jnp.asarray(temps),
                                             jnp.asarray(top_ks)))
    got = program_store._masked_dist(torch.from_numpy(logits), temps,
                                     top_ks)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _pooled_chi2(counts, p, n):
    """Chi-square p-value of ``counts`` against ``n * p``, the bins of an
    expected count below 5 pooled into one."""
    exp = n * p
    big = exp >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(exp[big], exp[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    return stats.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue


def test_spec_verify_sampled_follows_the_target_density():
    """With proposals drawn from the draft density q, the first emitted
    token follows the target's density p (accept or corrected resample)
    and the token after an accepted proposal follows the next row's p:
    chi-square p-values above 1e-3 over 8192 rows, each with its own
    generator; both the accept and the reject paths taken."""
    V, K, B = 13, 3, 8192
    rs = np.random.RandomState(1)
    t_row = rs.randn(K + 1, V).astype(np.float32) * 1.5
    q_row = t_row[:K] + rs.randn(K, V).astype(np.float32)
    ones, zk = np.ones(K + 1, np.float32), np.zeros(K + 1, np.int32)
    q_dist = program_store._masked_dist(torch.from_numpy(q_row), ones[:K],
                                        zk[:K]).numpy().astype(np.float64)
    p = program_store._masked_dist(torch.from_numpy(t_row), ones,
                                   zk).numpy().astype(np.float64)
    props = np.stack([rs.choice(V, B, p=q_dist[j] / q_dist[j].sum())
                      for j in range(K)], axis=1).astype(np.int32)
    gens = [torch.Generator().manual_seed(100 + b) for b in range(B)]
    out, ne = program_store.spec_verify(
        torch.from_numpy(np.broadcast_to(t_row, (B, K + 1, V)).copy()),
        torch.from_numpy(props),
        torch.from_numpy(np.broadcast_to(q_dist, (B, K, V)).astype(
            np.float32)), gens, np.ones(B, np.float32),
        np.zeros(B, np.int32), np.full(B, K + 1, np.int32))
    out, ne = out.numpy(), ne.numpy()
    assert _pooled_chi2(np.bincount(out[:, 0], minlength=V), p[0],
                        B) > 1e-3
    acc0 = (ne >= 2) & (out[:, 0] == props[:, 0])
    assert _pooled_chi2(np.bincount(out[acc0, 1], minlength=V), p[1],
                        acc0.sum()) > 1e-3
    hist = np.bincount(ne, minlength=K + 2)
    assert hist[1] > 0 and hist[K + 1] > 0 and hist[0] == 0


def test_sample_tokens_p_draws_what_sample_tokens_draws():
    rs = np.random.RandomState(2)
    logits = torch.from_numpy(rs.randn(4, 50).astype(np.float32))
    temps = np.float32([0.0, 0.8, 1.2, 0.5])
    top_ks = np.int32([0, 5, 0, 1])
    do = np.array([True, True, False, True])

    def gens():
        return [torch.Generator().manual_seed(s) for s in (1, 2, 3, 4)]
    want = program_store.sample_tokens(logits, temps, top_ks, gens(), do)
    got, q = program_store.sample_tokens_p(logits, temps, top_ks, gens(), do)
    assert torch.equal(got, want)
    assert torch.equal(q, program_store._masked_dist(logits, temps, top_ks))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def test_spec_greedy_streams_equal_jax_non_speculative(runs, jax_base):
    assert runs["base"][0] == jax_base
    assert runs["self"][0] == jax_base
    assert runs["rand"][0] == jax_base


def test_spec_counters_and_steps_per_token(runs):
    base, selfd, rand = (runs[k][1] for k in ("base", "self", "rand"))
    assert base["spec_steps"] == base["spec_proposed"] == 0
    assert selfd["spec_proposed"] > 0
    assert selfd["spec_accepted"] == selfd["spec_proposed"]
    assert selfd["spec_steps"] == selfd["decode_steps"]
    assert selfd["decode_steps"] <= 0.6 * base["decode_steps"]
    assert selfd["generated_tokens"] == base["generated_tokens"]
    assert rand["decode_steps"] <= base["decode_steps"]
    assert rand["spec_draft_steps"] >= rand["spec_proposed"]
    d = selfd["models"]["m"]
    assert d["spec_k"] == 3
    assert d["draft_pool_bytes"] == base["models"]["m"]["pool_bytes"]


def test_spec_greedy_on_a_sharper_model():
    """REQS' streams repeat one or two tokens; with every matrix weight
    scaled by 10 they wander, and a rejection then has to roll the
    frontier back mid-stream: the self-draft still accepts every
    proposal and both drafts keep the non-speculative streams."""
    sharp = {k: v * 10 if "weight" in k else v for k, v in PARAMS.items()}
    streams = {}
    for tag, draft in (("base", None), ("self", (sharp, SPEC)),
                       ("rand", (DPARAMS, DSPEC))):
        reg = ModelRegistry()
        reg.add_generative_model("m", sharp, SPEC, device="cpu", **KW)
        if draft is not None:
            reg.add_draft_model("m", *draft, spec_k=3)
        with GenerationEngine(reg) as eng:
            futs = [eng.submit("m", **kw) for kw in REQS]
            streams[tag] = [f.result(120).tokens for f in futs]
            st = eng.stats()
        if tag == "self":
            assert st["spec_accepted"] == st["spec_proposed"] > 0
    assert len({t for s in streams["base"] for t in s}) >= 4
    assert streams["self"] == streams["base"] == streams["rand"]


def test_spec_prefix_sharing_forks_both_planes():
    """A prompt served again adopts the first run's blocks from the prefix
    cache (a 12-token prompt: one full block and a partial tail of 4,
    whose first window write must fork it): the draft plane forks with
    the target's, so the self-draft still accepts every proposal, and
    the streams equal the non-speculative engine's."""
    sharp = {k: v * 10 if "weight" in k else v for k, v in PARAMS.items()}
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]
    streams, stats = {}, {}
    for tag, draft in (("base", None), ("self", (sharp, SPEC))):
        reg = ModelRegistry()
        reg.add_generative_model("m", sharp, SPEC, device="cpu", **KW)
        if draft is not None:
            reg.add_draft_model("m", *draft, spec_k=3)
        with GenerationEngine(reg) as eng:
            first = eng.submit("m", prompt, max_tokens=10).result(120).tokens
            again = [eng.submit("m", prompt, max_tokens=mt)
                     for mt in (10, 13)]
            streams[tag] = [first] + [f.result(120).tokens for f in again]
            stats[tag] = eng.stats()
    st = stats["self"]
    assert streams["self"] == streams["base"]
    assert streams["self"][0] == streams["self"][1]
    assert st["prefix_hits"] == 2 and st["cow_forks"] >= 2
    assert st["spec_accepted"] == st["spec_proposed"] > 0


def test_spec_tick_fetches_once(monkeypatch):
    """No value crosses to the host during the draft's micro-steps, and a
    speculative tick makes one fetch (the emitted tokens with their
    counts)."""
    names = ("cpu", "item", "numpy", "tolist")
    calls = {tag: dict.fromkeys(names, 0) for tag in ("propose", "tick")}
    where = []
    for name in names:
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            if where:
                calls[where[-1]][_name] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    for meth, tag in (("_spec_propose", "propose"), ("_spec_step", "tick")):
        orig = getattr(GenerationEngine, meth)

        def inside(self, *a, _orig=orig, _tag=tag):
            where.append(_tag)
            try:
                return _orig(self, *a)
            finally:
                where.pop()
        monkeypatch.setattr(GenerationEngine, meth, inside)
    _, st = _run("self", temp=0.8)
    n = st["spec_steps"]
    assert n > 0
    assert calls == {"propose": dict.fromkeys(names, 0),
                     "tick": dict(cpu=n, item=0, numpy=n, tolist=0)}


def test_spec_seeded_repeatable_and_budgeted():
    """Sampled speculative streams are a function of the seeds, and every
    stream stops at its max_tokens."""
    a, st = _run("self", temp=0.8)
    b, _ = _run("self", temp=0.8)
    assert a == b
    assert st["spec_proposed"] > 0
    for toks, kw in zip(a, REQS):
        assert len(toks) == kw["max_tokens"]


def test_spec_budget_clamps_the_window():
    """max_tokens 2 and 3 leave windows of 0 and 1 proposals on the first
    tick: nothing is proposed past the budget."""
    reqs = [dict(tokens=[7, 3, 11, 29, 4], max_tokens=2, seed=1),
            dict(tokens=[2, 5], max_tokens=3, seed=2)]
    base, _ = _run(None, reqs=reqs)
    spec, st = _run("self", reqs=reqs)
    assert spec == base
    assert [len(t) for t in spec] == [2, 3]
    assert st["spec_proposed"] == 0 + 1


def test_spec_eos_mid_window(runs):
    """An accepted proposal equal to eos_id ends the request inside the
    window; the rest of the window is dropped."""
    req = [REQS[2]]
    free = runs["base"][0][2]
    eos = free[0]
    base, _ = _run(None, reqs=req, eos_id=eos)
    spec, st = _run("self", reqs=req, eos_id=eos, spec_k=4)
    assert spec == base == [free[:1]]
    assert spec[0][-1] == eos


def test_spec_auto_falls_back_and_probes(monkeypatch):
    """``auto`` with the floor raised past what the random draft reaches:
    the engine falls back to plain decode steps, probes (a catch-up
    rebuilds the lagging draft KV), and the streams stay the
    non-speculative ones; ``force`` keeps drafting."""
    monkeypatch.setattr(decode_engine, "_SPEC_EMA_FLOOR", 0.9)
    monkeypatch.setattr(decode_engine, "_SPEC_PROBE_EVERY", 3)
    reqs = [dict(tokens=[7, 3, 11, 29, 4], max_tokens=30, seed=1),
            dict(tokens=[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], max_tokens=20,
                 seed=4)]
    base, _ = _run(None, reqs=reqs)
    spec, st = _run("rand", reqs=reqs)
    assert spec == base
    assert st["spec_fallback_steps"] > 0
    assert st["spec_steps"] > 1                  # probes fired
    assert st["models"]["m"]["spec_acceptance_ema"] < 0.9
    monkeypatch.setenv("MXNET_SERVE_SPEC", "force")
    forced, fst = _run("rand", reqs=reqs)
    assert forced == base
    assert fst["spec_fallback_steps"] == 0
    assert fst["spec_steps"] > st["spec_steps"]


def test_spec_env_off(monkeypatch, runs):
    monkeypatch.setenv("MXNET_SERVE_SPEC", "0")
    spec, st = _run("self")
    assert spec == runs["base"][0]
    assert st["spec_steps"] == st["spec_draft_steps"] == 0
    assert "spec_k" not in st["models"]["m"]


def test_registry_refusals_and_warm_sets():
    store = GenerativeProgramStore(PARAMS, SPEC, batch_buckets=(1, 2),
                                   prompt_buckets=(8,), kv_block=8,
                                   kv_max=24, paged=True, prefill_chunk=8,
                                   device="cpu")
    assert set(store.warm_spec_programs(2)) == {
        ("paged_verify", 1, 3), ("paged_verify", 2, 3)}
    assert set(store.warm_spec_programs(2, draft=True)) == {
        ("paged_step_sample_p", 1, 1), ("paged_step_sample_p", 2, 1),
        ("paged_step", 1, 8), ("paged_step", 2, 8)}
    contig = GenerativeProgramStore(PARAMS, SPEC, batch_buckets=(1,),
                                    prompt_buckets=(8,), kv_block=8,
                                    kv_max=24, paged=False, device="cpu")
    for call in (lambda: contig.warm_spec_programs(2),
                 lambda: contig.run_paged_verify(*[None] * 11),
                 lambda: contig.run_paged_step_sample_p(*[None] * 10)):
        with pytest.raises(MXNetError):
            call()
    reg = ModelRegistry()
    reg.add_generative_model("c", PARAMS, SPEC, batch_buckets=(1,),
                             prompt_buckets=(8,), kv_block=8, kv_max=24,
                             paged=False, warmup=False, device="cpu")
    with pytest.raises(MXNetError):
        reg.add_draft_model("c", DPARAMS, DSPEC)
    reg.add_generative_model("m", PARAMS, SPEC, warmup=False, device="cpu",
                             **KW)
    with pytest.raises(MXNetError):
        reg.add_draft_model("m", DPARAMS, DSPEC, spec_k=0)
    with pytest.raises(MXNetError):
        reg.add_draft_model("m", random_params(
            lm_spec(1, 16, 2, 40), seed=1), lm_spec(1, 16, 2, 40))
    d = reg.add_draft_model("m", DPARAMS, DSPEC, spec_k=2)
    assert reg.draft_store("m") is d and d.spec_k == 2
    target = reg.gen_store("m")
    for attr in ("kv_block", "kv_max", "pool_blocks", "prefill_chunk",
                 "kv_dtype", "paged", "device"):
        assert getattr(d, attr) == getattr(target, attr), attr
    assert d.stats()["batch_buckets"] == target.stats()["batch_buckets"]
    with pytest.raises(MXNetError):
        reg.add_draft_model("m", DPARAMS, DSPEC, warmup=False)
    reg.remove_model("m")
    assert reg.draft_store("m") is None


def test_add_draft_model_takes_the_draft_off_when_warmup_fails(
        monkeypatch):
    reg = ModelRegistry()
    reg.add_generative_model("m", PARAMS, SPEC, warmup=False, device="cpu",
                             **KW)

    def boom(self, spec_k, draft=False):
        raise RuntimeError("warmup failed")
    monkeypatch.setattr(GenerativeProgramStore, "warm_spec_programs", boom)
    with pytest.raises(RuntimeError):
        reg.add_draft_model("m", DPARAMS, DSPEC)
    assert reg.draft_store("m") is None


def test_spec_int8_greedy_and_draft_pool_bytes():
    base8, bst = _run(None, kv_dtype="int8")
    spec8, sst = _run("self", kv_dtype="int8")
    assert spec8 == base8
    assert sst["spec_accepted"] == sst["spec_proposed"] > 0
    d = sst["models"]["m"]
    assert d["cache_dtype"] == "int8"
    assert d["draft_pool_bytes"] == d["pool_bytes"] == \
        bst["models"]["m"]["pool_bytes"]
