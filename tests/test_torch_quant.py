"""The port's int8 serving plane against the JAX package's, on the CPU.

int8 weights: the codec's codes and scales are the same bits as the
reference's, ``quantize_lm_params`` quantizes the same names, and the
plain ``dequant_matmul`` matches the reference's dense twin and its
Pallas kernel in interpret mode.  int8 KV: the plain int8 paged
attention matches ``paged_attention_reference(kv_scales=)``, the block
requantization gives the reference's codes and scales bit for bit from
identical fresh K/V rows, and whole paged steps agree.  The int8 engine
gives the reference engine's greedy streams, weight bytes and pool
bytes.  Sizes are those of ``tests/test_torch_serving.py``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.pallas_ops.flash_attention import pltpu
from mxnet_tpu.pallas_ops.paged_attention import (
    flash_attention_paged as jax_flash_attention_paged,
    paged_attention_reference as jax_paged_attention_reference)
from mxnet_tpu.serving import GenerationEngine as JaxEngine
from mxnet_tpu.serving import ModelRegistry as JaxRegistry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import dequant_matmul as dq
from mxnet_tpu_torch.kernels import paged_attention
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.serving import GenerationEngine, ModelRegistry
from test_torch_cuda import paged_case

jlm = importlib.import_module("mxnet_tpu.models.transformer_lm")
jdq = importlib.import_module("mxnet_tpu.pallas_ops.dequant_matmul")

SPEC = tlm.lm_spec(num_layers=2, num_hidden=32, num_heads=4, vocab_size=50)
PARAMS = tlm.random_params(SPEC, seed=3)
KW = dict(batch_buckets=(1, 2, 4), prompt_buckets=(4, 8, 24), kv_block=8,
          kv_max=40, prefill_chunk=8, compute_dtype="int8", kv_dtype="int8")
BS, NB, T = 8, 16, 5
MARGIN = 1e-5   # a differing greedy token must sit on a near tie


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


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# codec and dequant-matmul
# ---------------------------------------------------------------------------
def _weights(seed, n, k):
    w = np.random.RandomState(seed).randn(n, k).astype(np.float32)
    w[1] = 0.0           # an all-zero row gets scale 1
    w[2, :3] = [0.5, -0.5, 1.5]
    return w


@pytest.mark.parametrize("granularity", ["row", "tensor"])
@pytest.mark.parametrize("n,k", [(9, 16), (33, 48), (64, 512)])
def test_quantize_int8_bit_identical_to_jax(granularity, n, k):
    w = _weights(n + k, n, k)
    codes, scales = dq.quantize_int8(w, granularity)
    jc, js = jdq.quantize_int8(w, granularity)
    assert codes.dtype == np.int8 and scales.dtype == np.float32
    assert np.array_equal(codes, jc) and np.array_equal(scales, js)
    assert scales.shape == np.shape(js)
    assert np.array_equal(dq.dequantize_int8(codes, scales),
                          np.asarray(jdq.dequantize_int8(jc, js)))
    qw = dq.QuantizedWeight(*_t(codes, scales))
    assert qw.shape == (n, k) and qw.dtype == torch.int8
    assert np.array_equal(qw.dequantize().numpy(),
                          dq.dequantize_int8(codes, scales))


def test_scale_granularity_knob(monkeypatch):
    w = _weights(0, 5, 16)
    monkeypatch.setenv("MXNET_SERVE_INT8_GRANULARITY", "tensor")
    assert dq.scale_granularity() == "tensor"
    assert np.shape(dq.quantize_int8(w)[1]) == ()
    monkeypatch.setenv("MXNET_SERVE_INT8_GRANULARITY", "col")
    with pytest.raises(MXNetError, match="row"):
        dq.quantize_int8(w)
    with pytest.raises(MXNetError, match="2D"):
        dq.quantize_int8(np.zeros((2, 2, 2)))


def test_quantize_lm_params_matches_jax():
    got = tlm.quantize_lm_params(PARAMS, SPEC)
    want = jlm.quantize_lm_params(PARAMS, SPEC)
    quant = {k for k, v in got.items()
             if isinstance(v, dq.QuantizedWeight)}
    assert quant == set(tlm.lm_matmul_weights(SPEC)) == \
        {k for k, v in want.items() if isinstance(v, jdq.QuantizedWeight)}
    assert sorted(got) == sorted(PARAMS)
    for k in quant:
        assert np.array_equal(got[k].codes.numpy(), want[k].codes)
        assert np.array_equal(got[k].scales.numpy(), want[k].scales)
    for k in set(PARAMS) - quant:
        assert got[k] is PARAMS[k]


@pytest.mark.parametrize("granularity", ["row", "tensor"])
@pytest.mark.parametrize("m,n,k", [(1, 8, 16), (7, 24, 48), (32, 64, 128),
                                   (5, 50, 32)])
def test_dequant_matmul_plain_matches_jax(granularity, m, n, k):
    rs = np.random.RandomState(m * n + k)
    x = rs.randn(m, k).astype(np.float32)
    codes, scales = dq.quantize_int8(_weights(n, n, k), granularity)
    got = dq.dequant_matmul(*_t(x, codes, scales)).numpy()
    dense = np.asarray(jdq.dequant_matmul_dense(x, codes, scales))
    tol = 1e-5 * np.abs(dense).max()
    assert got.shape == (m, n) and got.dtype == np.float32
    assert np.abs(got - dense).max() <= tol
    kern = np.asarray(jdq._dqmm_pallas(jnp.asarray(x), codes, scales, 8, 8,
                                       8, interpret=True))
    assert np.abs(got - kern).max() <= tol


def test_dequant_matmul_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(2, 24)
    codes = torch.zeros(4, 24, dtype=torch.int8)
    s = torch.ones(4)
    with pytest.raises(ValueError, match="multiple of 16"):
        dq._check(x, codes, s)
    x, codes = torch.zeros(2, 32), torch.zeros(4, 32, dtype=torch.int8)
    dq._check(x, codes, s)
    with pytest.raises(ValueError, match="int8"):
        dq._check(x, codes.float(), s)
    with pytest.raises(ValueError, match="contiguous"):
        dq._check(torch.zeros(32, 2).t(), codes, s)
    with pytest.raises(ValueError, match="no kernel"):
        dq.dequant_matmul(x.to("meta"), codes.to("meta"), s.to("meta"))


# ---------------------------------------------------------------------------
# int8 paged attention
# ---------------------------------------------------------------------------
def _int8_case(seed, lq, positions, D=16):
    """paged_case's layout over int8 code pools whose scales vary per
    (head, block)."""
    q, _, _, tbl, pos = paged_case(seed, B=3, H=2, T=4, D=D, bs=8,
                                   num_blocks=12, positions=positions, lq=lq)
    rs = np.random.RandomState(seed + 50)
    kc, vc = (rs.randint(-127, 128, (2, 12 * 8, D)).astype(np.int8)
              for _ in range(2))
    sk, sv = (rs.uniform(0.001, 0.05, (2, 12)).astype(np.float32)
              for _ in range(2))
    return q, kc, vc, tbl, pos, sk, sv


@pytest.mark.parametrize("seed,lq,positions", [(0, 1, [5, 9, 17]),
                                               (1, 4, [0, 3, 12]),
                                               (2, 8, [8, 1, 15])])
def test_int8_paged_plain_matches_jax(seed, lq, positions):
    q, kc, vc, tbl, pos, sk, sv = _int8_case(seed, lq, positions)
    tq, tk, tv, tt, tp, tsk, tsv = _t(q, kc, vc, tbl, pos, sk, sv)
    got = paged_attention.flash_attention_paged(
        tq, tk, tv, tt, tp, 8, kv_scales=(tsk, tsv)).numpy()
    want = np.asarray(jax_paged_attention_reference(
        q, kc, vc, tbl, pos, 8, kv_scales=(sk, sv)))
    tol = 1e-5 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    if pltpu is not None:
        kern = np.asarray(jax_flash_attention_paged(
            q, kc, vc, tbl, pos, 8, block_q=4, interpret=True,
            kv_scales=(sk, sv)))
        assert np.abs(got - kern).max() <= tol


def test_int8_paged_kernel_argument_checks():
    q, kc, vc, tbl, pos, sk, sv = _t(*_int8_case(0, 1, [5, 9, 17]))
    check = paged_attention._check
    check(q, kc, vc, tbl, pos, 8, (sk, sv))
    with pytest.raises(ValueError, match="int8"):
        check(q, kc.float(), vc.float(), tbl, pos, 8, (sk, sv))
    with pytest.raises(ValueError, match="num_blocks"):
        check(q, kc, vc, tbl, pos, 8, (sk[:, :5].contiguous(),
                                       sv[:, :5].contiguous()))
    q8, kc8, vc8, tbl8, pos8, sk8, sv8 = _t(*_int8_case(0, 1, [5, 9, 17],
                                                       D=8))
    with pytest.raises(ValueError, match="multiple of 16"):
        check(q8, kc8, vc8, tbl8, pos8, 8, (sk8, sv8))
    with pytest.raises(ValueError, match="no kernel"):
        paged_attention.flash_attention_paged(
            q.to("meta"), kc, vc, tbl, pos, 8, kv_scales=(sk, sv))


# ---------------------------------------------------------------------------
# block requantization and whole int8 steps
# ---------------------------------------------------------------------------
def _steps():
    """A prefill chunk that straddles block edges, with pad rows and a
    sequence whose fresh rows will be all zero, then two decode steps."""
    tables = np.zeros((3, T), np.int32)
    tables[0, :3] = [1, 2, 3]
    tables[1, :3] = [4, 5, 6]
    tables[2, :2] = [7, 8]
    chunk = dict(tokens=np.random.RandomState(0).randint(
        0, 50, (3, 8)).astype(np.int32),
        positions=np.array([5, 0, 3], np.int32),
        valid=np.array([8, 6, 8], np.int32))
    steps = [chunk]
    pos = chunk["positions"] + chunk["valid"]
    for i in range(2):
        steps.append(dict(tokens=np.array([[7 + i], [3], [11]], np.int32),
                          positions=pos + i, valid=np.ones(3, np.int32)))
    return tables, steps


def _fresh_mm(monkeypatch, module, params, wrap, fresh):
    """Make ``module._mm`` return the next array of ``fresh[name]`` for
    the K/V weights of ``params`` (looked up by identity), the real
    product otherwise."""
    real = module._mm
    names = {id(v): k for k, v in params.items()}

    def fake(x, w):
        name = names.get(id(w))
        if name in fresh:
            return wrap(fresh[name].pop(0))
        return real(x, w)

    monkeypatch.setattr(module, "_mm", fake)


def _jax_paged_steps(params, tables, steps, fresh=None):
    """The reference's ``paged_step_apply`` over ``steps`` on int8
    pools, each step one compiled program with XLA's algebraic
    simplifier off: no rewrite of its arithmetic (a division by a
    constant into a product by its reciprocal), so the program computes
    what the op-by-op eager reference computes, bit for bit (checked on
    these steps), at one compile a step shape in place of one a
    primitive and shape.  ``fresh``: the K/V projections' rows a step
    (name -> list), fed in place of the products.  Returns each step's
    logits and its pools and scales after it."""
    real = jlm._mm
    names = {id(v): k for k, v in params.items()}

    def step(jk, jv, jsk, jsv, tokens, positions, valid, rows):
        def mm(x, w):
            name = names.get(id(w))
            return rows[name] if name in rows else real(x, w)

        jlm._mm = mm
        try:
            return jlm.paged_step_apply(params, jk, jv, tables, tokens,
                                        positions, valid, SPEC, BS,
                                        scales=(jsk, jsv))
        finally:
            jlm._mm = real

    jk, jv = jlm.init_pool(SPEC, NB, BS, dtype="int8")
    jsk, jsv = jlm.init_scale_pool(SPEC, NB)
    programs, out = {}, []
    for i, st in enumerate(steps):
        args = (jk, jv, jsk, jsv, st["tokens"], st["positions"],
                st["valid"], {k: v[i] for k, v in (fresh or {}).items()})
        key = st["tokens"].shape
        if key not in programs:
            programs[key] = jax.jit(step).lower(*args).compile(
                compiler_options={"xla_disable_hlo_passes": "algsimp"})
        lg, jk, jv, jsk, jsv = programs[key](*args)
        out.append((np.asarray(lg), (jk, jv, jsk, jsv)))
    return out


def test_requant_bit_identical_to_jax(monkeypatch):
    """Identical fresh K/V rows in both packages (each K/V projection
    replaced by the same arrays): codes and scales of every block but
    the trash block are the same bits after a chunk that straddles block
    edges, with pad rows, and two decode steps."""
    tables, steps = _steps()
    rs = np.random.RandomState(9)
    fresh = {}
    for i in range(SPEC["num_layers"]):
        for w in ("k", "v"):
            rows = []
            for st in steps:
                B, Lq = st["tokens"].shape
                a = (rs.randn(B * Lq, SPEC["num_hidden"]) *
                     rs.uniform(0.1, 3)).astype(np.float32)
                a[Lq:2 * Lq] = 0.0     # sequence 1 writes only zeros
                rows.append(a)
            fresh["blk%d_%s_weight" % (i, w)] = rows
    copy = {k: [a.copy() for a in v] for k, v in fresh.items()}

    _, (jk, jv, jsk, jsv) = _jax_paged_steps(PARAMS, tables, steps,
                                             fresh)[-1]

    tparams = {k: torch.from_numpy(v) for k, v in PARAMS.items()}
    _fresh_mm(monkeypatch, tlm, tparams, torch.from_numpy, copy)
    pk, pv = tlm.init_pool(SPEC, NB, BS, dtype=torch.int8)
    sk, sv = tlm.init_scale_pool(SPEC, NB)
    for st in steps:
        out = tlm.paged_step_apply(tparams, pk, pv, tables, st["tokens"],
                                   st["positions"], st["valid"], SPEC, BS,
                                   scales=(sk, sv))
        assert out[1] is pk and out[3] is sk     # updated in place
    assert not any(copy.values())
    rows = slice(BS, None)             # every block but the trash block 0
    for got, want in ((pk, jk), (pv, jv)):
        assert got.dtype == torch.int8
        assert np.array_equal(got.numpy()[:, :, rows],
                              np.asarray(want)[:, :, rows])
    for got, want in ((sk, jsk), (sv, jsv)):
        assert np.array_equal(got.numpy()[:, :, 1:],
                              np.asarray(want)[:, :, 1:])
    # sequence 1's block held only zeros: scale 1, codes 0
    assert (sk.numpy()[:, :, 4] == 1.0).all()
    assert not pk.numpy()[:, :, 4 * BS:5 * BS].any()
    assert pk.numpy()[:, :, BS:4 * BS].any()


def _jax_int8_params():
    return jlm.quantize_lm_params(PARAMS, SPEC)


def test_int8_paged_step_matches_jax():
    """int8 weights and int8 KV through a chunk and two decode steps:
    logits within 1e-4 x max|ref|, scales within 1e-6 relative, codes
    equal but where a fresh value sits on a rounding edge (off by one,
    in at most 0.1% of the entries)."""
    tables, steps = _steps()
    jparams = _jax_int8_params()
    model = tlm.TransformerLM.from_numpy(
        {k: (v.codes, v.scales) if isinstance(v, jdq.QuantizedWeight)
         else v for k, v in jparams.items()}, SPEC, device="cpu")
    pk, pv = tlm.init_pool(SPEC, NB, BS, dtype=torch.int8)
    sk, sv = tlm.init_scale_pool(SPEC, NB)
    for st, (jl, (jk, jv, jsk, jsv)) in zip(
            steps, _jax_paged_steps(jparams, tables, steps)):
        tl = model(pk, pv, tables, st["tokens"], st["positions"],
                   st["valid"], BS, scales=(sk, sv))[0]
        assert np.abs(tl.numpy() - jl).max() <= 1e-4 * np.abs(jl).max()
        for got, want in ((sk, jsk), (sv, jsv)):
            want = np.asarray(want)[:, :, 1:]
            assert np.abs(got.numpy()[:, :, 1:] - want).max() <= \
                1e-6 * np.abs(want).max()
        for got, want in ((pk, jk), (pv, jv)):
            diff = np.abs(got.numpy()[:, :, BS:].astype(np.int32) -
                          np.asarray(want)[:, :, BS:].astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


# ---------------------------------------------------------------------------
# the int8 engine
# ---------------------------------------------------------------------------
def _requests():
    """test_torch_serving's stream set: five prompts, then a prompt, a
    prompt diverging in its tail and the first prompt again (prefix
    hits and copy-on-write forks of int8 blocks)."""
    rs = np.random.RandomState(0)
    reqs = [dict(tokens=[int(t) for t in rs.randint(0, 50, n)],
                 max_tokens=mt)
            for n, mt in ((3, 10), (8, 6), (12, 20), (5, 30), (17, 8))]
    P = [int(t) for t in np.random.RandomState(3).randint(0, 50, 12)]
    Pdiv = P[:10] + [(P[10] + 1) % 50, (P[11] + 3) % 50]
    return reqs + [dict(tokens=P, max_tokens=6),
                   dict(tokens=Pdiv, max_tokens=6),
                   dict(tokens=P, max_tokens=6)]


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
    tokens``, replayed for one sequence: the prompt in prefill chunks of
    KW's size, then one decode step per token (the engine's schedule)."""
    jparams = _jax_int8_params()
    tb = -(-KW["kv_max"] // BS)
    pk, pv = jlm.init_pool(SPEC, tb + 1, BS, dtype="int8")
    sk, sv = jlm.init_scale_pool(SPEC, tb + 1)
    tables = np.arange(1, tb + 1, dtype=np.int32)[None]
    chunk = KW["prefill_chunk"]
    feeds = [(prompt[p0:p0 + chunk], p0)
             for p0 in range(0, len(prompt), chunk)]
    feeds += [([t], len(prompt) + i) for i, t in enumerate(tokens)]
    for toks, p0 in feeds:
        logits, pk, pv, sk, sv = jlm.paged_step_apply(
            jparams, pk, pv, tables, np.asarray([toks], np.int32),
            np.asarray([p0], np.int32), np.asarray([len(toks)], np.int32),
            SPEC, BS, scales=(sk, sv))
    top = np.sort(np.asarray(logits)[0])[::-1]
    return float(top[0] - top[1])


def _assert_streams_agree(got, want, reqs, margin_fn):
    for kw, a, b in zip(reqs, got, want):
        if a == b:
            continue
        k = next(j for j in range(min(len(a), len(b))) if a[j] != b[j])
        assert margin_fn(kw["tokens"], b[:k]) < MARGIN, \
            "stream differs at step %d where the reference is not at a " \
            "near tie" % k


@pytest.fixture(scope="module")
def jax_int8():
    reg = JaxRegistry()
    reg.add_generative_model("m", PARAMS, SPEC, paged=True, **KW)
    return {serial: _serve(JaxEngine(reg), _requests(), serial) +
            (reg.gen_store("m").stats(),) for serial in (False, True)}


@pytest.mark.parametrize("serial", [False, True])
def test_int8_engine_streams_and_bytes_match_jax(jax_int8, serial):
    want, jstats, jstore = jax_int8[serial]
    reg = ModelRegistry()
    store = reg.add_generative_model("m", PARAMS, SPEC, device="cpu", **KW)
    got, stats = _serve(GenerationEngine(reg), _requests(), serial)
    _assert_streams_agree(got, want, _requests(), _jax_margin)
    assert [len(t) for t in got] == [len(t) for t in want]
    st = store.stats()
    assert st["compute_dtype"] == jstore["compute_dtype"] == "int8"
    assert st["kv_dtype"] == jstore["kv_dtype"] == "int8"
    assert st["weight_bytes"] == jstore["weight_bytes"]
    desc = stats["models"]["m"]
    jdesc = jstats["models"]["m"]
    for key in ("pool_bytes", "block_bytes", "pool_bytes_per_token",
                "cache_dtype"):
        assert desc[key] == jdesc[key], key
    if serial:   # the re-prompts hit the prefix cache and fork blocks
        assert stats["prefix_hits"] == jstats["prefix_hits"] >= 2
        assert stats["cow_forks"] == jstats["cow_forks"] >= 1


def test_int8_pool_bytes_per_token_against_fp32():
    """The reference's banked gate: an int8 pool holds a token in at
    most 0.3x the bytes of an fp32 pool, its scale pools counted."""
    per_token = {}
    for kv in ("float32", "int8"):
        reg = ModelRegistry()
        reg.add_generative_model("m", PARAMS, SPEC, device="cpu", warmup=False,
                                 **dict(KW, kv_dtype=kv))
        _out, stats = _serve(GenerationEngine(reg),
                             [dict(tokens=[1, 2, 3], max_tokens=2)], False)
        per_token[kv] = stats["models"]["m"]["pool_bytes_per_token"]
    assert per_token["int8"] <= 0.3 * per_token["float32"]


def test_cow_fork_copies_scales():
    reg = ModelRegistry()
    store = reg.add_generative_model("m", PARAMS, SPEC, device="cpu",
                                     warmup=False, **KW)
    pk, pv = store.new_pool()
    sk, sv = store.new_scale_pool()
    rs = np.random.RandomState(1)
    pk.copy_(torch.from_numpy(rs.randint(-127, 128, pk.shape, np.int8)))
    sk.copy_(torch.from_numpy(rs.rand(*sk.shape).astype(np.float32)))
    sv.copy_(torch.from_numpy(rs.rand(*sv.shape).astype(np.float32)))
    out = store.copy_block(pk, pv, 3, 7, scales=(sk, sv))
    assert len(out) == 4 and out[0] is pk and out[2] is sk
    assert torch.equal(pk[:, :, 7 * BS:8 * BS], pk[:, :, 3 * BS:4 * BS])
    assert torch.equal(sk[:, :, 7], sk[:, :, 3])
    assert torch.equal(sv[:, :, 7], sv[:, :, 3])
    assert not torch.equal(sk[:, :, 6], sk[:, :, 3])
    with pytest.raises(MXNetError, match="scale"):
        store.run_paged_step(pk, pv, np.zeros((1, 5), np.int32),
                             np.zeros((1, 1), np.int32),
                             np.zeros(1, np.int32), np.ones(1, np.int32))


def test_int8_kv_needs_the_paged_plane():
    for reg, kw in ((JaxRegistry(), {}), (ModelRegistry(),
                                         dict(device="cpu"))):
        with pytest.raises(Exception, match="paged KV plane"):
            reg.add_generative_model("m", PARAMS, SPEC, paged=False,
                                     **dict(KW, **kw))


def test_quantized_weights_cross_over_as_they_are():
    """(codes, scales) pairs taken from the JAX package's carriers are
    served bit for bit; the port's own codec gives the same store."""
    jparams = _jax_int8_params()
    pairs = {k: (v.codes, v.scales) if isinstance(v, jdq.QuantizedWeight)
             else v for k, v in jparams.items()}
    a = ModelRegistry().add_generative_model(
        "m", jparams, SPEC, device="cpu", warmup=False, **KW)
    b = ModelRegistry().add_generative_model(
        "m", PARAMS, SPEC, device="cpu", warmup=False, **KW)
    back = tlm.TransformerLM.from_numpy(pairs, SPEC, device="cpu")
    for name in tlm.lm_matmul_weights(SPEC):
        for model in (a.model, b.model, back):
            qw = model.params()[name]
            assert isinstance(qw, dq.QuantizedWeight)
            assert np.array_equal(qw.codes.numpy(), jparams[name].codes)
            assert np.array_equal(qw.scales.numpy(), jparams[name].scales)
    with pytest.raises(MXNetError, match="int8 codes"):
        tlm.TransformerLM.from_numpy(
            dict(pairs, pred_weight=(pairs["pred_weight"][0][:3],
                                     pairs["pred_weight"][1])),
            SPEC, device="cpu")
