"""bf16 serving on the paged plane: the port against the JAX package, on
the CPU.

The plain bf16 ``rms_norm``, ``layer_norm`` and paged attention against
the Pallas kernels run in interpret mode, within one bf16 ulp of the
largest reference value (the two sides sum in another order before the
one rounding to bf16); whole paged steps (a prefill chunk, then a
decode step) for every mix of bf16 with fp32 or int8 that the reference
serves, logits within 2e-2 x max|ref| of the reference's default route
(a few bf16 ulps: the products round to bf16 at other places in the two
frameworks, and the reference's own kernel and XLA routes differ by one
ulp of the logits); and the bf16 store through the engine: greedy
streams, dtypes and bytes against the reference's.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.pallas_ops import norm as jax_norm
from mxnet_tpu.pallas_ops.paged_attention import (
    flash_attention_paged as jax_flash_attention_paged)
from mxnet_tpu.serving import GenerationEngine as JaxEngine
from mxnet_tpu.serving import ModelRegistry as JaxRegistry
from mxnet_tpu_torch.kernels import norm, paged_attention
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.serving import GenerationEngine, ModelRegistry
from test_torch_cuda import bf16_ulp, paged_case

jlm = importlib.import_module("mxnet_tpu.models.transformer_lm")

SPEC = tlm.lm_spec(num_layers=2, num_hidden=64, num_heads=4, vocab_size=256)
PARAMS = tlm.random_params(SPEC, seed=5)
BS, NB, T = 8, 16, 5
KW = dict(batch_buckets=(2,), prompt_buckets=(8, 16), kv_block=BS,
          kv_max=40, prefill_chunk=8)
LOGIT_TOL = 2e-2   # of max|ref|
# (compute dtype, kv dtype) mixes the reference serves with bf16 in them
MIXES = [("bfloat16", "float32"), ("float32", "bfloat16"),
         ("bfloat16", "bfloat16"), ("int8", "bfloat16"),
         ("bfloat16", "int8")]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


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


def _bf16(*arrays):
    """fp32 numpy arrays rounded to bf16 on both sides (the same RNE)."""
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
             for a in arrays])


def _f32(x):
    """A bf16 array or tensor of either package as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within_ulp(got, want, extra=0.0):
    tol = bf16_ulp(np.abs(want).max()) + extra
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol)


# ---------------------------------------------------------------------------
# the three kernels' plain versions in bf16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows,width", [(16, 64), (6, 40), (32, 512)])
def test_bf16_norms_plain_match_pallas_interpret(rows, width):
    rs = np.random.RandomState(rows + width)
    x = rs.randn(rows, width).astype(np.float32)
    g = rs.uniform(0.5, 1.5, width).astype(np.float32)
    b = rs.randn(width).astype(np.float32)
    (jx, jg, jb), (tx, tg, tb) = _bf16(x, g, b)
    got = norm.rms_norm(tx, tg, 1e-6)
    assert got.dtype == torch.bfloat16
    _within_ulp(_f32(got), _f32(jax_norm.rms_norm(jx, jg, 1e-6, 8, True)))
    (jx3,), (tx3,) = _bf16(x + 3.0)
    got = norm.layer_norm(tx3, tg, tb, 1e-5)
    assert got.dtype == torch.bfloat16
    _within_ulp(_f32(got), _f32(jax_norm.layer_norm(jx3, jg, jb, 1e-5, 8,
                                                     True)))


@pytest.mark.parametrize("seed,lq,positions", [(0, 1, [5, 9, 17]),
                                               (1, 4, [0, 3, 12]),
                                               (2, 8, [8, 1, 15])])
def test_bf16_paged_plain_matches_pallas_interpret(seed, lq, positions):
    q, kp, vp, tbl, pos = paged_case(seed, B=3, H=2, T=4, D=16, bs=8,
                                     num_blocks=12, positions=positions,
                                     lq=lq)
    (jq, jk, jv), (tq, tk, tv) = _bf16(q, kp, vp)
    got = paged_attention.flash_attention_paged(
        tq, tk, tv, torch.from_numpy(tbl), torch.from_numpy(pos), 8)
    assert got.dtype == torch.bfloat16
    want = jax_flash_attention_paged(jq, jk, jv, tbl, pos, 8, block_q=lq,
                                     interpret=True)
    assert want.dtype == jnp.bfloat16
    _within_ulp(_f32(got), _f32(want))


def test_bf16_paged_kernel_argument_checks():
    q, kp, vp, tbl, pos = paged_case(0, B=3, H=2, T=4, D=16, bs=8,
                                     num_blocks=12, positions=[5, 9, 17],
                                     lq=1)
    _, (tq, tk, tv) = _bf16(q, kp, vp)
    tt, tp = torch.from_numpy(tbl), torch.from_numpy(pos)
    check = paged_attention._check
    check(tq, tk, tv, tt, tp, 8)
    with pytest.raises(ValueError, match="q must be torch.bfloat16"):
        check(tq.float(), tk, tv, tt, tp, 8)
    with pytest.raises(ValueError, match="q must be torch.float32"):
        check(tq, tk.float(), tv.float(), tt, tp, 8)
    _, (q12, k12, v12) = _bf16(q[..., :12], kp[..., :12], vp[..., :12])
    with pytest.raises(ValueError, match="multiple of 8"):
        check(q12, k12, v12, tt, tp, 8)


def test_bf16_kernel_dtype_checks_name_the_dtype():
    """The fp32-only kernels keep refusing bf16; the bf16 norms take
    x and its parameters in one dtype."""
    from mxnet_tpu_torch.kernels import _build
    x = torch.zeros(4, 8, dtype=torch.bfloat16)
    g = torch.ones(8, dtype=torch.bfloat16)
    with pytest.raises(_build.KernelError, match="takes float32.*bfloat16"):
        _build.check_args("softmax_rows", x)
    with pytest.raises(_build.KernelError, match="takes float32.*bfloat16"):
        norm._check_rows("rms_norm_bwd", x, g, like=(x,))
    norm._check_rows("rms_norm", x, g, dtypes=tuple(norm._FWD))
    with pytest.raises(_build.KernelError, match="one dtype.*float32"):
        norm._check_rows("rms_norm", x, g.float(), dtypes=tuple(norm._FWD))
    with pytest.raises(_build.KernelError, match="float16"):
        norm._check_rows("rms_norm", x.half(), g.half(),
                         dtypes=tuple(norm._FWD))


# ---------------------------------------------------------------------------
# whole paged steps, every bf16 mix
# ---------------------------------------------------------------------------
def _steps():
    """A prefill chunk that straddles block edges, with pad rows, then
    one decode step."""
    tables = np.zeros((3, T), np.int32)
    tables[0, :3] = [1, 2, 3]
    tables[1, :3] = [4, 5, 6]
    tables[2, :2] = [7, 8]
    chunk = dict(tokens=np.random.RandomState(0).randint(
        0, 256, (3, 8)).astype(np.int32),
        positions=np.array([5, 0, 3], np.int32),
        valid=np.array([8, 6, 8], np.int32))
    pos = chunk["positions"] + chunk["valid"]
    decode = dict(tokens=np.array([[7], [3], [11]], np.int32),
                  positions=pos, valid=np.ones(3, np.int32))
    return tables, [chunk, decode]


@jax.jit
def _jax_step(params, pool_k, pool_v, tables, tokens, positions, valid,
              scales):
    """The reference's paged step compiled, as its store serves it."""
    return jlm.paged_step_apply(params, pool_k, pool_v, tables, tokens,
                                positions, valid, SPEC, BS, scales=scales)


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
                 for k, v in PARAMS.items()}, model.astype(torch.bfloat16))
    return {k: jnp.asarray(v) for k, v in PARAMS.items()}, model


@pytest.mark.parametrize("compute,kv", MIXES)
def test_bf16_paged_steps_match_jax(compute, kv):
    tables, steps = _steps()
    jparams, model = _models(compute)
    jk, jv = jlm.init_pool(SPEC, NB, BS, dtype=kv)
    pk, pv = tlm.init_pool(SPEC, NB, BS, dtype=TORCH_DTYPES[kv])
    int8 = kv == "int8"
    jsc = jlm.init_scale_pool(SPEC, NB) if int8 else None
    tsc = tlm.init_scale_pool(SPEC, NB) if int8 else None
    for st in steps:
        args = (tables, st["tokens"], st["positions"], st["valid"])
        jout = _jax_step(jparams, jk, jv, *args, jsc)
        tout = tlm.paged_step_apply(model.params(), pk, pv, *args, SPEC, BS,
                                    scales=tsc)
        jl, jk, jv = np.asarray(jout[0]), jout[1], jout[2]
        if int8:
            jsc = jout[3:]
        tl = tout[0]
        assert tl.dtype == torch.float32 and jl.dtype == np.float32
        err = np.abs(tl.numpy() - jl).max()
        assert err <= LOGIT_TOL * np.abs(jl).max(), (err, np.abs(jl).max())
    rows = slice(BS, None)      # every block but the trash block 0
    for got, want in ((pk, jk), (pv, jv)):
        assert str(got.dtype) == "torch." + str(want.dtype)
        if not int8:
            _within_ulp(_f32(got)[:, :, rows], _f32(want)[:, :, rows])
    if int8:
        # the fresh bf16 rows agree within one ulp, so the decoded pools
        # agree within that ulp plus one code step of the largest scale
        # (a scale may move with its block's absmax, and each side's
        # rounding to a code is off by at most half a step)
        for got, want, gs, ws in ((pk, jk, tsc[0], jsc[0]),
                                  (pv, jv, tsc[1], jsc[1])):
            gs, ws = gs.numpy(), np.asarray(ws)
            _within_ulp(gs[:, :, 1:], ws[:, :, 1:])
            deq = [np.repeat(s_, BS, axis=2)[..., None] * c.astype(np.float32)
                   for s_, c in ((gs, got.numpy()), (ws, np.asarray(want)))]
            _within_ulp(deq[0][:, :, rows], deq[1][:, :, rows],
                        extra=float(ws.max()))


# ---------------------------------------------------------------------------
# the bf16 store through the engine
# ---------------------------------------------------------------------------
BF16 = dict(KW, compute_dtype="bfloat16", kv_dtype="bfloat16")
PROMPTS = [[7, 3, 11, 29, 4], [200, 1, 1, 9, 50, 77, 3, 3, 12, 250, 8]]


def _serve(engine, n_tokens=12):
    try:
        futs = [engine.submit("m", p, max_tokens=n_tokens) for p in PROMPTS]
        return [f.result(120).tokens for f in futs], engine.stats()
    finally:
        engine.close()


def _jax_margin(prompt, tokens):
    """The reference's top-2 logit margin, and its largest |logit|, for
    the token after ``prompt + tokens`` on the bf16 store's step
    function, replayed for one sequence on the engine's schedule (the
    prompt in prefill chunks, then one decode step a token)."""
    jparams, _ = _models("bfloat16")
    tb = -(-KW["kv_max"] // BS)
    pk, pv = jlm.init_pool(SPEC, tb + 1, BS, dtype="bfloat16")
    tables = np.arange(1, tb + 1, dtype=np.int32)[None]
    chunk = KW["prefill_chunk"]
    feeds = [(prompt[p0:p0 + chunk], p0)
             for p0 in range(0, len(prompt), chunk)]
    feeds += [([t], len(prompt) + i) for i, t in enumerate(tokens)]
    for toks, p0 in feeds:
        logits, pk, pv = _jax_step(
            jparams, pk, pv, tables, np.asarray([toks], np.int32),
            np.asarray([p0], np.int32), np.asarray([len(toks)], np.int32),
            None)
    top = np.sort(np.asarray(logits)[0])[::-1]
    return float(top[0] - top[1]), float(np.abs(np.asarray(logits)).max())


def test_bf16_engine_streams_dtypes_and_bytes_match_jax():
    """Greedy streams equal the reference's but where the reference's
    top-2 margin is inside the logits' tolerance (a near tie that one
    bf16 rounding decides); the dtypes, weight bytes and pool bytes
    are the reference's."""
    jreg = JaxRegistry()
    jreg.add_generative_model("m", PARAMS, SPEC, paged=True, **BF16)
    want, jstats = _serve(JaxEngine(jreg))
    jstore = jreg.gen_store("m").stats()
    reg = ModelRegistry()
    store = reg.add_generative_model("m", PARAMS, SPEC, device="cpu",
                                     **BF16)
    got, stats = _serve(GenerationEngine(reg))
    assert [len(t) for t in got] == [len(t) for t in want]
    for prompt, a, b in zip(PROMPTS, got, want):
        if a != b:
            k = next(j for j in range(len(a)) if a[j] != b[j])
            margin, top = _jax_margin(prompt, b[:k])
            assert margin < LOGIT_TOL * top, (k, margin, top)
    st = store.stats()
    assert st["compute_dtype"] == jstore["compute_dtype"] == "bfloat16"
    assert st["kv_dtype"] == jstore["kv_dtype"] == "bfloat16"
    assert st["weight_bytes"] == jstore["weight_bytes"]
    assert set(st["weight_bytes"]["by_dtype"]) == {"bfloat16"}
    desc, jdesc = stats["models"]["m"], jstats["models"]["m"]
    for key in ("pool_bytes", "block_bytes", "pool_bytes_per_token",
                "cache_dtype"):
        assert desc[key] == jdesc[key], key
    assert desc["cache_dtype"] == "bfloat16"


def test_bf16_halves_pool_and_weight_bytes():
    """The reference's gate: a bf16 pool holds a token in exactly half
    the fp32 pool's bytes; bf16 weights take exactly half the bytes."""
    per_token, weights = {}, {}
    for dt in ("float32", "bfloat16"):
        reg = ModelRegistry()
        store = reg.add_generative_model(
            "m", PARAMS, SPEC, device="cpu", warmup=False,
            **dict(KW, compute_dtype=dt, kv_dtype=dt))
        _out, stats = _serve(GenerationEngine(reg), n_tokens=2)
        per_token[dt] = stats["models"]["m"]["pool_bytes_per_token"]
        weights[dt] = store.stats()["weight_bytes"]["total"]
        pk, _pv = store.new_pool()
        assert pk.dtype == TORCH_DTYPES[dt]
    assert per_token["bfloat16"] * 2 == per_token["float32"]
    assert weights["bfloat16"] * 2 == weights["float32"]


def test_serve_dtype_knobs_accept_bfloat16(monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_DTYPE", "bfloat16")
    monkeypatch.setenv("MXNET_SERVE_KV_DTYPE", "bfloat16")
    store = ModelRegistry().add_generative_model("m", PARAMS, SPEC,
                                                 device="cpu", warmup=False,
                                                 **KW)
    st = store.stats()
    assert st["compute_dtype"] == "bfloat16" and st["kv_dtype"] == "bfloat16"
    assert store.model.params()["embed_weight"].dtype == torch.bfloat16
    assert store.new_pool()[0].dtype == torch.bfloat16


def test_bf16_cow_fork_keeps_the_pool_dtype():
    store = ModelRegistry().add_generative_model(
        "m", PARAMS, SPEC, device="cpu", warmup=False, **BF16)
    pk, pv = store.new_pool()
    pk.copy_(torch.randn(pk.shape).to(torch.bfloat16))
    out = store.copy_block(pk, pv, 3, 7)
    assert out[0] is pk and pk.dtype == torch.bfloat16
    assert torch.equal(pk[:, :, 7 * BS:8 * BS], pk[:, :, 3 * BS:4 * BS])
