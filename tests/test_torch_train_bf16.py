"""Training in bf16 through ``Module(compute_dtype='bfloat16')``: the port
against the JAX package, on the CPU.

The bf16 plain versions of the training path's kernels (the norm
backwards and SoftmaxOutput's head) against ``jax.vjp`` of the Pallas
kernels run in interpret mode, within one bf16 ulp of the largest
reference value (both sides widen to fp32, sum in another order and
round once); flash attention's bf16 backward against ``jax.vjp`` of the
reference's (a blockwise recompute in both packages).  Then one
``forward_backward`` and three SGD-momentum steps of the port's bf16
``Module`` against ``mxnet_tpu.Module(..., compute_dtype='bfloat16')`` on
its classic executor-group path with the Pallas kernels in interpret
mode (``MXNET_MODULE_FUSED=0``, ``MXNET_PALLAS=2``), from the same numpy
parameters: outputs bf16 within ``OUT_TOL`` x max|ref| (a few bf16
ulps: the products round to bf16 at other places in the two
frameworks), every gradient float32 within ``GRAD_TOL`` x max|ref| of
its own reference (chip_smoke.py phase 7b's bound), the parameters
float32 within ``PARAM_TOL``; checkpoints both ways.  Last, the two
differences by design: token ids reach ``Embedding`` unrounded, and a
bf16 array's host copy is exact float32.
"""
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.pallas_ops import norm as jax_norm
from mxnet_tpu.pallas_ops.flash_attention import \
    flash_attention as jax_flash_attention
from mxnet_tpu.pallas_ops.softmax_xent import \
    softmax_output_head as jax_softmax_output_head
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import (_build, flash_attention, norm,
                                     softmax_xent)
from test_torch_cuda import bf16_ulp

LM = dict(seq_len=16, num_layers=2, num_hidden=64, num_heads=4,
          vocab_size=256)
BATCH, STEPS = 8, 3
OPT = {"learning_rate": 0.1, "momentum": 0.9}
OUT_TOL = 2e-2     # of max|ref|: the repo's bf16 logits bound
GRAD_TOL = 5e-2    # of max|ref| per gradient: chip_smoke.py phase 7b's
PARAM_TOL = 1e-2   # of max|ref| per parameter after three steps
BF16 = torch.bfloat16


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
            [torch.from_numpy(np.ascontiguousarray(a)).to(BF16)
             for a in arrays])


def _f32(x):
    """A bf16 array or tensor of either package as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within_ulp(got, want):
    tol = bf16_ulp(np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol)


def _norm_case(seed, rows, width):
    rs = np.random.RandomState(seed)
    return (rs.randn(rows, width).astype(np.float32),
            rs.uniform(0.5, 1.5, width).astype(np.float32),
            rs.randn(width).astype(np.float32),
            rs.randn(rows, width).astype(np.float32))


# ---------------------------------------------------------------------------
# the bf16 plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows,width", [(16, 64), (6, 40), (32, 512)])
def test_bf16_rms_norm_bwd_plain_matches_pallas_interpret(rows, width):
    """``norm.py:85 _rms_bwd`` on bf16: dx bf16, dgamma summed in fp32
    and rounded once to bf16; the port's autograd Function gives the
    wrapper's grads."""
    x, g, _, dy = _norm_case(rows + 3 * width, rows, width)
    (jx, jg, jdy), (tx, tg, tdy) = _bf16(x, g, dy)
    _, vjp = jax.vjp(lambda a, b: jax_norm.rms_norm(a, b, 1e-6, 8, True),
                     jx, jg)
    want = vjp(jdy)
    got = norm.rms_norm_bwd(tx, tg, tdy, 1e-6)
    for a, b in zip(got, want):
        assert a.dtype == BF16 and b.dtype == jnp.bfloat16
        _within_ulp(_f32(a), _f32(b))
    lx, lg = (t.clone().requires_grad_(True) for t in (tx, tg))
    norm.RMSNorm.apply(lx, lg, 1e-6).backward(tdy)
    assert torch.equal(lx.grad, got[0]) and torch.equal(lg.grad, got[1])


@pytest.mark.parametrize("rows,width", [(16, 64), (6, 40), (32, 512)])
def test_bf16_layer_norm_bwd_plain_matches_pallas_interpret(rows, width):
    """``norm.py:158 _ln_bwd`` on bf16: dx, dgamma and dbeta bf16."""
    x, g, _, dy = _norm_case(rows * width + 1, rows, width)
    (jx, jg, jb, jdy), (tx, tg, tb, tdy) = _bf16(x + 3.0, g, g[::-1], dy)
    _, vjp = jax.vjp(
        lambda a, c, d: jax_norm.layer_norm(a, c, d, 1e-5, 8, True),
        jx, jg, jb)
    want = vjp(jdy)
    got = norm.layer_norm_bwd(tx, tg, tdy, 1e-5)
    for a, b in zip(got, want):
        assert a.dtype == BF16 and b.dtype == jnp.bfloat16
        _within_ulp(_f32(a), _f32(b))
    lx, lg, lb = (t.clone().requires_grad_(True) for t in (tx, tg, tb))
    norm.LayerNorm.apply(lx, lg, lb, 1e-5).backward(tdy)
    assert all(torch.equal(t.grad, w) for t, w in zip((lx, lg, lb), got))


@pytest.mark.parametrize("rows,classes,per_row", [(24, 50, False),
                                                  (7, 130, True),
                                                  (16, 256, True)])
def test_bf16_softmax_output_head_matches_pallas_interpret(rows, classes,
                                                           per_row):
    """``softmax_xent.py:162 softmax_output_head`` on bf16 logits with
    float32 labels: p bf16, and the gradient ``(p - onehot) * scale``
    from the saved bf16 p, as the reference's ``_head_fwd`` keeps it."""
    scale = 1.0 / rows if per_row else 1.0
    rs = np.random.RandomState(rows * classes)
    data = (3 * rs.randn(rows, classes)).astype(np.float32)
    label = rs.randint(0, classes, rows).astype(np.float32)
    label[0] = classes + 2      # outside the classes: no column matches
    (jd,), (td,) = _bf16(data)
    want_p, vjp = jax.vjp(lambda d: jax_softmax_output_head(
        d, label, scale, 8, True), jd)
    (want_g,) = vjp(jnp.ones_like(want_p))
    leaf = td.clone().requires_grad_(True)
    tl = torch.from_numpy(label)
    p = softmax_xent.SoftmaxOutputHead.apply(leaf, tl, scale)
    p.sum().backward()
    assert p.dtype == leaf.grad.dtype == BF16
    _within_ulp(_f32(p), _f32(want_p))
    _within_ulp(_f32(leaf.grad), _f32(want_g))
    # the gradient is read from the saved, rounded p
    assert torch.equal(leaf.grad, softmax_xent.xent_grad_from_probs_reference(
        p.detach(), tl, scale))


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_flash_attention_backward_matches_jax_vjp(causal):
    """The bf16 forward and the backward recompute (``blockwise_attention``
    over fp32 blocks, its gradients cast back) against ``jax.vjp`` of
    the reference's ``flash_attention`` (``_flash_bwd``: ``jax.vjp`` of
    ``parallel/sp.py blockwise_attention``): dq, dk, dv bf16, within one
    bf16 ulp of max|ref|."""
    B, H, L, D = 2, 2, 32, 16
    rs = np.random.RandomState(7 + causal)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _bf16(
        *(rs.randn(B, H, L, D).astype(np.float32) for _ in range(4)))
    want, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(
        a, b, c, causal=causal, block_q=16, block_k=16, interpret=True),
        jq, jk, jv)
    want_grads = vjp(jg)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = flash_attention.FlashAttention.apply(*leaves, causal,
                                               1.0 / D ** 0.5)
    out.backward(tg)
    assert out.dtype == BF16
    _within_ulp(_f32(out), _f32(want))
    for t, w in zip(leaves, want_grads):
        assert t.grad.dtype == BF16 and w.dtype == jnp.bfloat16
        _within_ulp(_f32(t.grad), _f32(w))


# ---------------------------------------------------------------------------
# Module(compute_dtype='bfloat16') against the reference's
# ---------------------------------------------------------------------------
def _lm_params():
    """Seeded numpy parameters at the tiny LM's shapes.  The FFN biases
    sit at 1, so every ReLU input lies far from zero: at a kink, an
    input that rounding puts on the other side passes or stops a whole
    gradient term (chip_smoke.py phase 7 does the same)."""
    net = jmx.models.transformer_lm(**LM)
    shapes, _, _ = net.infer_shape(data=(BATCH, LM["seq_len"]),
                                   softmax_label=(BATCH, LM["seq_len"]))
    rs = np.random.RandomState(1)
    out = {n: rs.uniform(-0.2, 0.2, s).astype(np.float32)
           for n, s in zip(net.list_arguments(), shapes)
           if n not in ("data", "softmax_label")}
    for n in out:
        if n.endswith("_ffn1_bias"):
            out[n] = out[n] + np.float32(1.0)
    return out


def _lm_data():
    rs = np.random.RandomState(0)
    V, L = LM["vocab_size"], LM["seq_len"]
    X = (rs.randint(0, V, (STEPS * BATCH, 1)) + np.arange(L)) % V
    return X.astype(np.float32), ((X + 1) % V).astype(np.float32)


def _train(pkg, params, X, y):
    """A bf16 Module of ``pkg`` on the CPU: the first step's outputs and
    gradients, every step's outputs, the module after three steps."""
    it = pkg.io.NDArrayIter(X, y, batch_size=BATCH)
    mod = pkg.mod.Module(pkg.models.transformer_lm(**LM), context=pkg.cpu(),
                         compute_dtype="bfloat16")
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={k: pkg.nd.array(v) if pkg is jmx else v
                                for k, v in params.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    outs, grads = [], None
    for batch in it:
        mod.forward_backward(batch)
        if grads is None:
            ex = (mod._exec_group.execs[0] if pkg is jmx
                  else mod._exec_group.executor)
            grads = {k: (v.dtype, v.asnumpy())
                     for k, v in ex.grad_dict.items()}
        mod.update()
        out = mod.get_outputs()[0]
        outs.append((out._data.dtype, out.asnumpy()))
    return outs, grads, mod


@pytest.fixture(scope="module")
def trained():
    """Both packages' bf16 modules after three steps from the same
    parameters and batches, the reference on its classic path with the
    Pallas kernels in interpret mode."""
    params = _lm_params()
    X, y = _lm_data()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_MODULE_FUSED", "0")
        mp.setenv("MXNET_PALLAS", "2")
        from mxnet_tpu.pallas_ops import dispatch
        dispatch.reset_dispatch_stats()
        want = _train(jmx, params, X, y)
        stats = dispatch.dispatch_stats()
        got = _train(tmx, params, X, y)
        yield dict(params=params, X=X, y=y, want=want, got=got,
                   stats=stats)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_bf16_module_reference_runs_its_bf16_kernels(trained):
    """The oracle is the reference's bf16 kernel route: every norm, the
    attention and the head of its one traced step program went through
    Pallas (interpret mode)."""
    assert trained["stats"] == {"RMSNorm": 2 * LM["num_layers"],
                                "DotProductAttention": LM["num_layers"],
                                "LayerNorm": 1, "SoftmaxOutput": 1}


def test_bf16_module_outputs_match_reference(trained):
    """Every step's probabilities: bf16 in both packages, within
    ``OUT_TOL`` x max|ref|."""
    (want, _, _), (got, _, _) = trained["want"], trained["got"]
    assert len(got) == len(want) == STEPS
    for (gdt, g), (wdt, w) in zip(got, want):
        assert gdt == BF16 and wdt == jnp.bfloat16
        assert g.dtype == np.float32 and w.dtype == jnp.bfloat16
        assert _rel(g, w.astype(np.float32)) <= OUT_TOL


def test_bf16_module_gradients_are_fp32_and_match_reference(trained):
    """The first step's gradients: float32 in both packages (the cast's
    backward), each within ``GRAD_TOL`` x its own max|ref|."""
    (_, want, _), (_, got, _) = trained["want"], trained["got"]
    assert sorted(got) == sorted(want)
    for name, (wdt, w) in want.items():
        gdt, g = got[name]
        assert gdt == wdt == np.float32, name
        assert _rel(g, w) <= GRAD_TOL, name


def test_bf16_module_parameters_stay_fp32_and_match_reference(trained):
    """After three SGD-momentum steps: the bound parameters, the
    optimizer's momentum and ``get_params`` are float32, and every
    parameter is within ``PARAM_TOL`` x max|ref| of the reference's
    and has moved."""
    want_mod, got_mod = trained["want"][2], trained["got"][2]
    want, _ = want_mod.get_params()
    got, _ = got_mod.get_params()
    for a in got_mod._exec_group.param_arrays:
        assert a._data.dtype == torch.float32
    for state in got_mod._updater.states.values():
        assert state is None or state._data.dtype == torch.float32
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name].asnumpy()
        assert g.dtype == w.asnumpy().dtype == np.float32, name
        assert _rel(g, w.asnumpy()) <= PARAM_TOL, name
        assert not np.array_equal(g, trained["params"][name]), name


def _score(pkg, prefix, X, y, compute_dtype=None):
    mod = pkg.mod.Module.load(prefix, STEPS, context=pkg.cpu(),
                              compute_dtype=compute_dtype)
    it = pkg.io.NDArrayIter(X, y, batch_size=BATCH)
    mod.bind(it.provide_data, it.provide_label, for_training=False)
    return mod.score(it, pkg.metric.Perplexity(ignore_label=None))[0][1]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bf16_trained_checkpoint_scores_the_same_in_both(trained, tmp_path,
                                                         writer):
    """A bf16-trained module's checkpoint holds float32 parameters and
    loads in the other package, which scores the batches as the writer
    does: in fp32 within 1e-5, and in bf16 within ``OUT_TOL``."""
    mod = trained["got" if writer == "port" else "want"][2]
    prefix = str(tmp_path / "lm")
    mod.save_checkpoint(prefix, STEPS)
    jmx.nd.waitall()   # the reference writes its params file async
    (path,) = glob.glob(prefix + "-%04d.params*" % STEPS)
    with np.load(path) as saved:
        assert all(saved[k].dtype == np.float32 for k in saved.files
                   if k.startswith("arg:"))
    X, y = trained["X"], trained["y"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_MODULE_FUSED", "0")
        for dtype, tol in ((None, 1e-5), ("bfloat16", OUT_TOL)):
            ref = _score(jmx, prefix, X, y, dtype)
            port = _score(tmx, prefix, X, y, dtype)
            assert abs(port - ref) <= tol * ref, (dtype, port, ref)


# ---------------------------------------------------------------------------
# the bf16 step's route: every kernel under its bf16 name
# ---------------------------------------------------------------------------
@pytest.fixture
def card_route(monkeypatch):
    """The norm and head wrappers' card route on CPU tensors (the plain
    versions fill the outputs), each launch recorded by its launch name
    and C entry point; flash attention stays on its plain version."""
    launches = []

    def record(plain):
        def fake_launch(x, name, entry, *args):
            launches.append((name, entry))
        return fake_launch

    for mod in (norm, softmax_xent):
        monkeypatch.setattr(mod, "route", lambda name, x: True)
        monkeypatch.setattr(mod, "launch", record(mod))
    monkeypatch.setattr(norm, "sm_count", lambda index: 132)
    return launches


def test_bf16_module_step_launches_the_bf16_kernels(card_route):
    """One bf16 ``forward_backward`` of the two-layer LM reaches each
    kernel under its bf16 name and C entry point, and no fp32 one: two
    RMSNorms a block and the final LayerNorm each way, the head's two
    bodies; the label reaches the head as float32, the rest as bf16."""
    seen = []
    head = softmax_xent.SoftmaxOutputHead.forward

    def spy(ctx, data, label, scale):
        seen.append((data.dtype, label.dtype))
        return head(ctx, data, label, scale)

    X, y = _lm_data()
    it = tmx.io.NDArrayIter(X[:BATCH], y[:BATCH], batch_size=BATCH)
    mod = tmx.Module(tmx.models.transformer_lm(**LM), context=tmx.cpu(),
                     compute_dtype="bfloat16")
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=_lm_params())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(softmax_xent.SoftmaxOutputHead, "forward",
                   staticmethod(spy))
        mod.forward_backward(next(iter(it)))
    nl = LM["num_layers"]
    want = {("rms_norm_bf16", "mxt_rms_norm_bf16"): 2 * nl,
            ("rms_norm_bwd_bf16", "mxt_rms_norm_bwd_bf16"): 2 * nl,
            ("layer_norm_bf16", "mxt_layer_norm_bf16"): 1,
            ("layer_norm_bwd_bf16", "mxt_layer_norm_bwd_bf16"): 1,
            ("softmax_rows_bf16", "mxt_softmax_rows_bf16"): 1,
            ("xent_grad_from_probs_bf16",
             "mxt_xent_grad_from_probs_bf16"): 1}
    got = {}
    for key in card_route:
        got[key] = got.get(key, 0) + 1
    assert got == want
    assert seen == [(BF16, torch.float32)]
    assert all(name in kernels.KERNELS for name, _ in want)
    assert all(entry in _build._SIGNATURES for _, entry in want)


def test_bf16_head_takes_a_float32_label_and_nothing_looser():
    """The head's label is checked on its own: float32 beside bf16 or
    fp32 probabilities; a bf16 or float16 label, fp16 probabilities, a
    label of the wrong length or on another device are refused, naming
    what was wrong; the other kernels still take one dtype."""
    p = torch.zeros(4, 8, dtype=BF16)
    lbl = torch.zeros(4)
    check = softmax_xent._check_head_label
    check("xent_grad_from_probs", p, lbl)
    check("xent_grad_from_probs", p.float(), lbl)
    with pytest.raises(_build.KernelError, match="float32.*bfloat16"):
        check("xent_grad_from_probs", p, lbl.to(BF16))
    with pytest.raises(_build.KernelError, match="float16"):
        check("xent_grad_from_probs", p, lbl.half())
    with pytest.raises(_build.KernelError, match=r"want \(4,\)"):
        check("xent_grad_from_probs", p, torch.zeros(5))
    with pytest.raises(_build.KernelError, match="must be on"):
        check("xent_grad_from_probs", p, torch.zeros(4, device="meta"))
    with pytest.raises(_build.KernelError, match="float16"):
        _build.check_args("xent_grad_from_probs", p.half(),
                          dtypes=tuple(_build.SUFFIX))
    with pytest.raises(_build.KernelError, match="all of one dtype"):
        _build.check_args("softmax_xent_loss", p.float(), lbl.to(BF16))
    with pytest.raises(_build.KernelError, match="float16"):
        norm._check_rows("rms_norm_bwd", torch.zeros(4, 8).half(),
                         torch.zeros(8).half(), like=(torch.zeros(4, 8),),
                         dtypes=tuple(norm._FWD))


# ---------------------------------------------------------------------------
# the differences by design
# ---------------------------------------------------------------------------
IDS = [255, 257, 300, 5000, 8187, 8188, 8191]


def test_index_inputs_keep_their_dtype_where_the_reference_rounds():
    """At the full vocabulary (8192) the reference's bf16 executor casts
    the token ids to bf16 before ``Embedding``: 257 reads row 256, 5000
    row 4992, and 8187-8191 (every id from 8184) round to 8192, outside
    the table, which ``jnp.take`` fills with NaN.  The port keeps an
    argument that the graph reads only as ``Embedding``'s ``data`` in
    its master dtype, beside the labels, and reads the exact rows."""
    V, D = 8192, 4
    weight = np.random.RandomState(0).randn(V, D).astype(np.float32)
    ids = np.float32([IDS])
    net = jmx.sym.Embedding(jmx.sym.Variable("data"), input_dim=V,
                            output_dim=D, name="embed")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_MODULE_FUSED", "0")
        ex = net.simple_bind(jmx.cpu(), grad_req="null",
                             compute_dtype="bfloat16",
                             keep_dtype=("softmax_label",), data=(1, 7))
        ex.copy_params_from({"embed_weight": jmx.nd.array(weight)})
        ref = np.asarray(ex.forward(data=jmx.nd.array(ids))[0].asnumpy(),
                         np.float32)[0]
    w16 = torch.from_numpy(weight).to(BF16).float().numpy()
    assert np.array_equal(ref[:1], w16[[255]])
    assert np.array_equal(ref[1:4], w16[[256, 300, 4992]])
    assert np.isnan(ref[4:]).all() and np.isfinite(ref[:4]).all()

    tnet = tmx.sym.Embedding(tmx.sym.Variable("data"), input_dim=V,
                             output_dim=D, name="embed")
    assert tnet.list_index_arguments() == ["data"]
    assert tmx.models.transformer_lm(**LM).list_index_arguments() == \
        ["data"]
    mod = tmx.Module(tnet, label_names=None, context=tmx.cpu(),
                     compute_dtype="bfloat16")
    mod.bind([("data", (1, 7))], for_training=False)
    mod.init_params(arg_params={"embed_weight": weight})
    mod.forward(tmx.io.DataBatch([tmx.nd.array(ids, ctx=tmx.cpu())], []))
    out = mod.get_outputs()[0]
    assert out._data.dtype == BF16
    assert np.array_equal(out.asnumpy()[0], w16[IDS])


def test_index_arguments_need_every_reader_to_index():
    """An argument also read as data, or read by nothing, is not an
    index argument, and casts as the reference casts it."""
    d = tmx.sym.Variable("data")
    both = tmx.sym.Embedding(d, input_dim=8, output_dim=2, name="e") + \
        tmx.sym.FullyConnected(d, num_hidden=2, name="fc")
    assert both.list_index_arguments() == []
    assert d.list_index_arguments() == []


def test_bf16_asnumpy_and_metrics_widen_exactly():
    """numpy has no bfloat16: a bf16 array's host copy, and the metrics'
    host copies of bf16 predictions, are float32 with the same values
    (every bf16 is an fp32)."""
    rs = np.random.RandomState(4)
    probs = torch.from_numpy(rs.dirichlet(np.ones(6), 5).astype(
        np.float32)).to(BF16)
    arr = tmx.nd.NDArray(probs)
    host = arr.asnumpy()
    assert host.dtype == np.float32
    assert np.array_equal(host, probs.float().numpy())
    assert arr[0:1].asnumpy().dtype == np.float32
    label = np.float32([0, 5, 2, 3, 1])
    for name in ("perplexity", "ce", "acc"):
        kw = {"ignore_label": None} if name == "perplexity" else {}
        got, want = (tmx.metric.create(name, **kw) for _ in range(2))
        got.update([tmx.nd.array(label, ctx=tmx.cpu())], [arr])
        want.update([tmx.nd.array(label, ctx=tmx.cpu())],
                    [tmx.nd.NDArray(probs.float())])
        assert got.get() == want.get(), name
