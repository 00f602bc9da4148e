"""The port's symbolic core against the JAX package's.

Each op of the training path is built once per package from the same
builder (both expose ``sym.<Op>``), bound with ``simple_bind`` on the
CPU, fed the same seeded numpy arguments and head gradients, and its
outputs and argument gradients compared.  The JAX package runs its plain
XLA lowerings (``MXNET_PALLAS=0``).  Then the transformer's JSON crosses
from the JAX package to the port, and the port's one-shot symbol
forward is held against its own paged serving step on the same weights.
"""
import importlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.tensor import _infer_reshape_shape as jax_reshape_shape
from mxnet_tpu_torch.models import transformer_lm as tlm
from mxnet_tpu_torch.ops.tensor import infer_reshape_shape

jlm = importlib.import_module("mxnet_tpu.models.transformer_lm")


@pytest.fixture(autouse=True)
def _plain_xla(monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS", "0")


def _run(pkg, build, shapes, values, head_grads):
    """Outputs and argument gradients of one train-mode forward and
    backward of ``build(pkg.sym)``."""
    net = build(pkg.sym)
    ex = net.simple_bind(pkg.cpu(), grad_req="write", **shapes)
    for name, val in values.items():
        ex.arg_dict[name][:] = val
    ex.forward(is_train=True)
    outs = [o.asnumpy() for o in ex.outputs]
    ex.backward([pkg.nd.array(g, ctx=pkg.cpu()) for g in head_grads])
    grads = {n: g.asnumpy() for n, g in ex.grad_dict.items()}
    return outs, grads


def _check_op(build, shapes, ints=None, seed=0, tol=1e-5):
    """``ints``: argument name -> exclusive upper bound of integer
    values (labels, token ids), drawn as float32."""
    ints = ints or {}
    net = build(jmx.sym)
    arg_shapes, out_shapes, _ = net.infer_shape(**shapes)
    t_arg, t_out, _ = build(tmx.sym).infer_shape(**shapes)
    assert t_arg == arg_shapes and t_out == out_shapes
    rs = np.random.RandomState(seed)
    values = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name in ints:
            values[name] = rs.randint(0, ints[name], shape).astype(np.float32)
        else:
            values[name] = rs.randn(*shape).astype(np.float32)
    head = [rs.randn(*s).astype(np.float32) for s in out_shapes]
    want_out, want_grads = _run(jmx, build, shapes, values, head)
    got_out, got_grads = _run(tmx, build, shapes, values, head)
    for g, w in zip(got_out, want_out):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * max(1.0, np.abs(w).max())
    assert sorted(got_grads) == sorted(want_grads)
    for name, w in want_grads.items():
        g = got_grads[name]
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= tol * max(1.0, np.abs(w).max()), name


def _v(S):
    return S.Variable("data")


OP_CASES = {
    "fc": (lambda S: S.FullyConnected(_v(S), num_hidden=5, name="fc"),
           {"data": (4, 6)}, None),
    "fc_no_bias_3d": (lambda S: S.FullyConnected(_v(S), num_hidden=3,
                                                 no_bias=True, name="fc"),
                      {"data": (4, 2, 3)}, None),
    "layer_norm_last": (lambda S: S.LayerNorm(_v(S), name="ln"),
                        {"data": (3, 4, 8)}, None),
    "layer_norm_axis1": (lambda S: S.LayerNorm(_v(S), axis=1, eps=1e-3,
                                               name="ln"),
                         {"data": (3, 5, 4)}, None),
    "rms_norm": (lambda S: S.RMSNorm(_v(S), name="rms"),
                 {"data": (3, 4, 8)}, None),
    "softmax_plain": (lambda S: S.SoftmaxOutput(_v(S), name="softmax"),
                      {"data": (6, 10)}, {"softmax_label": 10}),
    "softmax_batch": (lambda S: S.SoftmaxOutput(
        _v(S), normalization="batch", grad_scale=2.0, name="softmax"),
        {"data": (6, 10)}, {"softmax_label": 10}),
    "softmax_valid": (lambda S: S.SoftmaxOutput(
        _v(S), normalization="valid", name="softmax"),
        {"data": (6, 10)}, {"softmax_label": 10}),
    "softmax_multi_output": (lambda S: S.SoftmaxOutput(
        _v(S), multi_output=True, name="softmax"),
        {"data": (2, 5, 3)}, {"softmax_label": 5}),
    "softmax_ignore_valid": (lambda S: S.SoftmaxOutput(
        _v(S), use_ignore=True, ignore_label=2, normalization="valid",
        name="softmax"), {"data": (8, 4)}, {"softmax_label": 4}),
    "softmax_smooth": (lambda S: S.SoftmaxOutput(
        _v(S), smooth_alpha=0.1, name="softmax"),
        {"data": (6, 7)}, {"softmax_label": 7}),
    "softmax_out_grad": (lambda S: S.SoftmaxOutput(
        _v(S), out_grad=True, name="softmax"),
        {"data": (6, 7)}, {"softmax_label": 7}),
    "softmax_preserve_shape": (lambda S: S.SoftmaxOutput(
        _v(S), preserve_shape=True, name="softmax"),
        {"data": (6, 5)}, {"softmax_label": 5}),
    "attention_causal": (lambda S: S.DotProductAttention(
        S.Variable("q"), S.Variable("k"), S.Variable("v"), causal=True,
        name="att"), {"q": (2, 2, 8, 8), "k": (2, 2, 8, 8),
                      "v": (2, 2, 8, 8)}, None),
    "attention_scaled": (lambda S: S.DotProductAttention(
        S.Variable("q"), S.Variable("k"), S.Variable("v"), scale=0.3,
        name="att"), {"q": (1, 3, 6, 4), "k": (1, 3, 6, 4),
                      "v": (1, 3, 6, 4)}, None),
    "reshape_codes": (lambda S: S.Reshape(_v(S), shape=(0, -3, -4, 2, -1)),
                      {"data": (2, 3, 4, 6)}, None),
    "reshape_reverse": (lambda S: S.Reshape(_v(S), shape=(-1, 0),
                                            reverse=True),
                        {"data": (2, 3, 4)}, None),
    "transpose": (lambda S: S.transpose(_v(S), axes=(0, 2, 1)),
                  {"data": (2, 3, 4)}, None),
    "transpose_default": (lambda S: S.transpose(_v(S)),
                          {"data": (2, 3, 4)}, None),
    "add": (lambda S: S.Variable("a") + S.Variable("b"),
            {"a": (3, 4), "b": (3, 4)}, None),
    "plus_scalar": (lambda S: _v(S) + 2.5, {"data": (3, 4)}, None),
    "embedding": (lambda S: S.Embedding(_v(S), input_dim=11, output_dim=6,
                                        name="embed"),
                  {"data": (4, 5)}, {"data": 11}),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_jax_executor(case):
    build, shapes, ints = OP_CASES[case]
    _check_op(build, shapes, ints)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation_matches_jax_executor(act):
    _check_op(lambda S: S.Activation(_v(S), act_type=act), {"data": (3, 7)})


@pytest.mark.parametrize("shape,target", [
    ((2, 3, 4), (0, -1)), ((2, 3, 4), (-2,)), ((2, 3, 4), (-3, 0)),
    ((2, 12), (0, -4, 3, -1)), ((2, 12), (0, -4, -1, 6)),
    ((6, 4), (3, -1)), ((6, 4), (0, 2, 2)),((2, 3, 4, 5), (0, 0, -3)),
    ((2, 3, 4, 5), (-3, -2)), ((24,), (2, -1, 3))])
def test_reshape_special_codes_match_jax(shape, target):
    assert infer_reshape_shape(shape, target) == \
        tuple(jax_reshape_shape(shape, target))


def test_symbol_names_and_attrs_match_jax():
    """Auto-naming, argument/output lists and attr_dict of the same
    composition agree."""
    def build(S):
        h = S.FullyConnected(S.Variable("data", lr_mult=2.0), num_hidden=4)
        h = S.Activation(h, act_type="tanh")
        h = S.FullyConnected(h, num_hidden=3, no_bias=True)
        return S.SoftmaxOutput(h + 1.0, name="softmax")

    with jmx.sym.NameManager():
        j = build(jmx.sym)
    with tmx.sym.NameManager():
        t = build(tmx.sym)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert t.list_auxiliary_states() == j.list_auxiliary_states() == []
    assert t.attr_dict() == j.attr_dict()


def _lm_kwargs():
    return dict(seq_len=16, num_layers=2, num_hidden=32, num_heads=2,
                vocab_size=64)


def test_transformer_json_from_jax_loads_in_port():
    jsym = jmx.models.transformer_lm(**_lm_kwargs())
    tsym = tmx.sym.load_json(jsym.tojson())
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    shapes = dict(data=(8, 16), softmax_label=(8, 16))
    assert tsym.infer_shape(**shapes) == jsym.infer_shape(**shapes)
    # the port's own graph is the same graph, and its JSON goes back
    own = tlm.get_symbol(**_lm_kwargs())
    assert own.list_arguments() == jsym.list_arguments()
    assert own.infer_shape(**shapes) == jsym.infer_shape(**shapes)
    back = jmx.sym.load_json(own.tojson())
    assert back.list_arguments() == jsym.list_arguments()
    assert back.infer_shape(**shapes) == jsym.infer_shape(**shapes)


def test_models_alias_builds_the_symbol():
    a = tmx.models.transformer_lm(**_lm_kwargs())
    assert a.list_arguments() == tlm.get_symbol(**_lm_kwargs()).list_arguments()
    assert tmx.transformer_lm.lm_spec is tlm.lm_spec


def test_one_shot_forward_equals_paged_prefill():
    """Training and serving share weight names: the symbol's forward
    on a token grid equals ``paged_step_apply``'s prefill logits."""
    kw = _lm_kwargs()
    spec = tlm.lm_spec(num_layers=kw["num_layers"],
                       num_hidden=kw["num_hidden"],
                       num_heads=kw["num_heads"],
                       vocab_size=kw["vocab_size"])
    params = jlm.random_params(spec, seed=3)
    B, L, V = 2, kw["seq_len"], kw["vocab_size"]
    tokens = np.random.RandomState(4).randint(0, V, (B, L))
    net = tlm.get_symbol(**kw)
    ex = net.simple_bind(tmx.cpu(), grad_req="null", data=(B, L),
                         softmax_label=(B, L))
    for name, val in params.items():
        ex.arg_dict[name][:] = val
    ex.arg_dict["data"][:] = tokens.astype(np.float32)
    probs = ex.forward(is_train=False)[0].asnumpy().reshape(B, L, V)
    model = tlm.TransformerLM.from_numpy(params, spec, device="cpu")
    bs = 8
    pk, pv = tlm.init_pool(spec, B * (L // bs) + 1, bs)
    tables = np.arange(1, B * (L // bs) + 1, dtype=np.int32).reshape(B, -1)
    with torch.no_grad():
        logits, _, _ = model(pk, pv, tables, tokens.astype(np.int32),
                             np.zeros(B, np.int32), np.full(B, L, np.int32),
                             bs, all_logits=True)
    want = torch.softmax(logits, -1).numpy()
    assert np.abs(probs - want).max() <= 1e-5
