"""Decoder-only transformer LM in PyTorch: the training symbol and the
paged serving step.

Counterpart of ``mxnet_tpu/models/transformer_lm.py``.  :func:`get_symbol`
builds the one-shot training graph (a copy of the reference's), and
:func:`paged_step_apply` applies the same weights, under the same
argument names, one paged step at a time, so a model trained by
``Module`` is served as it is.  Pre-norm blocks (RMSNorm), learned
q/k/v/proj projections without biases, a ReLU FFN at 4x width, a final
LayerNorm and the ``pred`` head.  RMSNorm, LayerNorm, the attention and
the loss head go through the kernel wrappers (CUDA kernel on a CUDA
tensor, plain version on a CPU tensor); the large matrix products stay
``torch.matmul``, as the reference left them to XLA.

The module is callable: ``models.transformer_lm(seq_len, ...)`` is
:func:`get_symbol`, as the reference's ``models.transformer_lm``.
"""
from __future__ import annotations

import sys
import types

import numpy as np
import torch
from torch import nn

from .. import symbol as sym
from ..base import MXNetError
from ..context import default_device
from ..ops.attention import sdp_attention_paged
from ..ops.nn import layer_norm, rms_norm

__all__ = ["get_symbol", "lm_spec", "param_shapes", "random_params",
           "init_pool", "paged_step_apply", "lm_matmul_weights",
           "TransformerLM"]


def _attention_block(x, seq_len, num_hidden, num_heads, name):
    """Pre-norm causal self-attention with residual. x: (B, L, D)."""
    head_dim = num_hidden // num_heads
    a = sym.RMSNorm(x, name=name + "_ln1")
    a2 = sym.Reshape(a, shape=(-1, num_hidden))

    def heads(t, tag):
        proj = sym.FullyConnected(t, num_hidden=num_hidden, no_bias=True,
                                  name="%s_%s" % (name, tag))
        h = sym.Reshape(proj, shape=(-1, seq_len, num_heads, head_dim))
        return sym.transpose(h, axes=(0, 2, 1, 3))   # (B, H, L, dh)

    att = sym.DotProductAttention(heads(a2, "q"), heads(a2, "k"),
                                  heads(a2, "v"), causal=True,
                                  name=name + "_attn")
    att = sym.Reshape(sym.transpose(att, axes=(0, 2, 1, 3)),
                      shape=(-1, num_hidden))
    proj = sym.FullyConnected(att, num_hidden=num_hidden, no_bias=True,
                              name=name + "_proj")
    return x + sym.Reshape(proj, shape=(-1, seq_len, num_hidden))


def _ffn_block(x, seq_len, num_hidden, name):
    """Pre-norm ReLU FFN (4x) with residual."""
    f = sym.RMSNorm(x, name=name + "_ln2")
    f = sym.Reshape(f, shape=(-1, num_hidden))
    f = sym.FullyConnected(f, num_hidden=4 * num_hidden,
                           name=name + "_ffn1")
    f = sym.Activation(f, act_type="relu")
    f = sym.FullyConnected(f, num_hidden=num_hidden, name=name + "_ffn2")
    return x + sym.Reshape(f, shape=(-1, seq_len, num_hidden))


def get_symbol(seq_len, num_layers=2, num_hidden=64, num_heads=4,
               vocab_size=256, **kwargs):
    """Causal transformer LM symbol for one sequence length.

    data: (batch, seq_len) token ids; softmax_label: (batch, seq_len)
    next-token ids.  Loss head: SoftmaxOutput over the flattened
    (batch*seq_len, vocab) logits."""
    if num_hidden % num_heads:
        raise ValueError("num_hidden %d must divide into num_heads %d"
                         % (num_hidden, num_heads))
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    x = sym.Embedding(data, input_dim=vocab_size, output_dim=num_hidden,
                      name="embed")
    for i in range(num_layers):
        name = "blk%d" % i
        x = _attention_block(x, seq_len, num_hidden, num_heads, name)
        x = _ffn_block(x, seq_len, num_hidden, name)
    h = sym.LayerNorm(x, name="final_ln")
    logits = sym.FullyConnected(sym.Reshape(h, shape=(-1, num_hidden)),
                                num_hidden=vocab_size, name="pred")
    return sym.SoftmaxOutput(logits, sym.Reshape(label, shape=(-1,)),
                             name="softmax")

_BLOCK_KEYS = ("ln1_gamma", "q_weight", "k_weight", "v_weight",
               "proj_weight", "ln2_gamma", "ffn1_weight", "ffn1_bias",
               "ffn2_weight", "ffn2_bias")


def lm_spec(num_layers=2, num_hidden=64, num_heads=4, vocab_size=256):
    """Validated architecture spec (``seq_len`` belongs to the call)."""
    if num_hidden % num_heads:
        raise ValueError("num_hidden %d must divide into num_heads %d"
                         % (num_hidden, num_heads))
    return {"num_layers": int(num_layers), "num_hidden": int(num_hidden),
            "num_heads": int(num_heads), "vocab_size": int(vocab_size)}


def param_shapes(spec):
    """``[(name, shape)]`` in the reference Symbol's ``list_arguments()``
    order: the embedding, then per block ``ln1_gamma, q, k, v, proj,
    ln2_gamma, ffn1_weight, ffn1_bias, ffn2_weight, ffn2_bias``, then the
    final LayerNorm and the ``pred`` head."""
    D, V = spec["num_hidden"], spec["vocab_size"]
    shapes = {"ln1_gamma": (D,), "q_weight": (D, D), "k_weight": (D, D),
              "v_weight": (D, D), "proj_weight": (D, D), "ln2_gamma": (D,),
              "ffn1_weight": (4 * D, D), "ffn1_bias": (4 * D,),
              "ffn2_weight": (D, 4 * D), "ffn2_bias": (D,)}
    out = [("embed_weight", (V, D))]
    for i in range(spec["num_layers"]):
        out += [("blk%d_%s" % (i, k), shapes[k]) for k in _BLOCK_KEYS]
    out += [("final_ln_gamma", (D,)), ("final_ln_beta", (D,)),
            ("pred_weight", (V, D)), ("pred_bias", (V,))]
    return out


def random_params(spec, seed=0, scale=0.1):
    """Seeded uniform(-scale, scale) fp32 numpy weights, drawn from one
    ``RandomState`` in :func:`param_shapes` order — bit-identical to the
    reference package's ``random_params`` for the same seed."""
    rs = np.random.RandomState(seed)
    return {name: np.asarray(rs.uniform(-scale, scale, shape), np.float32)
            for name, shape in param_shapes(spec)}


def lm_matmul_weights(spec):
    """The 2D matmul weights of the LM argument set."""
    names = ["embed_weight", "pred_weight"]
    for i in range(spec["num_layers"]):
        names += ["blk%d_%s" % (i, k) for k in
                  ("q_weight", "k_weight", "v_weight", "proj_weight",
                   "ffn1_weight", "ffn2_weight")]
    return names


def init_pool(spec, num_blocks, block_size, dtype=torch.float32,
              device=None):
    """Zeroed paged KV pool pair, each ``(num_layers, num_heads,
    num_blocks * block_size, head_dim)``.  Block 0 is the reserved trash
    block: pad writes land there and no real table entry points at
    it."""
    dh = spec["num_hidden"] // spec["num_heads"]
    shape = (spec["num_layers"], spec["num_heads"],
             int(num_blocks) * int(block_size), dh)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _block_params(params, i):
    return {k: params["blk%d_%s" % (i, k)] for k in _BLOCK_KEYS}


def _mm(x2d, w):
    """``x @ w^T``: one plain matrix product."""
    return torch.matmul(x2d, w.t())


def _embed(w, tokens):
    return torch.nn.functional.embedding(tokens.long(), w)


def _ffn(x2d, bp):
    f = torch.relu(_mm(x2d, bp["ffn1_weight"]) + bp["ffn1_bias"])
    return _mm(f, bp["ffn2_weight"]) + bp["ffn2_bias"]


def paged_step_apply(params, pool_k, pool_v, tables, tokens, positions,
                     valid, spec, block_size, all_logits=False):
    """One paged step: a prefill chunk (``Lq > 1``) or a decode step
    (``Lq = 1``) of the paged KV plane.

    tokens: (B, Lq) int — row r of sequence b sits at global position
    ``positions[b] + r``; valid: (B,) int — rows ``r < valid[b]`` are real
    (``1 <= valid <= Lq``), the rest are pad; tables: (B, T) int block
    tables over the pools ``(L, H, num_blocks * block_size, dh)`` of
    :func:`init_pool`.  Table entries past a sequence's frontier must
    point at a valid block, conventionally the trash block 0.  Inputs may
    be numpy arrays or tensors; they are moved to the pools' device.

    Each layer writes the chunk's K/V to pool rows ``tables[b, p // bs] *
    bs + p % bs`` and attends through :func:`sdp_attention_paged`; pad
    rows write into the trash block (row ``p % bs`` of block 0), where
    no real query ever looks.  The pools are updated IN PLACE
    (``index_put_``) — the counterpart of the reference's donated pool
    arguments — and returned for symmetry with it.  Rows that index the
    same pool row in one step may only ever be pad rows in the trash
    block, or recomputed prompt rows writing identical values.

    Returns ``(logits, pool_k, pool_v)``: fp32 logits ``(B, vocab)`` at
    each row's last valid position, or ``(B, Lq, vocab)`` for every row
    with ``all_logits=True``."""
    L, D = spec["num_layers"], spec["num_hidden"]
    H = spec["num_heads"]
    dh = D // H
    bs = int(block_size)
    dev = pool_k.device
    tokens = torch.as_tensor(tokens, device=dev)
    B, Lq = tokens.shape
    tables32 = torch.as_tensor(tables, device=dev).to(torch.int32)
    tables32 = tables32.contiguous()
    pos32 = torch.as_tensor(positions, device=dev).to(torch.int32)
    pos32 = pos32.contiguous()
    valid = torch.as_tensor(valid, device=dev).long()
    T = tables32.shape[1]
    r = torch.arange(Lq, device=dev)
    p = pos32.long()[:, None] + r[None, :]                   # (B, Lq)
    # a pad row's logical block may lie past the table: clamp the lookup
    # (its destination is replaced by the trash block just below)
    blk = tables32.long().gather(1, torch.clamp(p // bs, max=T - 1))
    dest = torch.where(r[None, :] < valid[:, None], blk * bs + p % bs,
                       p % bs).reshape(-1)                   # (B*Lq,)

    x = _embed(params["embed_weight"], tokens)               # (B, Lq, D)
    for i in range(L):
        bp = _block_params(params, i)
        a2 = rms_norm(x, bp["ln1_gamma"], 1e-6).reshape(-1, D)
        q = _mm(a2, bp["q_weight"]).reshape(B, Lq, H, dh)
        k = _mm(a2, bp["k_weight"]).reshape(B * Lq, H, dh)
        v = _mm(a2, bp["v_weight"]).reshape(B * Lq, H, dh)
        # (H, rows, dh) viewed as (rows, H, dh): row-indexed in-place write
        pool_k[i].transpose(0, 1).index_put_((dest,), k.to(pool_k.dtype))
        pool_v[i].transpose(0, 1).index_put_((dest,), v.to(pool_v.dtype))
        att = sdp_attention_paged(q.permute(0, 2, 1, 3).contiguous(),
                                  pool_k[i], pool_v[i], tables32, pos32, bs)
        att = att.permute(0, 2, 1, 3).reshape(-1, D)
        x = x + _mm(att, bp["proj_weight"]).reshape(B, Lq, D)
        f = rms_norm(x, bp["ln2_gamma"], 1e-6).reshape(-1, D)
        x = x + _ffn(f, bp).reshape(B, Lq, D)
    h = layer_norm(x, params["final_ln_gamma"], params["final_ln_beta"],
                   1e-5)
    if all_logits:
        logits = (_mm(h.reshape(-1, D), params["pred_weight"]) +
                  params["pred_bias"]).reshape(B, Lq, spec["vocab_size"])
    else:
        last = h[torch.arange(B, device=dev), valid - 1]     # (B, D)
        logits = _mm(last, params["pred_weight"]) + params["pred_bias"]
    return logits.float(), pool_k, pool_v


class TransformerLM(nn.Module):
    """The LM's weights as buffers named by the reference's argument
    names (``embed_weight``, ``blk0_q_weight``, ...), on one device."""

    def __init__(self, spec, tensors):
        super().__init__()
        self.spec = lm_spec(**dict(spec))
        for name, _shape in param_shapes(self.spec):
            self.register_buffer(name, tensors[name])

    @classmethod
    def from_numpy(cls, params, spec, device=None):
        """Carry the reference package's parameter dict (name -> numpy
        array, e.g. its ``random_params`` or a checkpoint's arg_params)
        into the port.  ``device`` defaults to ``cuda:0``; pass "cpu"
        for the plain versions."""
        spec = lm_spec(**dict(spec))
        dev = default_device(device)
        tensors = {}
        for name, shape in param_shapes(spec):
            if name not in params:
                raise MXNetError("transformer LM is missing param %r"
                                 % name)
            arr = params[name]
            if isinstance(arr, torch.Tensor):
                arr = arr.detach().cpu().numpy()
            arr = np.asarray(arr, np.float32)
            if arr.shape != tuple(shape):
                raise MXNetError("param %r has shape %s, want %s"
                                 % (name, arr.shape, tuple(shape)))
            tensors[name] = torch.from_numpy(arr.copy()).to(dev)
        return cls(spec, tensors)

    def params(self):
        """name -> tensor, the dict :func:`paged_step_apply` takes."""
        return dict(self.named_buffers())

    def to_numpy(self):
        return {k: v.detach().cpu().numpy() for k, v in self.params().items()}

    @property
    def device(self):
        return self.embed_weight.device

    def forward(self, pool_k, pool_v, tables, tokens, positions, valid,
                block_size, all_logits=False):
        return paged_step_apply(self.params(), pool_k, pool_v, tables,
                                tokens, positions, valid, self.spec,
                                block_size, all_logits=all_logits)


class _CallableModule(types.ModuleType):
    """``transformer_lm(...)`` builds the training symbol."""

    def __call__(self, *args, **kwargs):
        return get_symbol(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule
