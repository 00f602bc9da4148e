"""Decoder-only transformer LM in PyTorch: the training symbol and the
serving steps.

Counterpart of ``mxnet_tpu/models/transformer_lm.py``.  :func:`get_symbol`
builds the one-shot training graph (a copy of the reference's),
:func:`imperative_loss` the same graph from ``mx.nd`` ops with a
``softmax_cross_entropy`` loss (the imperative plane), and the serving
steps apply the same weights, under the same argument names, so
a model trained by ``Module`` is served as it is: :func:`paged_step_apply`
on the paged KV plane (fp32, bf16 or int8 pools), :func:`prefill_apply` and
:func:`decode_apply` on the contiguous plane.  Pre-norm blocks
(RMSNorm), learned q/k/v/proj projections without biases, a ReLU FFN at
4x width, a final LayerNorm and the ``pred`` head.  RMSNorm, LayerNorm,
the attention and the loss head go through the kernel wrappers (CUDA
kernel on a CUDA tensor, plain version on a CPU tensor); the large fp32
matrix products stay ``torch.matmul``, as the reference left them to
XLA, and int8 weights (:func:`quantize_lm_params`) go through the
``dequant_matmul`` kernel.

The module is callable: ``models.transformer_lm(seq_len, ...)`` is
:func:`get_symbol`, as the reference's ``models.transformer_lm``.
"""
from __future__ import annotations

import sys
import types

import numpy as np
import torch

from .. import symbol as sym
from ..base import MXNetError
from ..context import default_device
from ..kernels.dequant_matmul import (QuantizedWeight, dequant_matmul,
                                      quantize_int8)
from ..ops.attention import sdp_attention, sdp_attention_paged
from ..ops.nn import layer_norm, rms_norm

__all__ = ["get_symbol", "lm_spec", "param_shapes", "random_params",
           "init_pool", "init_scale_pool", "init_cache", "paged_step_apply",
           "prefill_apply", "decode_apply", "lm_matmul_weights",
           "quantize_lm_params", "TransformerLM", "imperative_loss"]


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


def imperative_loss(nd, params, data, label, seq_len, spec,
                    compute_dtype=None):
    """The graph of :func:`get_symbol` built imperatively from ``nd``'s
    ops (``mx.nd``; any module with the reference's ``nd`` op functions),
    ending in ``nd.softmax_cross_entropy`` over the flattened logits
    instead of the SoftmaxOutput head: the summed loss, shape ``(1,)``,
    whose gradient per token is SoftmaxOutput's ``p - onehot``.
    ``params`` maps :func:`get_symbol`'s argument names to NDArrays;
    ``data`` and ``label`` are ``(batch, seq_len)`` token grids.

    ``compute_dtype`` (``'bfloat16'``): mixed precision as a user writes
    it, each floating parameter through ``nd.Cast`` before use, so the
    forward and backward run in that dtype while the gradients reach
    the master parameters in theirs; the loss comes back in it.
    ``data`` (read only as indices) and ``label`` keep their dtype, the
    rule of ``Module(compute_dtype=...)``."""
    if compute_dtype is not None:
        params = {k: nd.Cast(v, dtype=compute_dtype)
                  if str(v.dtype).startswith(("float", "bfloat")) else v
                  for k, v in params.items()}
    D, H = spec["num_hidden"], spec["num_heads"]
    x = nd.Embedding(data, params["embed_weight"],
                     input_dim=spec["vocab_size"], output_dim=D)
    for i in range(spec["num_layers"]):
        p = {k: params["blk%d_%s" % (i, k)] for k in _BLOCK_KEYS}
        a = nd.Reshape(nd.RMSNorm(x, p["ln1_gamma"]), shape=(-1, D))

        def heads(tag, a=a, p=p):
            proj = nd.FullyConnected(a, p[tag + "_weight"], num_hidden=D,
                                     no_bias=True)
            return nd.transpose(nd.Reshape(proj, shape=(-1, seq_len, H,
                                                        D // H)),
                                axes=(0, 2, 1, 3))

        att = nd.DotProductAttention(heads("q"), heads("k"), heads("v"),
                                     causal=True)
        att = nd.Reshape(nd.transpose(att, axes=(0, 2, 1, 3)),
                         shape=(-1, D))
        proj = nd.FullyConnected(att, p["proj_weight"], num_hidden=D,
                                 no_bias=True)
        x = x + nd.Reshape(proj, shape=(-1, seq_len, D))
        f = nd.Reshape(nd.RMSNorm(x, p["ln2_gamma"]), shape=(-1, D))
        f = nd.Activation(nd.FullyConnected(f, p["ffn1_weight"],
                                            p["ffn1_bias"],
                                            num_hidden=4 * D),
                          act_type="relu")
        f = nd.FullyConnected(f, p["ffn2_weight"], p["ffn2_bias"],
                              num_hidden=D)
        x = x + nd.Reshape(f, shape=(-1, seq_len, D))
    h = nd.LayerNorm(x, params["final_ln_gamma"], params["final_ln_beta"])
    logits = nd.FullyConnected(nd.Reshape(h, shape=(-1, D)),
                               params["pred_weight"], params["pred_bias"],
                               num_hidden=spec["vocab_size"])
    return nd.softmax_cross_entropy(logits, nd.Reshape(label, shape=(-1,)))

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
    """The 2D matmul weights of the LM argument set: the params int8
    weight-only serving quantizes (norm scales and biases stay fp32)."""
    names = ["embed_weight", "pred_weight"]
    for i in range(spec["num_layers"]):
        names += ["blk%d_%s" % (i, k) for k in
                  ("q_weight", "k_weight", "v_weight", "proj_weight",
                   "ffn1_weight", "ffn2_weight")]
    return names


def _quant_pair(value):
    """``(codes, scales)`` of an int8 weight — a :class:`QuantizedWeight`,
    the JAX package's carrier (``.codes``/``.scales``) or a pair — or
    None for a plain array."""
    if isinstance(value, tuple) and len(value) == 2:
        return value
    if hasattr(value, "codes") and hasattr(value, "scales"):
        return value.codes, value.scales
    return None


def quantize_lm_params(params, spec, granularity=None):
    """int8 weight-only transform of an LM param dict: every fp32 matmul
    weight (:func:`lm_matmul_weights`) becomes a
    :class:`~..kernels.dequant_matmul.QuantizedWeight` of CPU tensors,
    quantized by :func:`~..kernels.dequant_matmul.quantize_int8` (the
    reference's codes, bit for bit); int8 weights already given and
    everything else pass through.  The input dict is not mutated."""
    quant = set(lm_matmul_weights(spec))
    out = {}
    for k, v in params.items():
        if k in quant and _quant_pair(v) is None:
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            codes, scales = quantize_int8(v, granularity)
            out[k] = QuantizedWeight(torch.from_numpy(codes),
                                     torch.from_numpy(scales))
        else:
            out[k] = v
    return out


def init_pool(spec, num_blocks, block_size, dtype=torch.float32,
              device=None):
    """Zeroed paged KV pool pair, each ``(num_layers, num_heads,
    num_blocks * block_size, head_dim)``.  Block 0 is the reserved trash
    block: pad writes land there and no real table entry points at
    it.  ``dtype=torch.bfloat16`` halves the bytes of a token;
    ``dtype=torch.int8`` makes the int8 plane's code pools."""
    dh = spec["num_hidden"] // spec["num_heads"]
    shape = (spec["num_layers"], spec["num_heads"],
             int(num_blocks) * int(block_size), dh)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_scale_pool(spec, num_blocks, device=None):
    """Per-(layer, head, physical block) fp32 absmax scale pools of the
    int8 paged plane: a ``(num_layers, num_heads, num_blocks)`` pair of
    ones (``quantize_int8``'s empty-block convention; zero codes
    dequantize to zero under any scale)."""
    shape = (spec["num_layers"], spec["num_heads"], int(num_blocks))
    return (torch.ones(shape, dtype=torch.float32, device=device),
            torch.ones(shape, dtype=torch.float32, device=device))


def init_cache(spec, batch, cache_len, dtype=torch.float32, device=None):
    """Zeroed contiguous KV cache pair, each ``(num_layers, batch,
    num_heads, cache_len, head_dim)``; ``dtype=torch.bfloat16`` halves
    the bytes of a token."""
    dh = spec["num_hidden"] // spec["num_heads"]
    shape = (spec["num_layers"], int(batch), spec["num_heads"],
             int(cache_len), dh)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _block_params(params, i):
    return {k: params["blk%d_%s" % (i, k)] for k in _BLOCK_KEYS}


def _mm(x2d, w):
    """``x @ w^T``: a :class:`QuantizedWeight` goes through the
    ``dequant_matmul`` kernel, a plain weight is one ``torch.matmul``."""
    if isinstance(w, QuantizedWeight):
        return dequant_matmul(x2d.contiguous(), w.codes, w.scales)
    return torch.matmul(x2d, w.t())


def _embed(w, tokens):
    """Embedding gather; quantized rows are gathered as codes and
    multiplied by their row's scale (plain torch, as the reference has
    no kernel here)."""
    ids = tokens.long()
    if isinstance(w, QuantizedWeight):
        scales = w.scales.float().reshape(-1).expand(w.codes.shape[0])
        return w.codes[ids].float() * scales[ids][..., None]
    return torch.nn.functional.embedding(ids, w)


def _ffn(x2d, bp):
    f = torch.relu(_mm(x2d, bp["ffn1_weight"]) + bp["ffn1_bias"])
    return _mm(f, bp["ffn2_weight"]) + bp["ffn2_bias"]


def _logits(params, h2d):
    return _mm(h2d, params["pred_weight"]) + params["pred_bias"]


def _requant_plan(tables, pos, valid, Lq, bs):
    """Index plan of the int8 block requantization: the physical blocks
    each row's write touches (``phys_flat``, ``(B*A,)``, 0 where a slot
    of the static bound ``A`` is unused), their pool rows (``ws_rows``)
    and where each fresh row lands in the gathered working set (``loc``;
    pad rows land on a dummy row past its end)."""
    B, T = tables.shape
    dev = tables.device
    r = torch.arange(Lq, device=dev)
    p = pos[:, None] + r[None, :]
    # static bound on the blocks one row's write can touch: the chunk
    # may start on a block's last row
    A = (Lq + bs - 2) // bs + 1
    first_log = pos // bs
    aff_log = first_log[:, None] + torch.arange(A, device=dev)[None, :]
    last_log = (pos + valid - 1) // bs
    aff_ok = (aff_log <= last_log[:, None]) & (aff_log < T)
    phys = torch.where(aff_ok, tables.gather(1, aff_log.clamp(0, T - 1)),
                       torch.zeros_like(aff_log))
    phys_flat = phys.reshape(-1)
    ws_rows = (phys_flat[:, None] * bs +
               torch.arange(bs, device=dev)[None, :]).reshape(-1)
    loc = (torch.arange(B, device=dev)[:, None] * (A * bs) +
           (p // bs - first_log[:, None]) * bs + p % bs)
    loc = torch.where(r[None, :] < valid[:, None], loc,
                      torch.full_like(loc, B * A * bs)).reshape(-1)
    return phys_flat, ws_rows, loc


def _requant_write(pool_i, scale_i, fresh, plan, bs):
    """Requantize, in place, the blocks one layer's write touches:
    dequantize each block, overlay the fresh fp32 rows ``(B*Lq, H,
    dh)``, pick its absmax scale again and re-encode.  The reference's
    arithmetic: ``scale = absmax / 127`` (1.0 for an empty block) and
    ``codes = clamp(round(block / scale), -127, 127)``, a division and
    round-half-to-even."""
    phys_flat, ws_rows, loc = plan
    H, dh = pool_i.shape[0], pool_i.shape[2]
    old = pool_i[:, ws_rows, :].permute(1, 0, 2).float()  # (B*A*bs, H, dh)
    sc = torch.repeat_interleave(scale_i[:, phys_flat], bs, dim=1)
    ws = torch.cat([old * sc.t()[:, :, None],
                    old.new_zeros((1, H, dh))])
    ws[loc] = fresh
    blk = ws[:-1].reshape(-1, bs, H, dh)                   # (B*A, bs, H, dh)
    absmax = blk.abs().amax(dim=(1, 3))                    # (B*A, H)
    new_sc = torch.where(absmax > 0, absmax / 127.0,
                         torch.ones_like(absmax))
    codes = torch.clamp(torch.round(blk / new_sc[:, None, :, None]),
                        -127, 127).to(torch.int8)
    pool_i[:, ws_rows, :] = codes.reshape(-1, H, dh).permute(1, 0, 2)
    scale_i[:, phys_flat] = new_sc.t()


def paged_step_apply(params, pool_k, pool_v, tables, tokens, positions,
                     valid, spec, block_size, scales=None,
                     all_logits=False):
    """One paged step: a prefill chunk (``Lq > 1``) or a decode step
    (``Lq = 1``) of the paged KV plane.

    tokens: (B, Lq) int — row r of sequence b sits at global position
    ``positions[b] + r``; valid: (B,) int — rows ``r < valid[b]`` are real
    (``1 <= valid <= Lq``), the rest are pad; tables: (B, T) int block
    tables over the pools ``(L, H, num_blocks * block_size, dh)`` of
    :func:`init_pool`.  Table entries past a sequence's frontier must
    point at a valid block, conventionally the trash block 0.  Inputs may
    be numpy arrays or tensors; they are moved to the pools' device.
    Params may hold :class:`QuantizedWeight` pairs (int8 weights) or be
    bf16 (bf16 compute: the activations follow the weights' dtype).

    Each layer writes the chunk's K/V to pool rows ``tables[b, p // bs] *
    bs + p % bs`` and attends through :func:`sdp_attention_paged`; pad
    rows write into the trash block (row ``p % bs`` of block 0), where
    no real query ever looks.  The pools are updated IN PLACE
    (``index_put_``) — the counterpart of the reference's donated pool
    arguments — and returned for symmetry with it.  Rows that index the
    same pool row in one step may only ever be pad rows in the trash
    block, or recomputed prompt rows writing identical values.

    On a float pool (fp32 or bf16) the K/V rows are written in the
    pool's dtype and the queries attend in it; the attention output is
    cast to the activations' dtype before the ``proj`` product, as the
    reference casts (``q.astype(cdt)``, ``att.astype(x.dtype)``).

    ``scales`` — ``(scale_k, scale_v)`` from :func:`init_scale_pool` —
    selects the int8 pool layout: the pools hold int8 codes with
    per-(layer, head, physical block) fp32 scales, the cache write
    becomes a block requantization (:func:`_requant_write`, in place on
    codes and scales), attention dequantizes through the ``kv_scales``
    door, and the return gains the scale pools.  Blocks a row writes
    must be its own (the engine forks shared ones first); the trash
    block takes garbage from several rows.

    Returns ``(logits, pool_k, pool_v)`` (int8 KV: ``(logits, pool_k,
    pool_v, scale_k, scale_v)``): fp32 logits ``(B, vocab)`` at each
    row's last valid position, or ``(B, Lq, vocab)`` for every row with
    ``all_logits=True``."""
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
    int8_kv = scales is not None
    if int8_kv:
        scale_k, scale_v = scales
        plan = _requant_plan(tables32.long(), pos32.long(), valid, Lq, bs)
    else:
        # a pad row's logical block may lie past the table: clamp the
        # lookup (its destination is replaced by the trash block below)
        blk = tables32.long().gather(1, torch.clamp(p // bs, max=T - 1))
        dest = torch.where(r[None, :] < valid[:, None], blk * bs + p % bs,
                           p % bs).reshape(-1)               # (B*Lq,)

    x = _embed(params["embed_weight"], tokens)               # (B, Lq, D)
    for i in range(L):
        bp = _block_params(params, i)
        a2 = rms_norm(x, bp["ln1_gamma"], 1e-6).reshape(-1, D)
        q = _mm(a2, bp["q_weight"]).reshape(B, Lq, H, dh)
        k = _mm(a2, bp["k_weight"]).reshape(B * Lq, H, dh)
        v = _mm(a2, bp["v_weight"]).reshape(B * Lq, H, dh)
        q = q.permute(0, 2, 1, 3).contiguous()
        if int8_kv:
            _requant_write(pool_k[i], scale_k[i], k.float(), plan, bs)
            _requant_write(pool_v[i], scale_v[i], v.float(), plan, bs)
            att = sdp_attention_paged(q, pool_k[i], pool_v[i], tables32,
                                      pos32, bs,
                                      kv_scales=(scale_k[i], scale_v[i]))
        else:
            # (H, rows, dh) viewed as (rows, H, dh): row-indexed write
            pool_k[i].transpose(0, 1).index_put_((dest,),
                                                 k.to(pool_k.dtype))
            pool_v[i].transpose(0, 1).index_put_((dest,),
                                                 v.to(pool_v.dtype))
            # q in the pool's dtype, as the reference's q.astype(cdt)
            att = sdp_attention_paged(q.to(pool_k.dtype), pool_k[i],
                                      pool_v[i], tables32, pos32, bs)
        att = att.permute(0, 2, 1, 3).reshape(-1, D).to(x.dtype)
        x = x + _mm(att, bp["proj_weight"]).reshape(B, Lq, D)
        f = rms_norm(x, bp["ln2_gamma"], 1e-6).reshape(-1, D)
        x = x + _ffn(f, bp).reshape(B, Lq, D)
    h = layer_norm(x, params["final_ln_gamma"], params["final_ln_beta"],
                   1e-5)
    if all_logits:
        logits = _logits(params, h.reshape(-1, D)).reshape(
            B, Lq, spec["vocab_size"])
    else:
        last = h[torch.arange(B, device=dev), valid - 1]     # (B, D)
        logits = _logits(params, last)
    if int8_kv:
        return logits.float(), pool_k, pool_v, scale_k, scale_v
    return logits.float(), pool_k, pool_v


def prefill_apply(params, tokens, lengths, cache_len, spec,
                  cache_dtype=torch.float32):
    """Contiguous plane: run a padded prompt batch once and fill a KV
    cache.

    tokens: (B, P) int, zero-padded past each sequence's length (the
    lengths do not enter the computation: causal attention keeps every
    real position from seeing the pad).  Returns ``(logits (B, P, vocab)
    fp32, k_cache, v_cache)``, the caches ``(L, B, H, cache_len, dh)``
    in ``cache_dtype`` holding K/V for positions 0..P-1 and zeros past
    P.  Pad positions write junk K/V inside 0..P-1, which the decode
    steps overwrite from each sequence's length on and the offset-causal
    mask hides until then.  Attention is the causal ``flash_attention``
    on the compute-dtype K/V, as in the reference: a bf16 cache rounds
    only what the decode steps read.  Params may be bf16 (the
    activations follow the weights' dtype) or int8
    :class:`QuantizedWeight` pairs."""
    del lengths
    L, D = spec["num_layers"], spec["num_hidden"]
    H = spec["num_heads"]
    dh = D // H
    dev = params["final_ln_gamma"].device
    tokens = torch.as_tensor(tokens, device=dev)
    B, P = tokens.shape
    x = _embed(params["embed_weight"], tokens)               # (B, P, D)
    ks, vs = [], []
    for i in range(L):
        bp = _block_params(params, i)
        a2 = rms_norm(x, bp["ln1_gamma"], 1e-6).reshape(-1, D)
        q, k, v = (_mm(a2, bp[t]).reshape(B, P, H, dh).permute(0, 2, 1, 3)
                   for t in ("q_weight", "k_weight", "v_weight"))
        pad = (0, 0, 0, int(cache_len) - P)
        ks.append(torch.nn.functional.pad(k.to(cache_dtype), pad))
        vs.append(torch.nn.functional.pad(v.to(cache_dtype), pad))
        att = sdp_attention(q, k, v, causal=True)
        att = att.permute(0, 2, 1, 3).reshape(-1, D)
        x = x + _mm(att, bp["proj_weight"]).reshape(B, P, D)
        f = rms_norm(x, bp["ln2_gamma"], 1e-6).reshape(-1, D)
        x = x + _ffn(f, bp).reshape(B, P, D)
    h = layer_norm(x, params["final_ln_gamma"], params["final_ln_beta"],
                   1e-5)
    logits = _logits(params, h.reshape(-1, D)).reshape(
        B, P, spec["vocab_size"])
    return logits.float(), torch.stack(ks), torch.stack(vs)


def decode_apply(params, cache_k, cache_v, tokens, lengths, spec):
    """Contiguous plane: one decode step.  Embed one token per sequence,
    write its K/V at each sequence's cache frontier, attend
    offset-causally over the cache (``flash_attention_offset``) and
    emit next-token logits.

    tokens: (B,) int; lengths: (B,) int cache frontiers (the new token's
    position, ``< cache_len``); caches ``(L, B, H, cache_len, dh)`` from
    :func:`prefill_apply` / :func:`init_cache`, updated IN PLACE (the
    reference donates them).  The caches' dtype rules, as the
    reference's: the fresh K/V are written in it and q is cast to it
    before attention (fp32 compute over a bf16 cache rounds q to bf16,
    bf16 compute over an fp32 cache widens it); the attention output is
    cast back to the activations' dtype.  Returns ``(logits (B, vocab)
    fp32, cache_k, cache_v)``."""
    L, D = spec["num_layers"], spec["num_hidden"]
    H = spec["num_heads"]
    dh = D // H
    dev = cache_k.device
    tokens = torch.as_tensor(tokens, device=dev)
    B = tokens.shape[0]
    lengths32 = torch.as_tensor(lengths, device=dev).to(torch.int32)
    lengths32 = lengths32.contiguous()
    rows = torch.arange(B, device=dev)
    cols = lengths32.long()
    x = _embed(params["embed_weight"], tokens)               # (B, D)
    for i in range(L):
        bp = _block_params(params, i)
        a = rms_norm(x, bp["ln1_gamma"], 1e-6)
        q, k, v = (_mm(a, bp[t]).reshape(B, H, 1, dh)
                   for t in ("q_weight", "k_weight", "v_weight"))
        # (B, H, C, dh) indexed [b, :, lengths[b]]: (B, H, dh) in place
        cache_k[i][rows, :, cols] = k[:, :, 0].to(cache_k.dtype)
        cache_v[i][rows, :, cols] = v[:, :, 0].to(cache_v.dtype)
        att = sdp_attention(q.to(cache_k.dtype), cache_k[i], cache_v[i],
                            q_offsets=lengths32)
        x = x + _mm(att.reshape(B, D).to(x.dtype), bp["proj_weight"])
        f = rms_norm(x, bp["ln2_gamma"], 1e-6)
        x = x + _ffn(f, bp)
    h = layer_norm(x, params["final_ln_gamma"], params["final_ln_beta"],
                   1e-5)
    return _logits(params, h).float(), cache_k, cache_v


def _as_weight(name, value, shape, dev):
    """One parameter onto ``dev``: an fp32 array or tensor, or int8
    ``(codes, scales)`` — a :class:`QuantizedWeight`, a JAX-side
    carrier's ``.codes``/``.scales``, or a pair of arrays — taken as
    they are."""
    pair = _quant_pair(value)
    if pair is None:
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        arr = np.asarray(value, np.float32)
        if arr.shape != tuple(shape):
            raise MXNetError("param %r has shape %s, want %s"
                             % (name, arr.shape, tuple(shape)))
        return torch.from_numpy(arr.copy()).to(dev)
    c, s = (t.detach().cpu() if isinstance(t, torch.Tensor)
            else torch.from_numpy(np.array(t)) for t in pair)
    if tuple(c.shape) != tuple(shape) or c.dtype != torch.int8:
        raise MXNetError("param %r: int8 codes of shape %s expected, got "
                         "%s %s" % (name, tuple(shape), c.dtype,
                                    tuple(c.shape)))
    if s.dtype != torch.float32 or tuple(s.shape) not in ((shape[0],), ()):
        raise MXNetError("param %r: fp32 scales of shape (%d,) or () "
                         "expected, got %s %s" % (name, shape[0], s.dtype,
                                                  tuple(s.shape)))
    return QuantizedWeight(c.contiguous().to(dev), s.contiguous().to(dev))


class TransformerLM:
    """The LM's weights by the reference's argument names
    (``embed_weight``, ``blk0_q_weight``, ...) on one device: fp32
    tensors, and :class:`QuantizedWeight` pairs for int8 matmul
    weights."""

    def __init__(self, spec, params):
        self.spec = lm_spec(**dict(spec))
        self._params = dict(params)

    @classmethod
    def from_numpy(cls, params, spec, device=None):
        """Carry the reference package's parameter dict (name -> numpy
        array, e.g. its ``random_params`` or a checkpoint's arg_params)
        into the port.  A value may also be int8 ``(codes, scales)``: a
        :class:`QuantizedWeight`, the JAX package's carrier, or a numpy
        pair, taken bit for bit.  ``device`` defaults to ``cuda:0``;
        pass "cpu" for the plain versions."""
        spec = lm_spec(**dict(spec))
        dev = default_device(device)
        out = {}
        for name, shape in param_shapes(spec):
            if name not in params:
                raise MXNetError("transformer LM is missing param %r"
                                 % name)
            out[name] = _as_weight(name, params[name], shape, dev)
        return cls(spec, out)

    def params(self):
        """name -> tensor or QuantizedWeight, the dict the step
        functions take."""
        return dict(self._params)

    def astype(self, dtype):
        """A model whose floating tensors are cast to ``dtype`` (bf16
        serving casts every floating weight once, at load, as the
        reference's store does); int8 codes and their fp32 scales stay
        as they are."""
        return type(self)(self.spec, {
            k: v.to(dtype) if isinstance(v, torch.Tensor) and
            v.is_floating_point() else v
            for k, v in self._params.items()})

    def to_numpy(self):
        """name -> fp32 numpy array (bf16 weights widened), or a
        ``(codes, scales)`` numpy pair for an int8 weight."""
        out = {}
        for k, v in self._params.items():
            if isinstance(v, QuantizedWeight):
                out[k] = (v.codes.cpu().numpy(), v.scales.cpu().numpy())
            else:
                out[k] = v.detach().float().cpu().numpy()
        return out

    @property
    def device(self):
        return self._params["final_ln_gamma"].device

    def __call__(self, pool_k, pool_v, tables, tokens, positions, valid,
                 block_size, all_logits=False, scales=None):
        """:func:`paged_step_apply` on these weights."""
        return paged_step_apply(self._params, pool_k, pool_v, tables,
                                tokens, positions, valid, self.spec,
                                block_size, scales=scales,
                                all_logits=all_logits)


class _CallableModule(types.ModuleType):
    """``transformer_lm(...)`` builds the training symbol."""

    def __call__(self, *args, **kwargs):
        return get_symbol(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule
