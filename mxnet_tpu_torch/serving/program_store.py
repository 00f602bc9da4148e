"""Program stores of the serving plane, in PyTorch.

Counterpart of ``mxnet_tpu/serving/program_store.py``.  The forward
plane's :class:`ProgramStore` (bucketed inference over a symbol graph,
which ``ServingEngine`` and the serving ``Predictor`` run) is described
in its class docstring.  The rest of this docstring is about
``GenerativeProgramStore``, for both KV planes: the paged
plane (the default) and the contiguous plane (``paged=False``).  The
reference compiles one program per (kind, batch bucket, length bucket)
ahead of time; the port runs eagerly, so a "program" here is one call of
:func:`~..models.transformer_lm.paged_step_apply`, or of
:func:`~..models.transformer_lm.prefill_apply` /
:func:`~..models.transformer_lm.decode_apply`, on the store's weights
(capturing those calls in CUDA graphs is later work).  The store owns
the weights (fp32, or int8 codes with ``compute_dtype='int8'``), the
bucket geometry and the request checks; the KV pool or cache is made by
the store (``new_pool`` / ``new_scale_pool`` / ``new_cache``) and owned
by the decode engine's per-model state.  bf16 weights
(``compute_dtype='bfloat16'``) and a bf16 pool or cache
(``kv_dtype='bfloat16'``) serve on either plane, alone or beside int8,
as in the reference.

Sampling runs on the logits' device: greedy rows are an argmax (first
index on ties); temperature / top-k rows draw from per-slot
``torch.Generator`` objects seeded from the request seed.  Those give
other numbers than the reference's threefry keys, so sampled streams
equal the reference's only in distribution; greedy streams are exact.

Speculative decoding (paged plane only) adds two step kinds: the draft
model's proposal step (:meth:`GenerativeProgramStore.
run_paged_step_sample_p`, an lq=1 step that also returns the proposal
distribution) and the target's verify step (:meth:`GenerativeProgramStore.
run_paged_verify`, all K+1 positions in one paged step with the
accept/reject rule, :func:`spec_verify`, on the device).
"""
from __future__ import annotations

import collections
import logging
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from ..base import MXNetError, get_env
from ..context import default_device
from ..executor import evaluate, shape_overrides
from ..kernels.dequant_matmul import QuantizedWeight, quantize_int8
from ..ndarray import _torch_dtype
from ..models.transformer_lm import (TransformerLM, decode_apply,
                                     init_cache, init_pool,
                                     init_scale_pool, lm_spec,
                                     paged_step_apply, prefill_apply,
                                     quantize_lm_params)

__all__ = ["ProgramStore", "GenerativeProgramStore", "bucket_edges",
           "bucket_for", "sample_tokens", "sample_tokens_p", "spec_verify"]

log = logging.getLogger(__name__)

_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}


def _weight_bytes(values):
    """Resident bytes of parameter tensors grouped by storage dtype
    (numpy names, as the reference reports them): a QuantizedWeight
    counts its int8 codes and its fp32 scales."""
    by_dtype = {}
    for v in values:
        for t in ((v.codes, v.scales) if isinstance(v, QuantizedWeight)
                  else (v,)):
            dt = str(t.dtype).replace("torch.", "")
            by_dtype[dt] = by_dtype.get(dt, 0) + t.numel() * t.element_size()
    return {"total": sum(by_dtype.values()), "by_dtype": by_dtype}


def bucket_edges(edges=None, env_var="MXNET_SERVE_BUCKETS"):
    """Resolve bucket edges: an explicit iterable, or the ``env_var``
    comma list; returned sorted, deduplicated, all positive."""
    if edges is None:
        raw = get_env(env_var)
        edges = [int(tok) for tok in str(raw).split(",") if tok.strip()]
    out = sorted({int(e) for e in edges})
    if not out or out[0] < 1:
        raise MXNetError("serving bucket edges must be positive ints, "
                         "got %r" % (edges,))
    return tuple(out)


def bucket_for(n, edges):
    """Smallest edge >= n, or None when n exceeds the largest edge."""
    for e in edges:
        if n <= e:
            return e
    return None


def sample_tokens(logits, temps, top_ks, generators, do_sample=None):
    """One sampling step over ``(S, V)`` logits, on their device.

    Per slot: ``temps[s] <= 0`` is greedy (argmax, first index on ties);
    otherwise a draw from ``softmax(z)`` with ``z = logits / temp``
    restricted to the ``top_ks[s]`` highest values (``<= 0`` = the whole
    vocab; values tied with the k-th stay in), using ``generators[s]``.
    ``temps``/``top_ks``/``do_sample`` are host arrays; rows with
    ``do_sample`` False are not drawn (their generator does not advance)
    and return the greedy token, which the caller discards.  Returns an
    ``(S,)`` int32 tensor on the logits' device."""
    logits = logits.float()
    n_vocab = logits.shape[-1]
    out = torch.argmax(logits, dim=-1)
    for i in range(logits.shape[0]):
        if temps[i] <= 0 or (do_sample is not None and not do_sample[i]):
            continue
        z = logits[i] / max(float(temps[i]), 1e-6)
        k = int(top_ks[i])
        k = n_vocab if k <= 0 else min(max(k, 1), n_vocab)
        kth = torch.topk(z, k).values[-1]
        z = torch.where(z >= kth, z, torch.full_like(z, -float("inf")))
        out[i] = torch.multinomial(torch.softmax(z, dim=-1), 1,
                                   generator=generators[i])[0]
    return out.to(torch.int32)


def _masked_dist(logits, temps, top_ks):
    """The distribution :func:`sample_tokens` draws from, as explicit
    fp32 probabilities over ``(S, V)`` rows: the temperature and top-k
    masked softmax (values tied with the k-th stay in); greedy rows
    (``temps <= 0``) are one-hot at the argmax.  Speculative decoding's
    shared density: the draft's proposal distribution q and the
    target's acceptance distribution p both come from this function, so
    the rejection rule compares the densities the two samplers use.
    ``temps`` / ``top_ks`` are host arrays."""
    logits = logits.float()
    S, V = logits.shape
    dev = logits.device
    temps = torch.as_tensor(np.asarray(temps, np.float32), device=dev)
    k = torch.as_tensor(np.asarray(top_ks, np.int64), device=dev)
    z = logits / torch.clamp(temps, min=1e-6)[:, None]
    k = torch.clamp(torch.where(k <= 0, V, k), 1, V)
    kth = torch.sort(z, dim=-1, descending=True).values.gather(
        1, (k - 1)[:, None])
    z = torch.where(z >= kth, z, torch.full_like(z, -float("inf")))
    probs = torch.softmax(z, dim=-1)
    onehot = torch.nn.functional.one_hot(torch.argmax(logits, dim=-1),
                                         V).float()
    return torch.where((temps <= 0)[:, None], onehot, probs)


def sample_tokens_p(logits, temps, top_ks, generators, do_sample=None):
    """:func:`sample_tokens` that also returns the distribution ``q (S,
    V)`` each token was drawn from (:func:`_masked_dist`): the draft
    model's sampling step.  The tokens are the ones :func:`sample_tokens`
    draws from the same generator states.  Returns ``(tokens, q)``, both
    on the logits' device."""
    toks = sample_tokens(logits, temps, top_ks, generators, do_sample)
    return toks, _masked_dist(logits, temps, top_ks)


def spec_verify(logits_all, prop_toks, prop_q, generators, temps, top_ks,
                valid):
    """Speculative accept/reject (the standard rejection-sampling rule)
    over one verify step's logits, on their device.

    logits_all: (B, K+1, V) — the target's logits at the K+1 verified
    positions (row j conditions on the prompt and the first j
    proposals); prop_toks: (B, K) int — the draft's proposals; prop_q:
    (B, K, V) fp32 — the draft's distribution for each proposal
    (:func:`sample_tokens_p`); generators: per-slot ``torch.Generator``
    (None for greedy rows); temps / top_ks / valid: (B,) host arrays —
    row b verifies ``valid[b] - 1`` proposals (``1 <= valid <= K+1``).

    Greedy rows (``temps <= 0``) accept the longest prefix of proposals
    that equal the target's argmax and emit the argmax at the first
    mismatch: the tokens of non-speculative greedy decoding.  A sampled
    row draws K uniforms from its generator and accepts proposal j iff
    ``u_j * q_j(d_j) <= p_j(d_j)``; the first rejection resamples (one
    more draw) from ``max(p - q, 0)`` renormalized (from p itself where
    that sums to 0), and a window accepted in full draws the bonus token
    from p: streams distribution-identical to sampling from p alone.
    Greedy rows draw nothing.

    Returns ``(out_toks (B, K+1) int32, n_emit (B,) int32)`` on the
    device: row b emits ``out_toks[b, :n_emit[b]]``, ``1 <= n_emit <=
    valid``."""
    logits_all = logits_all.float()
    B, K1, V = logits_all.shape
    K = K1 - 1
    dev = logits_all.device
    temps = np.asarray(temps, np.float32)
    top_ks = np.asarray(top_ks, np.int64)
    prop_toks = torch.as_tensor(prop_toks, device=dev).long()
    prop_q = torch.as_tensor(prop_q, device=dev).float()
    valid = torch.as_tensor(np.asarray(valid), device=dev).long()
    greedy = torch.as_tensor(temps <= 0, device=dev)
    sampled = [b for b in range(B) if temps[b] > 0]
    p_full = _masked_dist(logits_all.reshape(B * K1, V),
                          np.repeat(temps, K1),
                          np.repeat(top_ks, K1)).reshape(B, K1, V)
    greedy_all = torch.argmax(logits_all, dim=-1)              # (B, K+1)
    u = torch.zeros((B, K), device=dev)
    for b in sampled:
        u[b] = torch.rand(K, generator=generators[b], device=dev)
    pd = p_full[:, :K].gather(-1, prop_toks[..., None])[..., 0]
    qd = prop_q.gather(-1, prop_toks[..., None])[..., 0]
    acc = torch.where(greedy[:, None], prop_toks == greedy_all[:, :K],
                      u * qd <= pd)
    acc &= torch.arange(1, K + 1, device=dev)[None, :] < valid[:, None]
    a = torch.cumprod(acc.long(), dim=1).sum(dim=1)             # (B,)
    rows = torch.arange(B, device=dev)
    p_a = p_full[rows, a]                                       # (B, V)
    q_ext = torch.cat([prop_q, prop_q.new_zeros((B, 1, V))], dim=1)
    # the bonus position (a full accept) has no proposal: its residual
    # is p itself
    q_a = torch.where((a >= valid - 1)[:, None], 0.0, q_ext[rows, a])
    res = torch.clamp(p_a - q_a, min=0.0)
    tot = res.sum(dim=-1, keepdim=True)
    res = torch.where(tot > 0, res / torch.where(tot > 0, tot, 1.0), p_a)
    corrected = greedy_all[rows, a]
    for b in sampled:
        corrected[b] = torch.multinomial(res[b], 1,
                                         generator=generators[b])[0]
    out = torch.cat([prop_toks, prop_toks.new_zeros((B, 1))], dim=1)
    out[rows, a] = corrected
    return out.to(torch.int32), (a + 1).to(torch.int32)


class GenerativeProgramStore:
    """Weights, bucket geometry and step calls of one autoregressive LM.

    Arguments mirror the reference store: ``params`` (name -> array, the
    ``transformer_lm`` argument names), ``spec`` (``lm_spec``),
    ``batch_buckets`` / ``prompt_buckets`` / ``kv_block`` / ``kv_max`` /
    ``prefill_chunk`` / ``pool_blocks`` (defaults from the
    ``MXNET_SERVE_*`` knobs), and ``device`` (default ``cuda:0``; pass
    ``"cpu"`` for the plain versions).

    ``compute_dtype``: ``None``/``'float32'`` serves the fp32 weights;
    ``'bfloat16'`` casts every floating weight to bf16 once at load, so
    the activations and the norms run in bf16 (the logits come back
    fp32); ``'int8'`` quantizes every matmul weight
    (``quantize_lm_params``, ``MXNET_SERVE_INT8_GRANULARITY``) and runs
    its products through the ``dequant_matmul`` kernel.  ``kv_dtype``
    (default ``MXNET_SERVE_KV_DTYPE``): ``'float32'``, ``'bfloat16'``
    (half the bytes a token) or ``'int8'`` — int8 pool codes with
    per-(layer, head, block) fp32 scale pools.  ``paged`` (default
    ``MXNET_SERVE_PAGED``): the paged KV plane, or ``False`` for the
    contiguous plane (per-slot cache rectangles, one prefill per
    admitted group, decode steps through ``flash_attention_offset``).
    The contiguous plane takes fp32 and bf16 caches; int8 KV there
    raises :class:`MXNetError`, as in the reference."""

    def __init__(self, params, spec, name="lm", batch_buckets=None,
                 prompt_buckets=None, kv_block=None, kv_max=None,
                 compute_dtype=None, kv_dtype=None, paged=None,
                 prefill_chunk=None, pool_blocks=None, device=None):
        self._spec = lm_spec(**dict(spec))
        self.name = name
        self._compute = None
        if compute_dtype:
            c = str(compute_dtype).lower()
            if c in ("float32", "fp32"):
                c = None
            elif c not in ("bfloat16", "int8"):
                raise MXNetError(
                    "generative compute_dtype must be None/'float32'/"
                    "'bfloat16'/'int8', got %r" % compute_dtype)
            self._compute = c
        kv = str(kv_dtype if kv_dtype is not None
                 else get_env("MXNET_SERVE_KV_DTYPE") or "float32")
        if kv not in _KV_DTYPES:
            raise MXNetError("kv_dtype must be 'float32', 'bfloat16' or "
                             "'int8', got %r" % kv)
        self.kv_int8 = kv == "int8"
        self.kv_dtype = _KV_DTYPES[kv]
        self.device = default_device(device)
        self._batch_edges = bucket_edges(batch_buckets)
        self._prompt_edges = bucket_edges(
            prompt_buckets, env_var="MXNET_SERVE_PROMPT_BUCKETS")
        self.kv_block = int(kv_block if kv_block is not None
                            else get_env("MXNET_SERVE_KV_BLOCK"))
        self.kv_max = int(kv_max if kv_max is not None
                          else get_env("MXNET_SERVE_KV_MAX"))
        if self.kv_block < 1 or self.kv_max < self.kv_block:
            raise MXNetError("need 1 <= kv_block <= kv_max, got %d/%d"
                             % (self.kv_block, self.kv_max))
        if self._prompt_edges[-1] > self.kv_max:
            raise MXNetError(
                "largest prompt bucket (%d) exceeds MXNET_SERVE_KV_MAX "
                "(%d)" % (self._prompt_edges[-1], self.kv_max))
        self.paged = bool(int(get_env("MXNET_SERVE_PAGED"))
                          if paged is None else paged)
        if self.kv_int8 and not self.paged:
            raise MXNetError(
                "kv_dtype='int8' needs the paged KV plane (the scales "
                "are per pool block); set MXNET_SERVE_PAGED=1 or use "
                "'float32' on the contiguous plane")
        chunk = int(prefill_chunk if prefill_chunk is not None
                    else get_env("MXNET_SERVE_PREFILL_CHUNK"))
        if chunk < 1:
            raise MXNetError("prefill_chunk must be >= 1, got %d" % chunk)
        self.prefill_chunk = min(chunk, self.kv_max)
        nb = int(pool_blocks if pool_blocks is not None
                 else get_env("MXNET_SERVE_KV_POOL_BLOCKS"))
        if nb <= 0:
            # the largest batch bucket at full kv_max depth, plus the
            # reserved trash block 0
            nb = self._batch_edges[-1] * self.table_width() + 1
        if self.paged and nb < self.table_width() + 1:
            raise MXNetError(
                "paged KV pool of %d blocks cannot hold one full-depth "
                "sequence (%d blocks + the reserved trash block); raise "
                "MXNET_SERVE_KV_POOL_BLOCKS" % (nb, self.table_width()))
        self.pool_blocks = nb
        self.model = TransformerLM.from_numpy(self._load_params(params),
                                              self._spec, self.device)
        if self._compute == "bfloat16":
            # numpy has no bf16: the weights cross as fp32 and are cast
            # once here, as the reference's store casts them at load
            self.model = self.model.astype(torch.bfloat16)
        # live decode state, attached by the GenerationEngine
        self.cache_state = None

    def _load_params(self, params):
        """The weight dict through the serving dtype policy: fp32 as
        given (bf16 is cast after the crossing, in ``__init__``), or
        (``compute_dtype='int8'``) every fp32 matmul weight
        quantized by the port's copy of the reference's codec; int8
        ``(codes, scales)`` already given pass as they are."""
        if self._compute != "int8":
            return params
        return quantize_lm_params(params, self._spec)

    # -- geometry ------------------------------------------------------
    @property
    def spec(self):
        return dict(self._spec)

    def max_slots(self):
        return self._batch_edges[-1]

    def batch_bucket(self, n):
        b = bucket_for(n, self._batch_edges)
        if b is None:
            raise MXNetError("batch of %d sequences exceeds the largest "
                             "serving bucket (%d)"
                             % (n, self._batch_edges[-1]))
        return b

    def prompt_bucket(self, p):
        b = bucket_for(p, self._prompt_edges)
        if b is None:
            raise MXNetError(
                "prompt of %d tokens exceeds the largest prompt bucket "
                "(%d); raise MXNET_SERVE_PROMPT_BUCKETS or truncate"
                % (p, self._prompt_edges[-1]))
        return b

    def kv_bucket(self, length):
        """Cache length quantized UP to the kv-block quantum."""
        length = max(1, int(length))
        c = -(-length // self.kv_block) * self.kv_block
        if c > self.kv_max:
            raise MXNetError(
                "sequence needs a %d-token cache, past MXNET_SERVE_KV_"
                "MAX (%d)" % (c, self.kv_max))
        return c

    def table_width(self):
        """Logical blocks needed to address a full kv_max sequence."""
        return -(-self.kv_max // self.kv_block)

    def validate_request(self, prompt_len, max_tokens):
        """Reject at submit anything that could outgrow kv_max
        mid-flight: on the paged plane also the pool's usable blocks, on
        the contiguous plane a prompt past the largest prompt bucket."""
        need = int(prompt_len) + max(1, int(max_tokens))
        if need > self.kv_max:
            raise MXNetError(
                "prompt_len %d + max_tokens %d exceeds MXNET_SERVE_KV_"
                "MAX (%d)" % (prompt_len, max_tokens, self.kv_max))
        if self.paged:
            blocks = -(-need // self.kv_block)
            if blocks > self.pool_blocks - 1:
                raise MXNetError(
                    "request needs %d KV blocks, past the paged pool's %d "
                    "usable blocks (MXNET_SERVE_KV_POOL_BLOCKS)"
                    % (blocks, self.pool_blocks - 1))
        else:
            self.prompt_bucket(int(prompt_len))

    # -- KV state ------------------------------------------------------
    def new_pool(self):
        """Zeroed K/V pool pair, ``(num_layers, num_heads, pool_blocks *
        kv_block, head_dim)`` in the store's KV dtype (fp32, bf16, or
        int8 codes) on its device."""
        return init_pool(self._spec, self.pool_blocks, self.kv_block,
                         dtype=self.kv_dtype, device=self.device)

    def new_scale_pool(self):
        """The int8 plane's ``(num_layers, num_heads, pool_blocks)`` fp32
        scale pools, all ones, beside :meth:`new_pool`'s code pools."""
        return init_scale_pool(self._spec, self.pool_blocks,
                               device=self.device)

    def new_cache(self, batch, cache_len):
        """Zeroed contiguous K/V cache pair, ``(num_layers, batch,
        num_heads, cache_len, head_dim)`` in the store's KV dtype (fp32
        or bf16) on its device."""
        return init_cache(self._spec, batch, cache_len, dtype=self.kv_dtype,
                          device=self.device)

    def copy_block(self, pool_k, pool_v, src, dst, scales=None):
        """Copy-on-write fork: copy physical block ``src``'s rows into
        block ``dst`` of both pools, in place.  With ``scales`` (the int8
        plane's ``(scale_k, scale_v)``) the block's scales fork with its
        codes — a block decodes only as codes and scale together — and
        the return grows to ``(pool_k, pool_v, scale_k, scale_v)``."""
        bs = self.kv_block
        for pool in (pool_k, pool_v):
            pool[:, :, dst * bs:(dst + 1) * bs].copy_(
                pool[:, :, src * bs:(src + 1) * bs])
        if scales is None:
            return pool_k, pool_v
        for sc in scales:
            sc[:, :, dst].copy_(sc[:, :, src])
        return (pool_k, pool_v) + tuple(scales)

    # -- execution -----------------------------------------------------
    def _pool_scales(self, scales):
        if self.kv_int8 and scales is None:
            raise MXNetError("int8 paged store %r needs its (scale_k, "
                             "scale_v) pools on every dispatch" % self.name)
        return scales if self.kv_int8 else None

    def run_paged_step(self, pool_k, pool_v, tables, tokens, positions,
                       valid, scales=None):
        """One paged step (``tokens`` (bb, lq); lq=1 is a decode step,
        lq=prefill_chunk a prompt chunk).  Returns ``(logits (bb, vocab)
        at each row's last valid position, pool_k, pool_v)``; an int8 KV
        store takes and returns its scale pools too, ``(logits, pool_k,
        pool_v, scale_k, scale_v)``.  Pools and scales are updated in
        place."""
        with torch.no_grad():
            return paged_step_apply(self.model.params(), pool_k, pool_v,
                                    tables, tokens, positions, valid,
                                    self._spec, self.kv_block,
                                    scales=self._pool_scales(scales))

    def run_paged_step_sample(self, pool_k, pool_v, tables, tokens,
                              positions, valid, generators, temps, top_ks,
                              do_sample, scales=None):
        """One paged step with sampling on the device: returns
        ``(tokens (bb,) int32 on the device, pool_k, pool_v)`` (int8 KV:
        ``(tokens, pool_k, pool_v, scale_k, scale_v)``).  Rows with
        ``do_sample`` False keep their generator state; their token is
        garbage the caller discards."""
        out = self.run_paged_step(pool_k, pool_v, tables, tokens, positions,
                                  valid, scales)
        with torch.no_grad():
            toks = sample_tokens(out[0], temps, top_ks, generators,
                                 do_sample)
        return (toks,) + tuple(out[1:])

    def _need_paged(self):
        if not self.paged:
            raise MXNetError(
                "speculative decoding needs the paged plane (store %r has "
                "paged=False)" % self.name)

    def run_paged_step_sample_p(self, pool_k, pool_v, tables, tokens,
                                positions, valid, generators, temps,
                                top_ks, do_sample, scales=None):
        """The draft model's proposal step: one paged step (lq=1) with
        sampling on the device that also returns the proposal
        distribution.  Returns ``(tokens (bb,) int32, q (bb, vocab) fp32,
        pool_k, pool_v)`` (int8 KV: the scale pools after the pools).
        ``tokens`` may be a device tensor (the previous proposal);
        ``q`` stays on the device for :meth:`run_paged_verify`."""
        self._need_paged()
        out = self.run_paged_step(pool_k, pool_v, tables, tokens, positions,
                                  valid, scales)
        with torch.no_grad():
            toks, q = sample_tokens_p(out[0], temps, top_ks, generators,
                                      do_sample)
        return (toks, q) + tuple(out[1:])

    def run_paged_verify(self, pool_k, pool_v, tables, tokens, positions,
                         valid, prop_q, generators, temps, top_ks,
                         do_sample, scales=None):
        """The target model's speculative verify: ``tokens`` (bb, K+1)
        holds each slot's pending token followed by its K proposals
        (numpy or a device tensor), ``prop_q`` (bb, K, vocab) the
        draft's distributions, ``valid`` each slot's window + 1.  All K+1
        positions run in one paged step (``all_logits``), and
        :func:`spec_verify` accepts or rejects on the device; rows with
        ``do_sample`` False are verified as greedy rows and draw
        nothing (their output is discarded).  Returns ``(out_toks (bb,
        K+1), n_emit (bb,), pool_k, pool_v)`` on the device (int8 KV:
        the scale pools after the pools); row b emits ``out_toks[b,
        :n_emit[b]]``."""
        self._need_paged()
        with torch.no_grad():
            out = paged_step_apply(self.model.params(), pool_k, pool_v,
                                   tables, tokens, positions, valid,
                                   self._spec, self.kv_block,
                                   scales=self._pool_scales(scales),
                                   all_logits=True)
            temps = np.where(np.asarray(do_sample, bool), temps, 0.0)
            prop = torch.as_tensor(tokens, device=self.device)[:, 1:]
            out_toks, n_emit = spec_verify(out[0], prop, prop_q, generators,
                                           temps, top_ks, valid)
        return (out_toks, n_emit) + tuple(out[1:])

    def warm_spec_programs(self, spec_k, draft=False):
        """Run the speculative step kinds once before traffic, as
        :meth:`warmup` does the plain ones: the target's verify (lq =
        spec_k + 1), or with ``draft=True`` the draft's proposal step
        (lq=1, ``paged_step_sample_p``) and its logits-discarded
        prefill-mirror chunk (lq = prefill_chunk, ``paged_step``), for
        every batch bucket, on a throwaway pool with all-zero tables.
        Returns ``{(kind, bb, lq): ms}``, the host milliseconds of each
        call.  Raises :class:`MXNetError` on the contiguous plane."""
        self._need_paged()
        kinds = ([("paged_step_sample_p", 1),
                  ("paged_step", self.prefill_chunk)] if draft
                 else [("paged_verify", int(spec_k) + 1)])
        out = {}
        pools = self.new_pool()
        scales = self.new_scale_pool() if self.kv_int8 else None
        tb = self.table_width()
        vocab = self._spec["vocab_size"]
        for bb in self._batch_edges:
            for kind, lq in kinds:
                args = (np.zeros((bb, tb), np.int32),
                        np.zeros((bb, lq), np.int32), np.zeros(bb, np.int32),
                        np.ones(bb, np.int32))
                samp = ([None] * bb, np.zeros(bb, np.float32),
                        np.zeros(bb, np.int32), np.zeros(bb, bool))
                tic = time.perf_counter()
                if kind == "paged_verify":
                    q = torch.zeros((bb, lq - 1, vocab), device=self.device)
                    self.run_paged_verify(*pools, *args, q, *samp,
                                          scales=scales)
                elif kind == "paged_step_sample_p":
                    self.run_paged_step_sample_p(*pools, *args, *samp,
                                                 scales=scales)
                else:
                    self.run_paged_step(*pools, *args, scales=scales)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                out[(kind, bb, lq)] = (time.perf_counter() - tic) * 1e3
        return out

    def pad_prompts(self, prompts):
        """A list of token id sequences -> bucket-shaped ``(tokens (bb,
        pb) int32, lengths (bb,) int32)`` numpy arrays.  Pad rows get
        length 1 over token 0 (their logits are discarded)."""
        n = len(prompts)
        if n < 1:
            raise MXNetError("empty prompt batch")
        lens = [len(p) for p in prompts]
        if min(lens) < 1:
            raise MXNetError("empty prompt (0 tokens)")
        bb = self.batch_bucket(n)
        pb = self.prompt_bucket(max(lens))
        toks = np.zeros((bb, pb), np.int32)
        lengths = np.ones((bb,), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :lens[i]] = np.asarray(p, np.int32)
            lengths[i] = lens[i]
        return toks, lengths

    def run_prefill(self, tokens, lengths):
        """Contiguous plane: one padded prompt batch (``pad_prompts``).
        Returns ``(first_logits (bb, vocab) at each row's last prompt
        position, k_cache, v_cache)``, the caches ``(L, bb, H,
        kv_bucket(pb), dh)`` in the store's KV dtype."""
        bb, pb = np.shape(tokens)
        with torch.no_grad():
            logits, ck, cv = prefill_apply(self.model.params(), tokens,
                                           lengths, self.kv_bucket(pb),
                                           self._spec,
                                           cache_dtype=self.kv_dtype)
            last = torch.as_tensor(lengths, device=self.device).long() - 1
            first = logits[torch.arange(bb, device=self.device), last]
        return first, ck, cv

    def run_decode(self, cache_k, cache_v, tokens, lengths):
        """Contiguous plane: one decode step over a bucket-shaped cache,
        updated in place.  Returns ``(logits (bb, vocab), cache_k,
        cache_v)``."""
        with torch.no_grad():
            return decode_apply(self.model.params(), cache_k, cache_v,
                                tokens, lengths, self._spec)

    def run_decode_sample(self, cache_k, cache_v, tokens, lengths,
                          generators, temps, top_ks):
        """:meth:`run_decode` with sampling on the device: returns
        ``(tokens (bb,) int32 on the device, cache_k, cache_v)``."""
        logits, cache_k, cache_v = self.run_decode(cache_k, cache_v, tokens,
                                                   lengths)
        with torch.no_grad():
            toks = sample_tokens(logits, temps, top_ks, generators)
        return toks, cache_k, cache_v

    def warmup(self, kv_depth=None):
        """Run every step shape once before traffic.  On a CUDA device
        this builds the kernels, surfaces any launch fault and leaves the
        KV memory in PyTorch's caching allocator, so the engine's first
        request does not pay for it.

        Paged plane: one decode step (lq=1) and one prefill-chunk step
        per batch bucket, on a throwaway full-size pool with all-zero
        tables (every write and read lands in the trash block); the
        table width is a store constant, so ``kv_depth`` changes
        nothing.  Contiguous plane: one prefill per (batch bucket,
        prompt bucket) and one decode step per (batch bucket, cache
        bucket) — the cache buckets of the prompt buckets, and with
        ``kv_depth`` every bucket up to that length."""
        if self.paged:
            pk, pv = self.new_pool()
            scales = self.new_scale_pool() if self.kv_int8 else None
            tb = self.table_width()
            for bb in self._batch_edges:
                for lq in sorted({1, self.prefill_chunk}):
                    self.run_paged_step_sample(
                        pk, pv, np.zeros((bb, tb), np.int32),
                        np.zeros((bb, lq), np.int32), np.zeros(bb, np.int32),
                        np.ones(bb, np.int32), [None] * bb,
                        np.zeros(bb, np.float32), np.zeros(bb, np.int32),
                        np.zeros(bb, bool), scales=scales)
        else:
            cache_buckets = {self.kv_bucket(p) for p in self._prompt_edges}
            if kv_depth is not None:
                top = self.kv_bucket(kv_depth)
                cache_buckets.update(range(self.kv_block, top + 1,
                                           self.kv_block))
            for bb in self._batch_edges:
                for pb in self._prompt_edges:
                    self.run_prefill(np.zeros((bb, pb), np.int32),
                                     np.ones(bb, np.int32))
                for cb in sorted(cache_buckets):
                    ck, cv = self.new_cache(bb, cb)
                    self.run_decode_sample(
                        ck, cv, np.zeros(bb, np.int32),
                        np.zeros(bb, np.int32), [None] * bb,
                        np.zeros(bb, np.float32), np.zeros(bb, np.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- introspection -------------------------------------------------
    def stats(self):
        out = {"generative": True, "paged": self.paged,
               "device": str(self.device),
               "batch_buckets": list(self._batch_edges),
               "prompt_buckets": list(self._prompt_edges),
               "kv_block": self.kv_block, "kv_max": self.kv_max,
               "compute_dtype": self._compute,
               "kv_dtype": str(self.kv_dtype).replace("torch.", ""),
               "weight_bytes": _weight_bytes(
                   self.model.params().values())}
        if self.paged:
            out.update(prefill_chunk=self.prefill_chunk,
                       pool_blocks=self.pool_blocks,
                       table_width=self.table_width())
        state = self.cache_state
        if state is not None:
            out["cache_state"] = state.describe()
        return out


# ---------------------------------------------------------------------------
# The forward plane: bucketed programs over a symbol graph.
# ---------------------------------------------------------------------------
def _fc_weight_only_params(symbol):
    """Variables consumed only as a ``FullyConnected`` weight input: the
    int8-quantizable set of a symbol graph.  Any other consumer (a norm,
    an elementwise op, an output head) would receive a
    :class:`QuantizedWeight` it does not understand, so shared variables
    stay full precision."""
    fc_w, other = set(), set()
    for node in symbol._nodes():
        if node.is_variable:
            continue
        is_fc = node.op.name == "FullyConnected"
        for idx, (s, _oi) in enumerate(node.arg_inputs()):
            if s.is_variable:
                (fc_w if is_fc and idx == 1 else other).add(s.name)
    for n, _oi in symbol._outputs:
        if n.is_variable:
            other.add(n.name)
    return fc_w - other


def _as_tensor(v):
    """A parameter value (NDArray, tensor or numpy) as a tensor."""
    v = getattr(v, "_data", v)
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(v))


class _Program:
    """One bucket's plan: the init ops' attributes resolved at the
    bucket (:func:`~..executor.shape_overrides`), the zero-filled
    arguments that are neither inputs nor parameters (loss-head
    labels), which outputs carry the batch axis, and the milliseconds
    the plan took to build."""

    __slots__ = ("bucket", "attrs", "zeros", "out_batch_major",
                 "compile_ms")

    def __init__(self, bucket, attrs, zeros, out_batch_major, compile_ms):
        self.bucket = bucket
        self.attrs = attrs
        self.zeros = zeros
        self.out_batch_major = out_batch_major
        self.compile_ms = compile_ms


class ProgramStore:
    """Bucketed inference programs for one model (counterpart of the
    reference's ``ProgramStore``).

    A request of ``n`` rows is zero-padded to the smallest bucket edge
    ``>= n`` (``MXNET_SERVE_BUCKETS``) and runs that bucket's program.
    The reference compiles one XLA executable a bucket ahead of time;
    the port runs eagerly, so a bucket's "program" is its plan
    (:class:`_Program`), built once and kept in an LRU of
    ``MXNET_SERVE_PROGRAM_CACHE`` entries with the reference's counters
    (hits, compiles, evictions, ``compile_ms_total``, which here times
    the plan's construction).  Running one walks the graph with
    :func:`~..executor.evaluate`, the walk that ``Executor`` and the
    trainer's step run too, under ``torch.inference_mode()``.  The
    reference's key also carries its Pallas dispatch fingerprint (the
    ``MXNET_PALLAS`` flip); the port has no such flip, so its key is
    (model, bucket, input signature, dtype tag).

    Parameters are inputs of every bucket, not baked into it: all
    buckets share one device-resident copy of the weights, and
    :meth:`swap_params` republishes them atomically without rebuilding
    anything.  ``compute_dtype='bfloat16'`` casts the floating weights
    once at load and the floating inputs inside each run; ``'int8'``
    quantizes the weights that only a ``FullyConnected`` consumes into
    :class:`QuantizedWeight` pairs (the reference's ``quantize_int8``
    bits), which the op hands to the ``dequant_matmul`` kernel, with
    activations in fp32.  Outputs come back float32 either way.
    ``stats()["weight_bytes"]`` measures the resident bytes by dtype.

    A run pads its inputs on the host, copies each input to the device
    once (on the card through a pinned buffer, ``non_blocking``; the
    buffer is kept until an event recorded behind its copy has
    completed) and enqueues the graph: nothing on the path waits for
    the device.  The outputs are allocated anew by every run.  Bucket
    padding changes the batch size the device's libraries see, and with
    it their choice of algorithm, so a padded row agrees with an
    unpadded forward within rounding, not bit for bit.  ``device``
    defaults to ``cuda:0``; ``device='cpu'`` runs the plain versions.
    """

    def __init__(self, symbol, arg_params, aux_params, input_shapes,
                 name="model", compute_dtype=None, buckets=None,
                 max_programs=None, input_dtypes=None, device=None):
        self._symbol = symbol
        self.name = name
        self._edges = bucket_edges(buckets)
        self._quant8 = bool(compute_dtype) and \
            str(compute_dtype).lower() == "int8"
        self._cdt = (None if self._quant8 or not compute_dtype
                     else _torch_dtype(compute_dtype))
        self._dtype_tag = ("int8" if self._quant8 else
                           str(self._cdt).replace("torch.", "")
                           if self._cdt is not None else None)
        self._input_names = list(input_shapes)
        if not self._input_names:
            raise MXNetError("serving needs at least one input")
        self._input_tails = {n: tuple(input_shapes[n])[1:]
                             for n in self._input_names}
        self._input_dtypes = {
            n: np.dtype((input_dtypes or {}).get(n, "float32"))
            for n in self._input_names}
        self._device = default_device(device)
        # bucket padding and continuous batching need every output to
        # carry the batch axis: probe the symbol at two batch sizes
        probes = []
        for b in (self._edges[-1], self._edges[-1] + 1):
            probe = {n: (b,) + self._input_tails[n]
                     for n in self._input_names}
            probes.append(symbol.infer_shape_partial(**probe)[1])
        for oname, s1, s2 in zip(symbol.list_outputs(), *probes):
            if s1 is None or s2 is None or not len(s1) or not len(s2) \
                    or s1[0] != self._edges[-1] \
                    or s2[0] != self._edges[-1] + 1:
                raise MXNetError(
                    "output %r of serving model %r is not batch-major "
                    "(shape %s at batch size %d): bucket padding and "
                    "continuous batching require row-independent "
                    "batch-major outputs — serve this model with the "
                    "classic Predictor instead"
                    % (oname, name, s1, self._edges[-1]))

        arg_names = symbol.list_arguments()
        aux_params = aux_params or {}
        self._param_names = [n for n in arg_names
                             if n not in input_shapes and n in arg_params]
        self._zero_args = [n for n in arg_names
                           if n not in input_shapes
                           and n not in arg_params]
        self._quant_names = (_fc_weight_only_params(symbol)
                             if self._quant8 else frozenset())
        self._aux_names = symbol.list_auxiliary_states()
        self._params = {n: self._load_param(arg_params[n], n)
                        for n in self._param_names}
        # auxiliary states missing from the params are zero-filled at
        # their inferred shape
        shapes = {n: tuple(input_shapes[n]) for n in self._input_names}
        aux_shapes = symbol.infer_shape_partial(**shapes)[2]
        aux = []
        for n, shape in zip(self._aux_names, aux_shapes):
            if n in aux_params:
                aux.append(self._load_param(aux_params[n]))
            elif shape is not None:
                aux.append(torch.zeros(tuple(shape),
                                       dtype=self._cdt or torch.float32,
                                       device=self._device))
            else:
                raise MXNetError("auxiliary state %r is not in the params "
                                 "and its shape cannot be inferred" % n)
        self._aux = tuple(aux)
        # the published weight set: a run reads this tuple once, so a
        # swap is atomic per request
        self._version = 1
        self._live = (self._params, self._aux, self._version)
        self._nodes = symbol._nodes()
        self._heads = [(id(n), oi) for n, oi in symbol._outputs]
        if max_programs is None:
            max_programs = int(get_env("MXNET_SERVE_PROGRAM_CACHE"))
        self.max_programs = max(1, int(max_programs))
        if self.max_programs < len(self._edges):
            log.warning(
                "serving model %r: program cache (%d) is smaller than "
                "the bucket count (%d); warmed buckets will be evicted "
                "and rebuilt inside served requests — raise "
                "MXNET_SERVE_PROGRAM_CACHE or trim MXNET_SERVE_BUCKETS",
                name, self.max_programs, len(self._edges))
        self._programs = OrderedDict()   # key -> _Program
        self._lock = threading.Lock()
        self._stats = {"hits": 0, "compiles": 0, "evictions": 0,
                       "compile_ms_total": 0.0}
        self._staged = collections.deque()   # (event, pinned buffer)

    def _load_param(self, v, name=None):
        """One parameter through the serving dtype policy: int8 codes for
        the FC-weight-only set, floats cast to the compute dtype, a copy
        on the store's device.  Load and swap share it."""
        t = _as_tensor(v).detach()
        if name in self._quant_names and t.dim() == 2 and \
                t.is_floating_point():
            codes, scales = quantize_int8(t.float().cpu().numpy())
            return QuantizedWeight(
                torch.from_numpy(codes).to(self._device),
                torch.from_numpy(scales).to(self._device))
        dtype = self._cdt if self._cdt is not None and \
            t.is_floating_point() else t.dtype
        return t.to(device=self._device, dtype=dtype, copy=True)

    # -- hot weight swap -----------------------------------------------
    def swap_params(self, arg_params, aux_params=None):
        """Atomically republish the weights.  ``arg_params`` must cover
        every parameter the store serves, at the loaded shapes and
        dtypes; ``aux_params=None`` keeps the auxiliary states.  The new
        set goes through the load's dtype pipeline, then one reference
        assignment publishes ``(params, aux, version)``: a run reads it
        once, so no request sees a mix.  Returns the new version."""
        missing = [n for n in self._param_names if n not in arg_params]
        if missing:
            raise MXNetError("swap_params for %r is missing %s"
                             % (self.name, sorted(missing)))
        new_params = {}
        for n in self._param_names:
            a = self._load_param(arg_params[n], n)
            old = self._params[n]
            quant = isinstance(old, QuantizedWeight)
            if quant != isinstance(a, QuantizedWeight):
                pairs = None
            elif quant:
                pairs = ((a.codes, old.codes), (a.scales, old.scales))
            else:
                pairs = ((a, old),)
            if pairs is None or any(
                    tuple(x.shape) != tuple(y.shape) or x.dtype != y.dtype
                    for x, y in pairs):
                raise MXNetError(
                    "swap_params for %r: parameter %r does not match "
                    "the compiled programs' signature (the serving "
                    "programs are not recompiled on swap)" % (self.name,
                                                              n))
            new_params[n] = a
        if aux_params is None:
            new_aux = self._aux
        else:
            new_aux = []
            for n, old in zip(self._aux_names, self._aux):
                if n not in aux_params:
                    new_aux.append(old)
                    continue
                a = self._load_param(aux_params[n])
                if tuple(a.shape) != tuple(old.shape) or \
                        a.dtype != old.dtype:
                    raise MXNetError(
                        "swap_params for %r: auxiliary state %r does "
                        "not match the compiled programs' signature"
                        % (self.name, n))
                new_aux.append(a)
            new_aux = tuple(new_aux)
        with self._lock:
            self._params = new_params
            self._aux = new_aux
            self._version += 1
            self._live = (new_params, new_aux, self._version)
        return self._version

    @property
    def version(self):
        return self._version

    def param_snapshot(self):
        """Opaque handle to the live weight set, for
        :meth:`restore_params`."""
        params, aux, _ = self._live
        return (params, aux)

    def restore_params(self, snap):
        """Atomically republish a :meth:`param_snapshot` (no dtype
        pipeline, no signature check); the version still rises."""
        params, aux = snap
        with self._lock:
            self._params = dict(params)
            self._aux = aux
            self._version += 1
            self._live = (self._params, self._aux, self._version)
        return self._version

    # -- geometry ------------------------------------------------------
    @property
    def edges(self):
        return self._edges

    @property
    def device(self):
        return self._device

    def max_bucket(self):
        return self._edges[-1]

    @property
    def input_names(self):
        return list(self._input_names)

    def output_names(self):
        return self._symbol.list_outputs()

    def canon_inputs(self, inputs):
        """Validate and canonicalize one request's inputs (client-thread
        work: numpy conversion, dtype cast, shape checks).  Returns
        ``(dict name -> np.ndarray, n_rows)``."""
        got, want = set(inputs), set(self._input_names)
        if got != want:
            raise MXNetError("serving inputs mismatch for %r: got %s, "
                             "want %s" % (self.name, sorted(got),
                                          sorted(want)))
        out = {}
        n = None
        for name in self._input_names:
            v = getattr(inputs[name], "_data", inputs[name])
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            a = np.asarray(v, dtype=self._input_dtypes[name])
            tail = self._input_tails[name]
            if a.ndim != len(tail) + 1 or tuple(a.shape[1:]) != tail:
                raise MXNetError(
                    "input %r has shape %s; want (n,%s)"
                    % (name, a.shape, ",".join(map(str, tail))))
            if n is None:
                n = int(a.shape[0])
            elif int(a.shape[0]) != n:
                raise MXNetError("inputs disagree on batch rows: %d vs %d"
                                 % (n, a.shape[0]))
            out[name] = a
        if n < 1:
            raise MXNetError("empty request (0 rows)")
        if bucket_for(n, self._edges) is None:
            raise MXNetError(
                "request of %d rows exceeds the largest serving bucket "
                "(%d); raise MXNET_SERVE_BUCKETS or split the request"
                % (n, self._edges[-1]))
        return out, n

    # -- programs ------------------------------------------------------
    def _key(self, bucket):
        sig = tuple((n, (bucket,) + self._input_tails[n],
                     str(self._input_dtypes[n]))
                    for n in self._input_names)
        return ("serve", self.name, bucket, sig, self._dtype_tag)

    def _compile(self, bucket):
        """Build one bucket's plan."""
        tic = time.perf_counter()
        symbol = self._symbol
        shapes = {n: (bucket,) + self._input_tails[n]
                  for n in self._input_names}
        arg_shapes, out_shapes, _ = symbol.infer_shape_partial(**shapes)
        zeros = {}
        for n, s in zip(symbol.list_arguments(), arg_shapes):
            if n in self._zero_args:
                if s is None:
                    raise MXNetError(
                        "argument %r is neither an input nor in the "
                        "params and its shape cannot be inferred" % n)
                zeros[n] = torch.zeros(tuple(s), device=self._device)
        known = dict(shapes)
        known.update({n: tuple(a.shape) for n, a in self._params.items()})
        attrs = shape_overrides(symbol, known, self._device)
        flags = tuple(s is not None and len(s) > 0 and s[0] == bucket
                      for s in out_shapes)
        ms = (time.perf_counter() - tic) * 1e3
        return _Program(bucket, attrs, zeros, flags, ms)

    def _acquire(self, bucket):
        """LRU lookup, or build, of one bucket's plan (built outside the
        lock; a build that lost a race is dropped)."""
        key = self._key(bucket)
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                self._programs.move_to_end(key)
                self._stats["hits"] += 1
                return prog
        prog = self._compile(bucket)
        with self._lock:
            raced = self._programs.get(key)
            if raced is not None:
                self._stats["hits"] += 1
                return raced
            self._stats["compiles"] += 1
            self._stats["compile_ms_total"] += prog.compile_ms
            while len(self._programs) >= self.max_programs:
                self._programs.popitem(last=False)
                self._stats["evictions"] += 1
            self._programs[key] = prog
            return prog

    def warmup(self, execute=True):
        """Build, and by default run once on zeros, every bucket ahead
        of traffic: a bucket's first run loads kernels and picks cuDNN
        algorithms, which must not land inside a served request.
        Returns the per-bucket build times (ms)."""
        out = {}
        for b in self._edges:
            prog = self._acquire(b)
            out[b] = prog.compile_ms
            if execute:
                feed = {n: np.zeros((b,) + self._input_tails[n],
                                    self._input_dtypes[n])
                        for n in self._input_names}
                self._execute(prog, feed, b)
        if execute and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return out

    # -- execution -----------------------------------------------------
    def _stage(self, v, n, bucket):
        """One input padded to ``bucket`` rows on the host and copied to
        the device once."""
        shape = (bucket,) + tuple(v.shape[1:])
        if self._device.type == "cpu":
            if n == bucket:
                return torch.from_numpy(np.ascontiguousarray(v))
            pad = np.zeros(shape, v.dtype)
            pad[:n] = v
            return torch.from_numpy(pad)
        host = torch.empty(shape, dtype=_torch_dtype(v.dtype),
                           pin_memory=True)
        hv = host.numpy()
        hv[:n] = v
        hv[n:] = 0
        t = host.to(self._device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self._device))
        with self._lock:
            self._staged.append((ev, host))
        return t

    def _release_staged(self):
        """Drop the pinned buffers whose copies have completed (an event
        query does not wait)."""
        with self._lock:
            while self._staged and self._staged[0][0].query():
                self._staged.popleft()

    def _execute(self, prog, inputs, n):
        if self._device.type == "cuda":
            self._release_staged()
        feed = {name: self._stage(inputs[name], n, prog.bucket)
                for name in self._input_names}
        # one read of the published (params, aux, version): the request
        # runs against one weight version
        params, aux, _v = self._live
        values = dict(params)
        values.update(zip(self._aux_names, aux))
        values.update(prog.zeros)
        values.update(feed)
        with torch.inference_mode():
            outs, _ = evaluate(self._nodes, self._heads, prog.attrs, values,
                               False, self._device,
                               compute_dtype=self._cdt)
            if self._cdt is not None:
                outs = [o.float() if o.is_floating_point() else o
                        for o in outs]
        return outs

    def run(self, inputs, n=None, slice_outputs=True):
        """Run ``n`` rows of canonical inputs (:meth:`canon_inputs`)
        through their bucket.  Returns ``(outputs, bucket,
        batch_major)``: device tensors, the batch-major ones cut back to
        ``n`` rows (a view) unless ``slice_outputs=False``, which leaves
        them bucket-shaped (the engine cuts each request's rows itself);
        ``batch_major`` flags the outputs that carry the batch axis.
        The serving engine's dispatch calls this: nothing here waits for
        the device."""
        if n is None:
            n = int(inputs[self._input_names[0]].shape[0])
        bucket = bucket_for(n, self._edges)
        if bucket is None:
            raise MXNetError(
                "request of %d rows exceeds the largest serving bucket "
                "(%d)" % (n, self._edges[-1]))
        prog = self._acquire(bucket)
        outs = self._execute(prog, inputs, n)
        if slice_outputs:
            outs = [o[:n] if bm and n != bucket else o
                    for o, bm in zip(outs, prog.out_batch_major)]
        return list(outs), bucket, prog.out_batch_major

    # -- introspection -------------------------------------------------
    def stats(self):
        """Build-cache counters, the resident buckets, the version and
        the resident weight bytes by dtype."""
        with self._lock:
            out = dict(self._stats)
            out["size"] = len(self._programs)
            out["max_programs"] = self.max_programs
            out["buckets_resident"] = sorted(
                p.bucket for p in self._programs.values())
        out["edges"] = list(self._edges)
        out["compute_dtype"] = self._dtype_tag
        params, aux, version = self._live
        out["version"] = version
        out["weight_bytes"] = _weight_bytes(list(params.values())
                                            + list(aux))
        return out

    def reset_stats(self):
        with self._lock:
            for k in ("hits", "compiles", "evictions"):
                self._stats[k] = 0
            self._stats["compile_ms_total"] = 0.0
