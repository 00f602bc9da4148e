"""Generative program store of the serving plane, in PyTorch.

Counterpart of ``GenerativeProgramStore`` in
``mxnet_tpu/serving/program_store.py``, for both KV planes: the paged
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

import time

import numpy as np
import torch

from ..base import MXNetError, get_env
from ..context import default_device
from ..kernels.dequant_matmul import QuantizedWeight
from ..models.transformer_lm import (TransformerLM, decode_apply,
                                     init_cache, init_pool,
                                     init_scale_pool, lm_spec,
                                     paged_step_apply, prefill_apply,
                                     quantize_lm_params)

__all__ = ["GenerativeProgramStore", "bucket_edges", "bucket_for",
           "sample_tokens", "sample_tokens_p", "spec_verify"]

_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}


def _weight_bytes(params):
    """Resident bytes of a param dict grouped by storage dtype (numpy
    names, as the reference reports them): a QuantizedWeight counts its
    int8 codes and its fp32 scales."""
    by_dtype = {}
    for v in params.values():
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
               "weight_bytes": _weight_bytes(self.model.params())}
        if self.paged:
            out.update(prefill_chunk=self.prefill_chunk,
                       pool_blocks=self.pool_blocks,
                       table_width=self.table_width())
        state = self.cache_state
        if state is not None:
            out["cache_state"] = state.describe()
        return out
