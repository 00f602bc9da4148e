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
"""
from __future__ import annotations

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
           "sample_tokens"]

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
