"""Generative program store of the paged serving plane, in PyTorch.

Counterpart of ``GenerativeProgramStore`` in
``mxnet_tpu/serving/program_store.py``, paged plane only.  The reference
compiles one program per (batch bucket, step length) ahead of time; the
port runs eagerly, so a "program" here is one call of
:func:`~..models.transformer_lm.paged_step_apply` on the store's weights
(capturing those calls in CUDA graphs is later work).  The store owns
the weights, the bucket geometry and the request checks; the KV pool is
made by :meth:`GenerativeProgramStore.new_pool` and owned by the decode
engine's per-model state.

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
from ..models.transformer_lm import (TransformerLM, init_pool, lm_spec,
                                     paged_step_apply)

__all__ = ["GenerativeProgramStore", "bucket_edges", "bucket_for",
           "sample_tokens"]

_LATER = ("arrives with a later serving slice of the port (ROADMAP.md, "
          "Queue 1: bf16/int8 serving, the contiguous plane, speculative "
          "decoding)")


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
    """Weights, bucket geometry and step calls of one autoregressive LM
    on the paged KV plane.

    Arguments mirror the reference store: ``params`` (name -> array, the
    ``transformer_lm`` argument names), ``spec`` (``lm_spec``),
    ``batch_buckets`` / ``prompt_buckets`` / ``kv_block`` / ``kv_max`` /
    ``prefill_chunk`` / ``pool_blocks`` (defaults from the
    ``MXNET_SERVE_*`` knobs), and ``device`` (default ``cuda:0``; pass
    ``"cpu"`` for the plain versions).  The slice serves fp32 weights and
    an fp32 paged KV pool: another ``compute_dtype`` or ``kv_dtype``, or
    ``paged=False``, raises :class:`MXNetError`."""

    def __init__(self, params, spec, name="lm", batch_buckets=None,
                 prompt_buckets=None, kv_block=None, kv_max=None,
                 compute_dtype=None, kv_dtype=None, paged=None,
                 prefill_chunk=None, pool_blocks=None, device=None):
        self._spec = lm_spec(**dict(spec))
        self.name = name
        if compute_dtype and str(compute_dtype).lower() not in ("float32",
                                                                "fp32"):
            raise MXNetError("compute_dtype %r: only fp32 weights are "
                             "ported; %s" % (compute_dtype, _LATER))
        if kv_dtype is not None and str(kv_dtype) != "float32":
            raise MXNetError("kv_dtype %r: only the fp32 KV pool is "
                             "ported; %s" % (kv_dtype, _LATER))
        if paged is not None and not paged:
            raise MXNetError("paged=False: only the paged KV plane is "
                             "ported; %s" % _LATER)
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
        if nb < self.table_width() + 1:
            raise MXNetError(
                "paged KV pool of %d blocks cannot hold one full-depth "
                "sequence (%d blocks + the reserved trash block); raise "
                "MXNET_SERVE_KV_POOL_BLOCKS" % (nb, self.table_width()))
        self.pool_blocks = nb
        self.model = TransformerLM.from_numpy(params, self._spec,
                                              self.device)
        # live decode state, attached by the GenerationEngine
        self.cache_state = None

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

    def table_width(self):
        """Logical blocks needed to address a full kv_max sequence."""
        return -(-self.kv_max // self.kv_block)

    def validate_request(self, prompt_len, max_tokens):
        """Reject at submit anything that could outgrow kv_max or the
        pool's usable blocks mid-flight."""
        need = int(prompt_len) + max(1, int(max_tokens))
        if need > self.kv_max:
            raise MXNetError(
                "prompt_len %d + max_tokens %d exceeds MXNET_SERVE_KV_"
                "MAX (%d)" % (prompt_len, max_tokens, self.kv_max))
        blocks = -(-need // self.kv_block)
        if blocks > self.pool_blocks - 1:
            raise MXNetError(
                "request needs %d KV blocks, past the paged pool's %d "
                "usable blocks (MXNET_SERVE_KV_POOL_BLOCKS)"
                % (blocks, self.pool_blocks - 1))

    # -- pool ----------------------------------------------------------
    def new_pool(self):
        """Zeroed K/V pool pair, ``(num_layers, num_heads, pool_blocks *
        kv_block, head_dim)`` fp32 on the store's device."""
        return init_pool(self._spec, self.pool_blocks, self.kv_block,
                         device=self.device)

    def copy_block(self, pool_k, pool_v, src, dst):
        """Copy-on-write fork: copy physical block ``src``'s rows into
        block ``dst`` of both pools, in place."""
        bs = self.kv_block
        for pool in (pool_k, pool_v):
            pool[:, :, dst * bs:(dst + 1) * bs].copy_(
                pool[:, :, src * bs:(src + 1) * bs])
        return pool_k, pool_v

    # -- execution -----------------------------------------------------
    def run_paged_step(self, pool_k, pool_v, tables, tokens, positions,
                       valid):
        """One paged step (``tokens`` (bb, lq); lq=1 is a decode step,
        lq=prefill_chunk a prompt chunk).  Returns ``(logits (bb, vocab)
        at each row's last valid position, pool_k, pool_v)``; the pools
        are updated in place."""
        with torch.no_grad():
            return paged_step_apply(self.model.params(), pool_k, pool_v,
                                    tables, tokens, positions, valid,
                                    self._spec, self.kv_block)

    def run_paged_step_sample(self, pool_k, pool_v, tables, tokens,
                              positions, valid, generators, temps, top_ks,
                              do_sample):
        """One paged step with sampling on the device: returns
        ``(tokens (bb,) int32 on the device, pool_k, pool_v)``.  Rows with
        ``do_sample`` False keep their generator state; their token is
        garbage the caller discards."""
        logits, pool_k, pool_v = self.run_paged_step(
            pool_k, pool_v, tables, tokens, positions, valid)
        with torch.no_grad():
            toks = sample_tokens(logits, temps, top_ks, generators,
                                 do_sample)
        return toks, pool_k, pool_v

    def warmup(self, kv_depth=None):
        """Run one decode step (lq=1) and one prefill-chunk step per
        batch bucket before traffic, on a throwaway full-size pool with
        all-zero tables (every write and read lands in the trash block).
        On a CUDA device this builds the kernels, surfaces any launch
        fault and leaves the pool's memory in PyTorch's caching
        allocator, so the engine's first request does not pay for it.
        ``kv_depth`` is accepted for the reference's signature: the table
        width is a store constant, so depth never changes a step."""
        del kv_depth
        pk, pv = self.new_pool()
        tb = self.table_width()
        for bb in self._batch_edges:
            for lq in sorted({1, self.prefill_chunk}):
                self.run_paged_step_sample(
                    pk, pv, np.zeros((bb, tb), np.int32),
                    np.zeros((bb, lq), np.int32), np.zeros(bb, np.int32),
                    np.ones(bb, np.int32), [None] * bb,
                    np.zeros(bb, np.float32), np.zeros(bb, np.int32),
                    np.zeros(bb, bool))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- introspection -------------------------------------------------
    def stats(self):
        out = {"generative": True, "paged": True,
               "device": str(self.device),
               "batch_buckets": list(self._batch_edges),
               "prompt_buckets": list(self._prompt_edges),
               "kv_block": self.kv_block, "kv_max": self.kv_max,
               "prefill_chunk": self.prefill_chunk,
               "pool_blocks": self.pool_blocks,
               "table_width": self.table_width()}
        state = self.cache_state
        if state is not None:
            out["cache_state"] = state.describe()
        return out
