"""Model registry of the port's serving plane (generative models and
their speculative-decoding drafts; counterpart of
``mxnet_tpu/serving/registry.py``)."""
from __future__ import annotations

import threading

from ..base import MXNetError, get_env
from .program_store import GenerativeProgramStore

__all__ = ["ModelRegistry"]


class ModelRegistry:
    """name -> :class:`GenerativeProgramStore`, with thread-safe add and
    remove, and each model's draft store for speculative decoding."""

    def __init__(self):
        self._gen_stores = {}
        self._drafts = {}       # target name -> draft GenerativeProgramStore
        self._lock = threading.Lock()

    def add_generative_model(self, name, params, spec, warmup=True,
                             warmup_kv_depth=None, **kwargs):
        """Register an autoregressive LM for the decode plane.

        ``params`` — the ``transformer_lm`` argument arrays by name
        (numpy, e.g. the reference package's ``random_params`` or a
        checkpoint's arg_params); ``spec`` — ``transformer_lm.lm_spec``.
        Keyword args (``batch_buckets``, ``prompt_buckets``, ``kv_block``,
        ``kv_max``, ``compute_dtype``, ``kv_dtype``, ``paged``,
        ``prefill_chunk``, ``pool_blocks``, ``device``) pass through to
        :class:`GenerativeProgramStore`: ``compute_dtype='bfloat16'`` or
        ``'int8'`` serves bf16 or int8 weights, ``kv_dtype='bfloat16'``
        or ``'int8'`` a bf16 or int8 paged pool, ``paged=False`` the
        contiguous plane (fp32 only).  An unset ``compute_dtype``
        falls back to ``MXNET_SERVE_DTYPE``, an unset ``kv_dtype`` to
        ``MXNET_SERVE_KV_DTYPE`` and an unset ``paged`` to
        ``MXNET_SERVE_PAGED`` (read by the store).  ``device`` defaults
        to ``cuda:0`` and raises without a GPU unless ``device="cpu"``.
        Unless ``warmup=False``, runs every step shape of the store's
        plane once before returning it (``warmup_kv_depth`` widens the
        contiguous plane's decode warmup)."""
        if kwargs.get("compute_dtype") is None:
            kwargs["compute_dtype"] = get_env("MXNET_SERVE_DTYPE") or None
        store = GenerativeProgramStore(params, spec, name=name, **kwargs)
        with self._lock:
            if name in self._gen_stores:
                raise MXNetError("model %r is already registered" % name)
            self._gen_stores[name] = store
        if warmup:
            try:
                store.warmup(kv_depth=warmup_kv_depth)
            except BaseException:
                # a model whose steps fail must not stay registered
                with self._lock:
                    self._gen_stores.pop(name, None)
                raise
        return store

    def add_draft_model(self, target_name, params, spec, spec_k=None,
                        warmup=True, compute_dtype=None, device=None):
        """Attach a small draft LM to generative model ``target_name`` for
        speculative decoding (``MXNET_SERVE_SPEC``).

        The draft gets its own :class:`GenerativeProgramStore` with the
        target's geometry copied (batch and prompt buckets, ``kv_block``,
        ``kv_max``, ``pool_blocks``, ``prefill_chunk``, ``kv_dtype``, the
        paged plane), so the decode engine drives both KV planes through
        the same block tables: the draft holds its own pool tensors and
        shares the target's block allocator.  ``spec_k`` (default
        ``MXNET_SERVE_SPEC_K``) is the proposals a tick; ``compute_dtype``
        defaults to ``MXNET_SERVE_DTYPE``, ``device`` to the target's.
        Refused (:class:`MXNetError`) when the target is not paged,
        ``spec_k`` is below 1, the vocabularies or devices differ, or a
        draft is already attached.  Unless ``warmup=False`` it runs the
        speculative step kinds of both sides once (the draft's lq=1
        proposal step and prefill-mirror chunk, the target's lq=spec_k+1
        verify), and takes the draft back off if that raises.  Returns
        the draft store."""
        target = self.gen_store(target_name)
        if not target.paged:
            raise MXNetError(
                "speculative decoding needs model %r on the paged plane "
                "(paged=True); it has paged=False" % target_name)
        if spec_k is None:
            spec_k = int(get_env("MXNET_SERVE_SPEC_K"))
        spec_k = int(spec_k)
        if spec_k < 1:
            raise MXNetError("spec_k must be >= 1, got %d" % spec_k)
        if compute_dtype is None:
            compute_dtype = get_env("MXNET_SERVE_DTYPE") or None
        draft = GenerativeProgramStore(
            params, spec, name="%s.draft" % target_name,
            batch_buckets=target._batch_edges,
            prompt_buckets=target._prompt_edges,
            kv_block=target.kv_block, kv_max=target.kv_max,
            compute_dtype=compute_dtype,
            kv_dtype=str(target.kv_dtype).replace("torch.", ""), paged=True,
            prefill_chunk=target.prefill_chunk,
            pool_blocks=target.pool_blocks,
            device=target.device if device is None else device)
        if draft.spec["vocab_size"] != target.spec["vocab_size"] or \
                draft.device != target.device:
            raise MXNetError(
                "draft of %r must share its vocabulary and device: vocab "
                "%d on %s vs %d on %s"
                % (target_name, draft.spec["vocab_size"], draft.device,
                   target.spec["vocab_size"], target.device))
        # the engine reads the window off the draft: the verify step was
        # warmed for exactly this lq
        draft.spec_k = spec_k
        with self._lock:
            if target_name in self._drafts:
                raise MXNetError("model %r already has a draft attached"
                                 % target_name)
            self._drafts[target_name] = draft
        if warmup:
            try:
                draft.warm_spec_programs(spec_k, draft=True)
                target.warm_spec_programs(spec_k)
            except BaseException:
                with self._lock:
                    self._drafts.pop(target_name, None)
                raise
        return draft

    def draft_store(self, name):
        """Model ``name``'s draft store, or None when it has none."""
        with self._lock:
            return self._drafts.get(name)

    def gen_store(self, name):
        """The model's GenerativeProgramStore; raises when unknown."""
        with self._lock:
            store = self._gen_stores.get(name)
            known = sorted(self._gen_stores) if store is None else None
        if store is None:
            raise MXNetError(
                "unknown generative serving model %r (registered: %s)"
                % (name, known))
        return store

    def remove_model(self, name):
        with self._lock:
            self._drafts.pop(name, None)
            if self._gen_stores.pop(name, None) is None:
                raise MXNetError("unknown serving model %r" % name)

    def models(self):
        with self._lock:
            return sorted(self._gen_stores)

    def __contains__(self, name):
        with self._lock:
            return name in self._gen_stores

    def __len__(self):
        with self._lock:
            return len(self._gen_stores)
