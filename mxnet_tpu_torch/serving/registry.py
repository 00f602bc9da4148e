"""Model registry of the port's serving plane (counterpart of
``mxnet_tpu/serving/registry.py``).

Forward models (:meth:`ModelRegistry.add_model`, served by
:class:`~.scheduler.ServingEngine`) each get a
:class:`~.program_store.ProgramStore`; generative models
(:meth:`ModelRegistry.add_generative_model`, served by
:class:`~.decode_engine.GenerationEngine`) a
:class:`~.program_store.GenerativeProgramStore`, with an optional draft
store for speculative decoding.  One name space: a name is either a
forward model or a generative one.  Models come from live arrays, a
``save_checkpoint`` prefix/epoch pair or a ``deploy.to_serving``
artifact, and can be removed at run time (a request for a removed model
fails at dispatch).  An unset ``compute_dtype`` falls back to
``MXNET_SERVE_DTYPE``."""
from __future__ import annotations

import threading

from ..base import MXNetError, get_env
from .program_store import GenerativeProgramStore, ProgramStore

__all__ = ["ModelRegistry"]


class ModelRegistry:
    """name -> :class:`ProgramStore` or :class:`GenerativeProgramStore`,
    with thread-safe add and remove, and each generative model's draft
    store for speculative decoding."""

    def __init__(self):
        self._stores = {}
        self._gen_stores = {}
        self._drafts = {}       # target name -> draft GenerativeProgramStore
        self._lock = threading.Lock()

    def add_model(self, name, symbol, arg_params, aux_params=None,
                  input_shapes=None, compute_dtype=None, buckets=None,
                  max_programs=None, input_dtypes=None, device=None,
                  warmup=True):
        """Register a forward model (a symbol graph whose outputs are
        batch-major); builds and runs every bucket once ahead of traffic
        unless ``warmup=False``, and unregisters the model again when
        that raises.  ``device`` defaults to ``cuda:0``.  Returns the
        model's :class:`ProgramStore`."""
        if input_shapes is None:
            raise MXNetError("add_model needs input_shapes "
                             "(name -> (batch, ...) template)")
        if compute_dtype is None:
            compute_dtype = get_env("MXNET_SERVE_DTYPE") or None
        store = ProgramStore(symbol, arg_params, aux_params or {},
                             input_shapes, name=name,
                             compute_dtype=compute_dtype, buckets=buckets,
                             max_programs=max_programs,
                             input_dtypes=input_dtypes, device=device)
        with self._lock:
            if name in self._stores or name in self._gen_stores:
                raise MXNetError("model %r is already registered" % name)
            self._stores[name] = store
        if warmup:
            try:
                store.warmup()
            except BaseException:
                # a model whose programs fail must not stay registered
                with self._lock:
                    self._stores.pop(name, None)
                raise
        return store

    def load_checkpoint(self, name, prefix, epoch, input_shapes, **kwargs):
        """Register from a ``prefix-symbol.json`` + ``prefix-NNNN.params``
        pair (``model.save_checkpoint``'s layout, from either
        package)."""
        from ..model import load_checkpoint
        sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return self.add_model(name, sym, arg_params, aux_params,
                              input_shapes, **kwargs)

    def load_artifact(self, name, path, **overrides):
        """Register from a ``deploy.to_serving`` artifact (symbol JSON,
        params and bucket metadata in one zip, from either package);
        keyword overrides win over the artifact's recorded settings."""
        from ..deploy import read_serving_artifact
        sym, arg_params, aux_params, meta = read_serving_artifact(path)
        kwargs = {
            "input_shapes": {k: tuple(v)
                             for k, v in meta["input_shapes"].items()},
            "input_dtypes": meta.get("input_dtypes"),
            "buckets": meta.get("bucket_edges"),
            "compute_dtype": meta.get("compute_dtype"),
        }
        kwargs.update(overrides)
        return self.add_model(name, sym, arg_params, aux_params, **kwargs)

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
            if name in self._stores or name in self._gen_stores:
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

    def store(self, name):
        """The forward model's ProgramStore; raises when unknown."""
        with self._lock:
            store = self._stores.get(name)
            known = sorted(self._stores) if store is None else None
        if store is None:
            raise MXNetError("unknown serving model %r (registered: %s)"
                             % (name, known))
        return store

    def swap_params(self, name, arg_params, aux_params=None):
        """Hot weight swap under traffic: atomically republish forward
        model ``name``'s weights (``aux_params`` optionally refreshes its
        auxiliary states); every request runs against one version.
        Returns the new version.  (The generative stores' swap is not
        ported yet.)"""
        return self.store(name).swap_params(arg_params, aux_params)

    def param_snapshot(self, name):
        """Opaque handle to forward model ``name``'s live weight set, for
        :meth:`restore_params`."""
        return self.store(name).param_snapshot()

    def restore_params(self, name, snap):
        """Republish a :meth:`param_snapshot`; returns the new (still
        rising) version."""
        return self.store(name).restore_params(snap)

    def remove_model(self, name):
        with self._lock:
            self._drafts.pop(name, None)
            if self._stores.pop(name, None) is None and \
                    self._gen_stores.pop(name, None) is None:
                raise MXNetError("unknown serving model %r" % name)

    def models(self):
        with self._lock:
            return sorted(list(self._stores) + list(self._gen_stores))

    def stats(self):
        """Each model's store stats, by name."""
        with self._lock:
            stores = dict(self._stores)
            stores.update(self._gen_stores)
        return {name: s.stats() for name, s in stores.items()}

    def __contains__(self, name):
        with self._lock:
            return name in self._stores or name in self._gen_stores

    def __len__(self):
        with self._lock:
            return len(self._stores) + len(self._gen_stores)
