"""Model registry of the port's serving plane (generative models only;
counterpart of ``mxnet_tpu/serving/registry.py``)."""
from __future__ import annotations

import threading

from ..base import MXNetError, get_env
from .program_store import GenerativeProgramStore

__all__ = ["ModelRegistry"]


class ModelRegistry:
    """name -> :class:`GenerativeProgramStore`, with thread-safe add and
    remove."""

    def __init__(self):
        self._gen_stores = {}
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
        :class:`GenerativeProgramStore`; an unset ``compute_dtype`` falls
        back to ``MXNET_SERVE_DTYPE``.  ``device`` defaults to ``cuda:0``
        and raises without a GPU unless ``device="cpu"``.  Unless
        ``warmup=False``, runs one decode and one prefill-chunk step per
        batch bucket before returning the store."""
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
