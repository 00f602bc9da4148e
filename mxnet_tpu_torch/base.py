"""Shared infrastructure of the PyTorch/CUDA port: the error type and the
typed environment-variable registry.

Counterpart of ``mxnet_tpu/base.py``, reduced to what the port reads.
Only the ``MXNET_SERVE_*`` knobs of the paged serving path are
registered, with the reference package's names and defaults; they are
documented in ``docs/port/env_vars.md``.
"""
from __future__ import annotations

import os
import threading

__all__ = ["MXNetError", "EnvVar", "env_registry", "register_env",
           "get_env"]


class MXNetError(Exception):
    """Framework error type (the reference package's ``MXNetError``)."""


class EnvVar:
    __slots__ = ("name", "type", "default", "doc")

    def __init__(self, name, type_, default, doc=""):
        self.name = name
        self.type = type_
        self.default = default
        self.doc = doc

    def get(self):
        raw = os.environ.get(self.name)
        if raw is None:
            return self.default
        try:
            return self.type(raw)
        except (TypeError, ValueError):
            return self.default


env_registry: dict = {}
_env_lock = threading.Lock()


def register_env(name, type_, default, doc=""):
    """Register a typed environment variable; returns the EnvVar handle."""
    with _env_lock:
        var = env_registry.get(name)
        if var is None:
            var = EnvVar(name, type_, default, doc)
            env_registry[name] = var
        return var


def get_env(name, default=None):
    """Read a registered env var (falling back to raw os.environ lookup)."""
    var = env_registry.get(name)
    if var is not None:
        return var.get()
    return os.environ.get(name, default)


register_env("MXNET_SERVE_BUCKETS", str, "1,2,4,8,16,32",
             "Comma-separated batch-size bucket edges of the generative "
             "program store: the decode engine's slot table grows to the "
             "smallest edge >= the number of live sequences.")
register_env("MXNET_SERVE_DTYPE", str, "",
             "Default serving compute dtype of models registered without "
             "an explicit compute_dtype.  The port serves fp32 only; "
             "any other value is refused.")
register_env("MXNET_SERVE_KV_BLOCK", int, 64,
             "Tokens per paged KV-pool block.")
register_env("MXNET_SERVE_KV_MAX", int, 1024,
             "Upper bound on a served sequence's length (prompt + "
             "generated tokens); longer requests are refused at submit.")
register_env("MXNET_SERVE_PREFILL_CHUNK", int, 32,
             "Chunked-prefill quantum: a prompt advances this many "
             "tokens per engine tick, interleaved with the decode steps "
             "of the running batch.  Clamped to MXNET_SERVE_KV_MAX.")
register_env("MXNET_SERVE_KV_POOL_BLOCKS", int, 0,
             "Physical block count of the paged KV pool, including the "
             "reserved trash block 0.  0 sizes the pool for the largest "
             "batch bucket at full depth: max_bucket * ceil(kv_max / "
             "kv_block) + 1.")
register_env("MXNET_SERVE_PROMPT_BUCKETS", str, "16,32,64,128",
             "Comma-separated prompt-length bucket edges.  The paged "
             "plane chunks prompts, so only the check that the largest "
             "edge fits MXNET_SERVE_KV_MAX reads them.")
register_env("MXNET_SERVE_MAX_INFLIGHT", int, 0,
             "Admission budget of a generation engine: accepted but "
             "unresolved requests beyond it are shed with "
             "ServeOverloaded.  0 = unbounded.")
