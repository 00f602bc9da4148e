"""Shared infrastructure of the PyTorch/CUDA port: the error type and the
typed environment-variable registry.

Counterpart of ``mxnet_tpu/base.py``, reduced to what the port reads:
the ``MXNET_SERVE_*`` knobs of the serving path, the engine's
``MXNET_ENGINE_TYPE``, the trainer's ``MXNET_SPMD_PROGRAM_CACHE``,
``Module``'s ``MXNET_MODULE_FUSED`` and the input stager's
``MXNET_IO_STAGE`` / ``MXNET_IO_STAGE_DEPTH``, with the reference
package's names and defaults; they are documented in
``docs/port/env_vars.md``.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading

__all__ = ["MXNetError", "EnvVar", "env_registry", "register_env",
           "get_env", "atomic_write"]


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
        if self.type is bool:
            return raw.lower() not in ("0", "false", "off", "")
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


register_env("MXNET_ENGINE_TYPE", str, "ThreadedEnginePerDevice",
             "Execution mode: 'NaiveEngine' synchronises the device after "
             "every imperative op (readable backtraces when debugging); "
             "anything else keeps PyTorch's asynchronous launches.")
register_env("MXNET_SPMD_PROGRAM_CACHE", int, 64,
             "Bound on the LRU of trainer step programs "
             "(parallel/spmd.py): one entry per (symbol, device, input "
             "shapes, dtypes, optimizer statics, fixed parameters).")
register_env("MXNET_MODULE_FUSED", bool, True,
             "Module.fit's fused route: forward, backward and the "
             "optimizer update as one DataParallelTrainer step a batch "
             "(parallel/dp.py).  '0' keeps the classic executor group "
             "and host updater.")
register_env("MXNET_IO_STAGE", bool, True,
             "Overlapped input staging: Module.fit copies batch t+1 to "
             "the device on a producer thread (pinned memory, a side "
             "CUDA stream) while step t computes (io/stager.py).  '0' "
             "feeds the iterator's batches to the step as they are.")
register_env("MXNET_IO_STAGE_DEPTH", int, 2,
             "Batches the input stager holds ahead of the step (each "
             "holds one batch of device memory); 2 is double "
             "buffering, below 1 counts as 1.")
register_env("MXNET_SERVE_BUCKETS", str, "1,2,4,8,16,32",
             "Comma-separated batch-size bucket edges.  The forward "
             "ProgramStore pads a request of n rows to the smallest edge "
             ">= n and runs that bucket's program; the decode engine's "
             "slot table grows to the smallest edge >= the number of "
             "live sequences.")
register_env("MXNET_SERVE_DTYPE", str, "",
             "Default serving compute dtype of models registered without "
             "an explicit compute_dtype: empty or 'float32' serves fp32 "
             "weights, 'bfloat16' bf16 weights and activations (paged "
             "plane), 'int8' int8 weight-only codes through the "
             "dequant_matmul kernel.")
register_env("MXNET_SERVE_KV_DTYPE", str, "float32",
             "KV-cache element dtype of generative models registered "
             "without an explicit kv_dtype: 'float32', 'bfloat16' (paged "
             "plane: half the bytes a token) or 'int8' (paged plane): "
             "int8 pool codes with per-(layer, head, block) fp32 absmax "
             "scales, dequantized inside the paged attention kernel.")
register_env("MXNET_SERVE_PAGED", int, 1,
             "1 (default): the paged KV plane (a global block pool, "
             "chunked prefill, copy-on-write prefix sharing).  0: the "
             "contiguous plane (one cache rectangle per slot, one "
             "prefill per admitted group, then decode steps).")
register_env("MXNET_SERVE_INT8_GRANULARITY", str, "row",
             "Scale granularity of int8 weight-only serving: 'row' (one "
             "fp32 scale per output row) or 'tensor' (one scalar per "
             "weight).")
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
             "Comma-separated prompt-length bucket edges.  The contiguous "
             "plane pads each prefill to the smallest edge that holds "
             "its longest prompt and refuses longer prompts; the paged "
             "plane chunks prompts and only checks that the largest edge "
             "fits MXNET_SERVE_KV_MAX.")
register_env("MXNET_SERVE_SPEC", str, "auto",
             "Speculative decoding on the paged plane: 'auto' (default) "
             "speculates for any model with a draft attached through "
             "registry.add_draft_model and falls back to plain decode "
             "steps while the rolling acceptance stays below a floor, "
             "probing a speculative tick now and then; '1'/'on'/'force'/"
             "'always' always drafts; '0'/'off'/'false' never does.  "
             "Greedy streams stay identical to non-speculative decoding, "
             "sampled ones equal in distribution.")
register_env("MXNET_SERVE_SPEC_K", int, 4,
             "Draft tokens proposed a speculative tick by default (the "
             "target verifies K+1 positions in one paged step).")
register_env("MXNET_SERVE_MAX_INFLIGHT", int, 0,
             "Admission budget of a serving engine (forward or "
             "generation): accepted but unresolved requests beyond it "
             "are shed with ServeOverloaded.  0 = unbounded.")
register_env("MXNET_SERVE_MAX_DELAY_MS", float, 5.0,
             "Latency budget (milliseconds) of the forward serving "
             "engine's batcher: a batch is dispatched no later than this "
             "long after its oldest member was submitted, even when the "
             "largest bucket has not filled.  0 dispatches each request "
             "at once.")
register_env("MXNET_SERVE_MAX_BATCH", int, 32,
             "Most rows the forward serving engine coalesces into one "
             "dispatch (further capped by the model's largest bucket).")
register_env("MXNET_SERVE_PROGRAM_CACHE", int, 32,
             "Bucket programs a forward ProgramStore keeps in its LRU; "
             "beyond it the least recently used is dropped and rebuilt "
             "on its next use (stats count the evictions).")


_ATOMIC_WRITE_SEQ = itertools.count()


@contextlib.contextmanager
def atomic_write(path, mode="wb"):
    """Yield a handle onto a temporary file beside ``path``; on success
    it is flushed, fsynced and renamed over ``path``, so a reader never
    sees a half-written checkpoint and a crash keeps the old one.  The
    temporary name is unique per write (process id and a counter)."""
    tmp = "%s.tmp%d.%d" % (path, os.getpid(), next(_ATOMIC_WRITE_SEQ))
    f = open(tmp, mode)
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
    except BaseException:
        f.close()
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise
    f.close()
    os.replace(tmp, path)
