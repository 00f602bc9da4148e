"""Autoregressive generation engine, in PyTorch.

Counterpart of ``mxnet_tpu/serving/decode_engine.py`` (continuous
batching on the paged and the contiguous KV planes, with speculative
decoding on the paged plane; without metrics, tracing, priority tiers
or tenant quotas).  One daemon engine thread owns the loop; on the
paged plane (the default):

* **pump** — drain the submit queue into per-model FIFO waiting deques
  (blocking only when there is no admitted work at all);
* **admit** — claim a slot per waiting request, reserve its worst-case
  block need up front (FIFO, never overtaking: the head request waiting
  on pool space blocks everyone behind it, so the pool never exhausts
  mid-flight) and seed its block table from the copy-on-write prefix
  cache (:class:`_PrefixStore`), so an identical prompt prefix adopts
  the shared blocks instead of prefilling them again;
* **tick** — ONE decode step for every generating slot, then ONE
  ``prefill_chunk``-token chunk for every prefilling slot, so a long
  prompt does not stall the other streams.  Writes into a block someone
  else also references fork it first (copy on write).  Each step samples
  on the device and brings only the ``(slots,)`` token vector to the
  host;
* **retire** — a sequence reaching its ``eos_id`` or ``max_tokens``
  resolves its Future with a :class:`GenerationResult` (and closes its
  :class:`TokenStream`); its blocks return to the pool.

With a draft model attached (``registry.add_draft_model``) and
``MXNET_SERVE_SPEC`` not off, the decode step becomes a speculative tick:
the draft proposes up to ``spec_k`` tokens a generating slot in lq=1
micro-steps on its own KV pool (which rides the target's block tables),
the target verifies all K+1 positions in one paged step, and the
accept/reject rule runs on the device; the tick's one blocking fetch
brings the emitted tokens and their counts to the host.  Greedy streams
equal non-speculative decoding token for token, sampled ones in
distribution; rejected proposals roll back by the frontier alone.
Under ``auto`` the engine falls back to plain decode steps while the
rolling acceptance stays below a floor.

The KV pool is one global pair of tensors on the model's device,
``(layers, heads, pool_blocks * kv_block, head_dim)``, updated in place;
an int8 pool carries ``(layers, heads, pool_blocks)`` fp32 scale pools
beside it, and every fork and dispatch moves codes and scales together.

On the contiguous plane (``paged=False``) a model's live batch owns one
cache rectangle per slot, ``(layers, slots, heads, C, head_dim)``:
admission prefills each waiting group at once (padded to a prompt
bucket), samples its first tokens and copies its rows into free slots;
each tick is ONE decode step over every slot, growing the cache to the
next ``kv_block`` multiple when a sequence reaches its end.  A tick
that finds the batch drained drops its cache.

``close(drain=True)`` finishes every admitted and queued generation
before the thread exits; ``close(drain=False)`` fails everything fast
with :class:`~.scheduler.ServeClosed`.
"""
from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from ..base import MXNetError, get_env
from .program_store import sample_tokens
from .scheduler import (FutureCompleter, ServeClosed, ServeOverloaded,
                        ServeTimeout)

__all__ = ["GenerationEngine", "GenerationResult", "TokenStream"]

log = logging.getLogger(__name__)

_STOP = object()

_COUNTERS = ("requests", "prefills", "prefill_seqs", "decode_steps",
             "generated_tokens", "finished", "timeouts", "cancelled",
             "errors", "shed", "slot_grows", "prefix_hits",
             "prefix_hit_blocks", "prefix_hit_tokens", "cow_forks",
             "prefill_chunks", "shed_pool", "cache_grows",
             # speculative decoding (zero without a draft): spec_steps
             # counts verify steps (each one target step emitting 1..K+1
             # tokens, also counted in decode_steps), spec_proposed /
             # spec_accepted the draft tokens offered / accepted,
             # spec_draft_steps the draft's micro-steps by slot plus its
             # catch-up dispatches, spec_fallback_steps the ticks that
             # MXNET_SERVE_SPEC=auto served without drafting
             "spec_steps", "spec_proposed", "spec_accepted",
             "spec_draft_steps", "spec_fallback_steps")

# MXNET_SERVE_SPEC=auto's fallback, as the reference's: while the rolling
# acceptance EMA is below the floor the engine serves plain decode steps
# and probes one speculative tick every _SPEC_PROBE_EVERY ticks, doubling
# the gap after each failed probe up to _SPEC_PROBE_MAX (a recovery
# resets it)
_SPEC_EMA_DECAY = 0.75
_SPEC_EMA_FLOOR = 0.125
_SPEC_PROBE_EVERY = 128
_SPEC_PROBE_MAX = 2048
# xor'ed into a request's seed for its draft generator, so the target's
# and the draft's draws never come from one stream
_DRAFT_SEED_SALT = 0x5BEC5BEC9E3779B9


class GenerationResult:
    """One finished generation (what the request's Future resolves to).

    ``tokens`` — the generated ids (prompt excluded); ``finish_reason``
    — ``'eos'`` or ``'length'``; ``token_times`` — host
    ``perf_counter()`` stamps taken as each token was sampled."""

    __slots__ = ("model", "prompt_len", "tokens", "finish_reason",
                 "t_submit", "token_times")

    def __init__(self, model, prompt_len, tokens, finish_reason,
                 t_submit, token_times):
        self.model = model
        self.prompt_len = prompt_len
        self.tokens = tokens
        self.finish_reason = finish_reason
        self.t_submit = t_submit
        self.token_times = token_times

    @property
    def ttft_s(self):
        """Submit -> first generated token (seconds)."""
        return self.token_times[0] - self.t_submit

    def itl_s(self):
        """Inter-token gaps (seconds), one per token after the first."""
        return [b - a for a, b in zip(self.token_times,
                                      self.token_times[1:])]

    def __repr__(self):
        return ("GenerationResult(model=%r, %d tokens, %s)"
                % (self.model, len(self.tokens), self.finish_reason))


class TokenStream:
    """Blocking per-sequence token iterator: pass one to
    :meth:`GenerationEngine.submit` (``stream=``) and iterate it to see
    tokens as they are generated."""

    _CLOSE = object()

    def __init__(self):
        self._q = queue.Queue()

    def push(self, token):
        self._q.put(int(token))

    def close(self):
        self._q.put(self._CLOSE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._CLOSE:
            raise StopIteration
        return item


class _GenRequest:
    __slots__ = ("model", "prompt", "max_tokens", "temperature", "top_k",
                 "seed", "eos_id", "stream", "future", "deadline",
                 "t_submit", "tokens", "token_times", "seq")

    def __init__(self, model, prompt, max_tokens, temperature, top_k,
                 seed, eos_id, stream, future, deadline, t_submit, seq):
        self.model = model
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.seed = int(seed)
        self.eos_id = eos_id
        self.stream = stream
        self.future = future
        self.deadline = deadline
        self.t_submit = t_submit
        self.tokens = []
        self.token_times = []
        self.seq = seq


class _BlockPool:
    """Host-side allocator over the paged KV pool's physical blocks.

    Block 0 is the reserved trash block (zero table entries point at it;
    non-participating dispatch rows scribble there) and is never
    allocated.  Every allocated block carries a refcount: a sequence
    holding it in its table counts one, each prefix-cache pin counts one
    — a block frees when the last reference drops.  The engine thread
    mutates it; ``stats()`` reads it from client threads under the
    lock."""

    def __init__(self, num_blocks):
        self.num_blocks = int(num_blocks)
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._ref = {}
        self._hwm = 0
        self._lock = threading.Lock()

    def capacity(self):
        return self.num_blocks - 1

    @property
    def hwm(self):
        with self._lock:
            return self._hwm

    def used(self):
        with self._lock:
            return self.capacity() - len(self._free)

    def free_count(self):
        with self._lock:
            return len(self._free)

    def refcount(self, b):
        with self._lock:
            return self._ref.get(b, 0)

    def alloc(self):
        """One fresh block at refcount 1, or None when exhausted."""
        with self._lock:
            if not self._free:
                return None
            b = self._free.pop()
            self._ref[b] = 1
            used = self.capacity() - len(self._free)
            if used > self._hwm:
                self._hwm = used
            return b

    def ref(self, b):
        with self._lock:
            self._ref[b] += 1

    def deref(self, b):
        with self._lock:
            r = self._ref[b] - 1
            if r <= 0:
                del self._ref[b]
                self._free.append(b)
            else:
                self._ref[b] = r
            return r

    def shared(self):
        """Blocks currently referenced more than once."""
        with self._lock:
            return sum(1 for r in self._ref.values() if r > 1)


class _PrefixStore:
    """Copy-on-write prefix cache: exact prompt prefixes -> pinned pool
    blocks.

    Keys are the token tuples themselves (no hash collisions): a full
    block j of a completed prefill registers under
    ``tuple(prompt[:(j+1)*bs])``; a partial tail block under the WHOLE
    prompt tuple.  Each entry pins one refcount on its block, so shared
    prefixes outlive their registering sequence.  Matching walks full
    blocks longest-prefix-first and takes the tail only on an exact
    whole-prompt match.  Entries whose pin is the LAST reference are
    evictable (LRU) when the pool runs dry."""

    def __init__(self, pool, block_size):
        self._pool = pool
        self._bs = int(block_size)
        self._entries = collections.OrderedDict()  # tokens -> (blk, n)

    def __len__(self):
        return len(self._entries)

    def match(self, prompt):
        """Longest shared prefix of ``prompt``: ``(full_blocks, tail)``
        — physical block ids for whole shared blocks, plus the tail
        block on an exact whole-prompt match (else None).  Touches the
        matched entries' LRU position; refcounts are NOT taken."""
        bs = self._bs
        blocks = []
        j = 0
        while (j + 1) * bs <= len(prompt):
            key = tuple(prompt[:(j + 1) * bs])
            e = self._entries.get(key)
            if e is None or e[1] != bs:
                break
            self._entries.move_to_end(key)
            blocks.append(e[0])
            j += 1
        tail = None
        nt = len(prompt) % bs
        if nt and j == len(prompt) // bs:
            e = self._entries.get(tuple(prompt))
            if e is not None and e[1] == nt:
                self._entries.move_to_end(tuple(prompt))
                tail = e[0]
        return blocks, tail

    def register(self, prompt, table_row):
        """Pin a completed prefill's blocks for future sharing (+1
        refcount per NEW entry; prefixes already registered are left
        alone)."""
        bs = self._bs
        for j in range(len(prompt) // bs):
            key = tuple(prompt[:(j + 1) * bs])
            if key in self._entries:
                continue
            b = int(table_row[j])
            self._pool.ref(b)
            self._entries[key] = (b, bs)
        nt = len(prompt) % bs
        if nt:
            key = tuple(prompt)
            if key not in self._entries:
                b = int(table_row[len(prompt) // bs])
                self._pool.ref(b)
                self._entries[key] = (b, nt)

    def evictable(self):
        """Pins whose block would FREE on eviction (refcount 1)."""
        return sum(1 for b, _n in self._entries.values()
                   if self._pool.refcount(b) == 1)

    def evict_one(self):
        """Drop the least-recently-used pin whose block frees.  True
        when a block was reclaimed."""
        for key, (b, _n) in self._entries.items():
            if self._pool.refcount(b) == 1:
                del self._entries[key]
                self._pool.deref(b)
                return True
        return False


class _ModelState:
    """Live contiguous decode batch of one model: slot table, the KV
    cache ``(layers, slots, heads, C, head_dim)`` and per-slot sampling
    state."""

    paged = False

    def __init__(self, store):
        self.store = store
        self.slots = []                        # _GenRequest or None
        self.lengths = np.zeros(0, np.int32)   # cache frontier per slot
        self.next_tok = np.zeros(0, np.int32)  # next token to consume
        self.temps = np.zeros(0, np.float32)   # <= 0 means greedy
        self.top_ks = np.zeros(0, np.int32)
        self.gens = []                         # torch.Generator or None
        self.cache_k = None
        self.cache_v = None
        self.C = 0                             # current cache bucket

    def active(self):
        return [i for i, r in enumerate(self.slots) if r is not None]

    def free_slot(self):
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def describe(self):
        d = {"slots": len(self.slots), "active": len(self.active()),
             "paged": False, "cache_len": self.C}
        if self.cache_k is not None:
            total = 2 * self.cache_k.numel() * self.cache_k.element_size()
            d["cache_mb"] = round(total / 2**20, 3)
            d["cache_dtype"] = str(self.cache_k.dtype).replace("torch.", "")
            if self.slots:
                d["cache_bytes_per_slot"] = total // len(self.slots)
        return d


class _PagedModelState:
    """Live paged decode batch of one model: slot table, per-slot block
    tables over the global KV pool, per-slot sampling state and the
    prefix cache.  It persists across batch drains (the prefix cache's
    pinned blocks are the point of keeping it)."""

    paged = True

    def __init__(self, store, draft=None, spec_k=0):
        self.store = store
        self.pool = _BlockPool(store.pool_blocks)
        self.prefix = _PrefixStore(self.pool, store.kv_block)
        self.pool_k, self.pool_v = store.new_pool()
        # int8 plane: the per-(layer, head, block) fp32 scale pools ride
        # beside the code pools through every fork and dispatch
        self.scales = store.new_scale_pool() if store.kv_int8 else None
        self.tb = store.table_width()
        self.slots = []                        # _GenRequest or None
        self.tables = np.zeros((0, self.tb), np.int32)
        self.lengths = np.zeros(0, np.int32)   # KV frontier per slot
        self.prog = np.zeros(0, np.int32)      # prompt tokens consumed
        self.decoding = np.zeros(0, bool)      # prompt done, generating
        self.chunks_done = np.zeros(0, np.int32)
        self.next_tok = np.zeros(0, np.int32)
        self.temps = np.zeros(0, np.float32)   # <= 0 means greedy
        self.top_ks = np.zeros(0, np.int32)
        self.resv = np.zeros(0, np.int32)      # reserved-unallocated
        self.gens = []                         # torch.Generator or None
        # speculative decoding: the draft's own pools ride the target's
        # block tables (one allocator, two KV planes); dlen is the
        # draft's KV frontier per slot, dgens its generators
        self.draft = draft
        self.spec_k = int(spec_k)
        if draft is not None:
            self.dpool_k, self.dpool_v = draft.new_pool()
            self.dscales = draft.new_scale_pool() if draft.kv_int8 else None
            self.dlen = np.zeros(0, np.int32)
            self.dgens = []
            # MXNET_SERVE_SPEC=auto: the rolling acceptance and the probe
            # countdown while speculation is suspended
            self.spec_ema = 1.0
            self.spec_probe = _SPEC_PROBE_EVERY
            self.spec_probe_every = _SPEC_PROBE_EVERY
            self.spec_forced = False

    def spec_mirror(self):
        """Whether prompt chunks are mirrored into the draft's KV plane:
        while speculating, not while the fallback has it suspended (a
        probe's catch-up then rebuilds the draft KV from the prompt)."""
        return self.spec_forced or self.spec_ema >= _SPEC_EMA_FLOOR

    def active(self):
        return [i for i, r in enumerate(self.slots) if r is not None]

    def free_slot(self):
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def reserved_total(self):
        return int(self.resv.sum())

    def describe(self):
        # an int8 pool counts its fp32 scale pools: a block decodes only
        # as codes and scale together
        pool_bytes = 2 * self.pool_k.numel() * self.pool_k.element_size()
        if self.scales is not None:
            pool_bytes += 2 * self.scales[0].numel() * \
                self.scales[0].element_size()
        per_block = pool_bytes // self.store.pool_blocks
        used = self.pool.used()
        d = {"slots": len(self.slots), "active": len(self.active()),
             "paged": True,
             "block_size": self.store.kv_block,
             "prefill_chunk": self.store.prefill_chunk,
             "pool_blocks": self.pool.capacity(),
             "pool_blocks_used": used,
             "pool_blocks_hwm": self.pool.hwm,
             "pool_blocks_shared": self.pool.shared(),
             "pool_blocks_reserved": self.reserved_total(),
             "prefix_entries": len(self.prefix),
             "cache_mb": round(pool_bytes / 2**20, 3),
             "pool_bytes": pool_bytes,
             "pool_bytes_used": used * per_block,
             "pool_bytes_per_token": per_block / self.store.kv_block,
             "block_bytes": per_block,
             "cache_dtype": str(self.pool_k.dtype).replace("torch.", "")}
        if self.draft is not None:
            dbytes = 2 * self.dpool_k.numel() * self.dpool_k.element_size()
            if self.dscales is not None:
                dbytes += 2 * self.dscales[0].numel() * \
                    self.dscales[0].element_size()
            d.update(spec_k=self.spec_k, draft_pool_bytes=dbytes,
                     spec_acceptance_ema=round(float(self.spec_ema), 4))
        return d


class GenerationEngine:
    """Continuous-batching autoregressive generation over a
    :class:`~.registry.ModelRegistry`'s generative models, on the paged
    KV plane.

    ``submit(model, tokens, ...)`` returns a
    ``concurrent.futures.Future`` resolving to a
    :class:`GenerationResult`.  One engine serves every generative model
    in the registry; a step never mixes models."""

    def __init__(self, registry, max_inflight=None):
        self._registry = registry
        if max_inflight is None:
            max_inflight = int(get_env("MXNET_SERVE_MAX_INFLIGHT"))
        self._max_inflight = max(0, int(max_inflight))  # 0 = unbounded
        self._inflight = 0
        self._queue = queue.Queue()
        self._waiting = {}     # model -> deque[_GenRequest]
        self._states = {}      # model -> _PagedModelState
        self._closed = False
        self._drain_on_stop = True
        self._seq = 0
        self._submit_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats = dict.fromkeys(_COUNTERS, 0)
        self._max_active_seen = 0
        self._cache_hwm = {}   # model -> describe() at its largest cache
        self._completer = FutureCompleter("mxtt-gen-done")
        self._thread = threading.Thread(target=self._serve_loop,
                                        name="mxtt-gen", daemon=True)
        self._thread.start()

    def _inc(self, name, n=1):
        with self._stats_lock:
            self._stats[name] += n

    # -- client side ---------------------------------------------------
    def submit(self, model, tokens, max_tokens=16, temperature=0.0,
               top_k=0, seed=0, eos_id=None, stream=None, timeout=None):
        """Enqueue one generation request; returns its Future.

        ``tokens`` — prompt token ids (non-empty); ``max_tokens`` —
        generation cap (>= 1; prompt + generation must fit
        ``MXNET_SERVE_KV_MAX``); ``temperature <= 0`` is greedy,
        otherwise sampling over the ``top_k`` highest logits (``top_k=0``
        = full vocab) from a generator seeded with ``seed``; ``eos_id``
        stops early; ``stream`` — an optional :class:`TokenStream`;
        ``timeout`` (seconds) bounds the wait for admission."""
        with self._submit_lock:
            if self._closed:
                raise ServeClosed("generation engine is closed")
        store = self._registry.gen_store(model)
        # coerce every field BEFORE the admission bookkeeping, so a bad
        # field can never leak an inflight slot
        try:
            prompt = [int(t) for t in tokens]
            max_tokens = int(max_tokens)
            temperature = float(temperature)
            top_k = int(top_k)
            seed = int(seed)
            eos_id = None if eos_id is None else int(eos_id)
            timeout = None if timeout is None else float(timeout)
        except (TypeError, ValueError) as e:
            raise MXNetError("invalid generation parameter: %s" % e)
        if not prompt:
            raise MXNetError("empty prompt")
        vocab = store.spec["vocab_size"]
        if min(prompt) < 0 or max(prompt) >= vocab:
            raise MXNetError("prompt token out of range [0, %d)" % vocab)
        if max_tokens < 1:
            raise MXNetError("max_tokens must be >= 1")
        store.validate_request(len(prompt), max_tokens)
        fut = Future()
        now = time.monotonic()
        with self._submit_lock:
            if self._closed:
                raise ServeClosed("generation engine is closed")
            if self._max_inflight and self._inflight >= self._max_inflight:
                self._inc("shed")
                raise ServeOverloaded(
                    "generation engine is at its inflight budget (%d); "
                    "request shed — back off and retry"
                    % self._max_inflight)
            self._inflight += 1
            req = _GenRequest(model, prompt, max_tokens, temperature,
                              top_k, seed, eos_id, stream, fut,
                              now + timeout if timeout is not None
                              else None, time.perf_counter(), self._seq)
            self._seq += 1
            self._queue.put(req)
        fut.add_done_callback(lambda _f: self._note_resolved())
        self._inc("requests")
        return fut

    def _note_resolved(self):
        with self._submit_lock:
            self._inflight -= 1

    def alive(self):
        with self._submit_lock:
            closed = self._closed
        return not closed and self._thread.is_alive()

    def stats(self):
        """Counters (``requests``, ``decode_steps``, ``generated_tokens``,
        ``finished``, ``prefix_hits``, ``cow_forks``, ``prefill_chunks``,
        ``shed_pool``, ``cache_grows``, the ``spec_*`` counters of
        speculative decoding, ...), per-model KV state (with a draft:
        ``spec_k``, ``draft_pool_bytes``, ``spec_acceptance_ema``) and
        each model's KV state at its largest cache (``cache_hwm``)."""
        with self._stats_lock:
            out = dict(self._stats)
            out["max_active"] = self._max_active_seen
            out["cache_hwm"] = dict(self._cache_hwm)
        with self._submit_lock:
            out["inflight"] = self._inflight
        out["max_inflight"] = self._max_inflight
        out["models"] = {m: st.describe()
                         for m, st in dict(self._states).items()}
        return out

    def close(self, drain=True, timeout=120.0):
        """Stop the engine.  ``drain=True`` (default) runs every admitted
        AND queued generation to completion first; ``drain=False`` fails
        queued and in-flight work fast with ServeClosed.  Idempotent;
        joins the engine thread."""
        with self._submit_lock:
            if not self._closed:
                self._closed = True
                self._drain_on_stop = bool(drain)
                self._queue.put(_STOP)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise MXNetError("generation engine thread failed to stop "
                             "within %.0fs" % timeout)
        self._completer.close(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- engine thread -------------------------------------------------
    def _serve_loop(self):
        try:
            stopping = False
            while True:
                stopping = self._pump(stopping) or stopping
                if stopping and not self._drain_on_stop:
                    self._fail_all()
                    return
                self._admit_ready()
                self._decode_tick()
                if stopping and not self._has_work():
                    return
        except Exception:
            log.exception("generation engine loop crashed")
            raise
        finally:
            # the loop is gone (clean close OR crash): latch closed and
            # fail anything still queued, waiting or in flight — an
            # accepted request is never silently dropped
            with self._submit_lock:
                self._closed = True
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not _STOP:
                    self._fail_request(item, ServeClosed(
                        "generation engine dispatch loop exited before "
                        "this request could be served"))
            self._fail_all()

    def _has_work(self):
        if any(self._waiting.values()):
            return True
        return any(st.active() for st in self._states.values())

    def _pump(self, stopping):
        """Move queued requests into the per-model FIFO waiting deques.
        Blocks only when the engine is otherwise idle.  Returns True
        when _STOP was seen."""
        stop_seen = False
        block = not stopping and not self._has_work()
        while True:
            try:
                item = self._queue.get() if block \
                    else self._queue.get_nowait()
            except queue.Empty:
                break
            block = False
            if item is _STOP:
                stop_seen = True
                continue
            self._waiting.setdefault(item.model,
                                     collections.deque()).append(item)
        return stop_seen

    # -- admission -----------------------------------------------------
    def _admit_ready(self):
        for model in list(self._waiting):
            dq = self._waiting.get(model)
            if dq:
                try:
                    store = self._registry.gen_store(model)
                except MXNetError as e:   # model removed after submit
                    while dq:
                        self._fail_request(dq.popleft(), e)
                else:
                    if store.paged:
                        self._admit_paged(model, dq, store)
                    else:
                        self._admit_contiguous(model, dq, store)
            if not self._waiting.get(model):
                self._waiting.pop(model, None)

    def _paged_state(self, model, store):
        st = self._states.get(model)
        if st is None:
            # speculative decoding's gate, resolved once, when the state
            # is made: a draft attached through registry.add_draft_model
            # and MXNET_SERVE_SPEC not off.  Attach drafts before the
            # model's first request.
            spec = str(get_env("MXNET_SERVE_SPEC") or "auto").lower()
            draft = None
            if spec not in ("0", "off", "false"):
                draft = self._registry.draft_store(model)
            st = self._states[model] = _PagedModelState(
                store, draft=draft,
                spec_k=draft.spec_k if draft is not None else 0)
            if draft is not None:
                # auto degrades to plain decode when the rolling
                # acceptance collapses; on/force always drafts
                st.spec_forced = spec in ("1", "on", "force", "always")
            store.cache_state = st
        return st

    def _paged_alloc(self, st):
        """One fresh pool block, evicting LRU prefix pins if the free
        list is dry.  Exhaustion raises — admission reservations exist
        to make that unreachable."""
        b = st.pool.alloc()
        while b is None and st.prefix.evict_one():
            b = st.pool.alloc()
        if b is None:
            raise MXNetError(
                "paged KV pool exhausted (%d blocks) — admission "
                "reservations should have prevented this"
                % st.pool.capacity())
        return b

    def _admit_paged(self, model, dq, store):
        """Claim a slot per waiting request, seed its block table from
        the prefix cache (shared blocks adopted at +1 refcount each) and
        leave the remaining prompt for the tick loop to chunk through.
        FIFO, never overtaking."""
        st = self._paged_state(model, store)
        bs = store.kv_block
        cap = store.max_slots()
        admitted = 0
        while dq:
            now = time.monotonic()
            r = dq[0]
            if r.deadline is not None and now > r.deadline:
                dq.popleft()
                self._fail_request(r, ServeTimeout(
                    "generation request for %r timed out after %.1f ms "
                    "in queue" % (model, (now - r.t_submit) * 1e3)),
                    kind="timeouts")
                continue
            if len(st.active()) >= cap:
                break
            total_blocks = -(-(len(r.prompt) + r.max_tokens) // bs)
            blocks, tail = st.prefix.match(r.prompt)
            # a partially filled last prompt block gets pinned by the
            # prefix cache at registration, so the first decode write
            # into it must fork — one allocation past total_blocks.  A
            # tail HIT already counts its fork target in total_blocks
            fork_extra = int(len(r.prompt) % bs != 0 and tail is None)
            needed = total_blocks - len(blocks) + fork_extra
            if total_blocks + fork_extra > st.pool.capacity():
                # can never fit, even against an empty pool: shed
                dq.popleft()
                self._inc("shed_pool")
                self._inc("shed")
                self._fail_request(r, ServeOverloaded(
                    "request needs %d KV blocks, past the paged pool's "
                    "%d usable blocks — shed"
                    % (total_blocks + fork_extra, st.pool.capacity())))
                continue
            budget = (st.pool.free_count() + st.prefix.evictable() -
                      st.reserved_total())
            if needed > budget:
                break   # wait for retirements; no overtaking
            dq.popleft()
            if not r.future.set_running_or_notify_cancel():
                self._inc("cancelled")
                continue
            slot = st.free_slot()
            if slot is None:
                self._grow_paged_slots(st, store.batch_bucket(
                    len(st.active()) + 1))
                slot = st.free_slot()
            row = st.tables[slot]
            row[:] = 0
            for j, b in enumerate(blocks):
                row[j] = b
                st.pool.ref(b)
            covered = len(blocks) * bs
            if tail is not None:
                row[len(blocks)] = tail
                st.pool.ref(tail)
                covered = len(r.prompt)
            if covered:
                self._inc("prefix_hits")
                self._inc("prefix_hit_blocks",
                          len(blocks) + (tail is not None))
                self._inc("prefix_hit_tokens", covered)
            # shared tokens skip recomputation, but the LAST prompt
            # token always reruns: its logits seed the first sample
            prog = min(covered, len(r.prompt) - 1)
            st.prog[slot] = prog
            st.lengths[slot] = prog
            st.decoding[slot] = False
            st.chunks_done[slot] = 0
            st.slots[slot] = r
            st.next_tok[slot] = 0
            st.temps[slot] = r.temperature
            st.top_ks[slot] = r.top_k
            st.resv[slot] = needed
            st.gens[slot] = self._generator(store, r)
            if st.draft is not None:
                # the draft's frontier starts at the shared-prefix
                # coverage like the target's (its rows were mirrored when
                # those blocks were prefilled); with the mirror off they
                # are unwritten, so it claims none and a probe's catch-up
                # rebuilds them from the prompt
                st.dlen[slot] = prog if st.spec_mirror() else 0
                st.dgens[slot] = self._generator(store, r, _DRAFT_SEED_SALT)
            admitted += 1
        if admitted:
            self._inc("prefill_seqs", admitted)
            with self._stats_lock:
                self._max_active_seen = max(self._max_active_seen,
                                            len(st.active()))

    # -- contiguous plane ----------------------------------------------
    def _admit_contiguous(self, model, dq, store):
        """Prefill every waiting request that a free slot can take, as
        one padded batch; sample each one's first token and copy the
        survivors' cache rows into free slots.  FIFO."""
        st = self._states.get(model)
        free = store.max_slots() - (len(st.active()) if st else 0)
        group = []
        now = time.monotonic()
        while dq and len(group) < free:
            r = dq.popleft()
            if r.deadline is not None and now > r.deadline:
                self._fail_request(r, ServeTimeout(
                    "generation request for %r timed out after %.1f ms "
                    "in queue" % (model, (now - r.t_submit) * 1e3)),
                    kind="timeouts")
            elif r.future.set_running_or_notify_cancel():
                group.append(r)
            else:
                self._inc("cancelled")
        if not group:
            return
        toks, lens = store.pad_prompts([r.prompt for r in group])
        bb = toks.shape[0]
        gens = [None] * bb
        temps = np.zeros(bb, np.float32)
        top_ks = np.zeros(bb, np.int32)
        for i, r in enumerate(group):
            temps[i], top_ks[i] = r.temperature, r.top_k
            gens[i] = self._generator(store, r)
        try:
            first_logits, pk, pv = store.run_prefill(toks, lens)
            with torch.no_grad():
                first = sample_tokens(
                    first_logits, temps, top_ks, gens,
                    np.arange(bb) < len(group)).cpu().numpy()
        except Exception as e:  # noqa: BLE001 — forwarded to the futures
            log.error("prefill dispatch failed: %r", e)
            err = e if isinstance(e, MXNetError) \
                else MXNetError("prefill dispatch failed: %r" % (e,))
            for r in group:
                self._fail_request(r, err, running=True)
            return
        self._inc("prefills")
        self._inc("prefill_seqs", len(group))
        survivors = []
        for i, r in enumerate(group):
            tok = int(first[i])
            self._push_token(r, tok)
            reason = self._finished_reason(r, tok)
            if reason:
                self._finish(r, reason)
            else:
                survivors.append(i)
        if not survivors:
            return
        if st is None:
            st = self._states[model] = _ModelState(store)
            store.cache_state = st
        need = len(st.active()) + len(survivors)
        if need > len(st.slots):
            self._grow_slots(st, store.batch_bucket(need))
        Cp = int(pk.shape[3])
        if st.cache_k is None:
            st.cache_k, st.cache_v = store.new_cache(len(st.slots), Cp)
            st.C = Cp
        elif Cp > st.C:
            self._grow_cache(st, store.kv_bucket(Cp))
        for i in survivors:
            r = group[i]
            slot = st.free_slot()
            self._admit_row(st, pk, pv, i, slot)
            st.slots[slot] = r
            st.lengths[slot] = len(r.prompt)
            st.next_tok[slot] = r.tokens[-1]
            st.temps[slot] = r.temperature
            st.top_ks[slot] = r.top_k
            st.gens[slot] = gens[i]
        self._note_cache_hwm(model, st)
        with self._stats_lock:
            self._max_active_seen = max(self._max_active_seen,
                                        len(st.active()))

    @staticmethod
    def _generator(store, r, salt=0):
        """The request's own sampling generator, seeded on the host with
        its seed xor ``salt`` (the draft's generator takes a fixed salt;
        None for a greedy request)."""
        if r.temperature <= 0:
            return None
        g = torch.Generator(device=store.device)
        g.manual_seed((r.seed ^ salt) & 0xFFFFFFFFFFFFFFFF)
        return g

    def _note_cache_hwm(self, model, st):
        d = st.describe()
        with self._stats_lock:
            prev = self._cache_hwm.get(model)
            if prev is None or d.get("cache_mb", 0.0) >= \
                    prev.get("cache_mb", 0.0):
                self._cache_hwm[model] = d

    @staticmethod
    def _admit_row(st, pk, pv, row, slot):
        """Copy row ``row`` of a prefill's caches into decode slot
        ``slot``, zero past the prefill's length (in place)."""
        Cp = int(pk.shape[3])
        for cache, src in ((st.cache_k, pk), (st.cache_v, pv)):
            cache[:, slot].zero_()
            cache[:, slot, :, :Cp].copy_(src[:, row])

    def _grow_slots(self, st, new_bb):
        """Contiguous plane: more slots, the cache padded with zero
        rows."""
        grow = new_bb - len(st.slots)
        st.slots.extend([None] * grow)
        st.gens.extend([None] * grow)
        for name in ("lengths", "next_tok", "top_ks", "temps"):
            arr = getattr(st, name)
            setattr(st, name, np.concatenate(
                [arr, np.zeros(grow, arr.dtype)]))
        if st.cache_k is not None:
            pad = (0, 0, 0, 0, 0, 0, 0, grow)
            st.cache_k = torch.nn.functional.pad(st.cache_k, pad)
            st.cache_v = torch.nn.functional.pad(st.cache_v, pad)
        self._inc("slot_grows")

    def _grow_cache(self, st, new_c):
        """Contiguous plane: a longer cache, zero past the old length."""
        pad = (0, 0, 0, new_c - st.C)
        st.cache_k = torch.nn.functional.pad(st.cache_k, pad)
        st.cache_v = torch.nn.functional.pad(st.cache_v, pad)
        st.C = new_c
        self._inc("cache_grows")
        self._note_cache_hwm(st.store.name, st)

    def _contiguous_tick(self, model, st):
        """ONE decode step for every slot of a contiguous batch (empty
        slots ride along on token 0 at position 0; their output is
        discarded and a new admission overwrites their row)."""
        act = st.active()
        if not act:
            # batch drained: drop the cache until the next admission
            self._states.pop(model)
            st.store.cache_state = None
            return
        needed = int(st.lengths[act].max()) + 1
        if needed > st.C:
            self._grow_cache(st, st.store.kv_bucket(needed))
        try:
            toks_dev, st.cache_k, st.cache_v = st.store.run_decode_sample(
                st.cache_k, st.cache_v, st.next_tok, st.lengths, st.gens,
                st.temps, st.top_ks)
            sampled = toks_dev.cpu().numpy()
        except Exception as e:  # noqa: BLE001 — forwarded to the futures
            log.error("decode dispatch failed: %r", e)
            err = e if isinstance(e, MXNetError) \
                else MXNetError("decode dispatch failed: %r" % (e,))
            for i in act:
                r = st.slots[i]
                self._clear_slot(st, i)
                self._fail_request(r, err, running=True)
            return
        for i in act:
            r = st.slots[i]
            st.lengths[i] += 1
            tok = int(sampled[i])
            self._push_token(r, tok)
            st.next_tok[i] = tok
            reason = self._finished_reason(r, tok)
            if reason:
                self._clear_slot(st, i)
                self._finish(r, reason)
        self._inc("decode_steps")
        self._inc("generated_tokens", len(act))

    @staticmethod
    def _clear_slot(st, i):
        st.slots[i] = None
        st.gens[i] = None
        st.lengths[i] = 0
        st.next_tok[i] = 0
        st.temps[i] = 0.0
        st.top_ks[i] = 0

    # -- paged plane ---------------------------------------------------
    def _grow_paged_slots(self, st, new_bb):
        grow = new_bb - len(st.slots)
        st.slots.extend([None] * grow)
        st.gens.extend([None] * grow)
        st.tables = np.concatenate(
            [st.tables, np.zeros((grow, st.tb), np.int32)])
        names = ("lengths", "prog", "chunks_done", "next_tok", "top_ks",
                 "resv", "temps", "decoding")
        if st.draft is not None:
            names += ("dlen",)
            st.dgens.extend([None] * grow)
        for name in names:
            arr = getattr(st, name)
            setattr(st, name, np.concatenate(
                [arr, np.zeros(grow, arr.dtype)]))
        self._inc("slot_grows")

    def _release_slot(self, st, i):
        """Drop slot i's block references and bookkeeping (the prefix
        cache's pins keep shared blocks alive past this)."""
        for j in range(st.tb):
            b = int(st.tables[i, j])
            if b:
                st.pool.deref(b)
        st.tables[i, :] = 0
        st.slots[i] = None
        st.gens[i] = None
        st.lengths[i] = 0
        st.prog[i] = 0
        st.decoding[i] = False
        st.chunks_done[i] = 0
        st.next_tok[i] = 0
        st.temps[i] = 0.0
        st.top_ks[i] = 0
        st.resv[i] = 0
        if st.draft is not None:
            st.dlen[i] = 0
            st.dgens[i] = None

    # -- ticks ---------------------------------------------------------
    def _decode_tick(self):
        for model, st in list(self._states.items()):
            if not st.paged:
                self._contiguous_tick(model, st)
                continue
            dec = [i for i in st.active() if st.decoding[i]]
            if dec:
                if st.draft is not None and self._spec_active(st):
                    self._spec_step(model, st, dec)
                else:
                    self._decode_step(model, st, dec)
            pre = [i for i in st.active() if not st.decoding[i]]
            if pre:
                self._prefill_chunk(model, st, pre)

    def _write_ready(self, st, i, positions):
        """Make slot i's table writable at ``positions``: allocate
        entries still at 0 and copy-on-write-fork any covering block
        someone else also references (refcount > 1).  Recomputed prompt
        positions rewrite shared blocks with identical values, so
        callers pass only new positions."""
        bs = st.store.kv_block
        for j in sorted({p // bs for p in positions}):
            b = int(st.tables[i, j])
            if b == 0:
                st.tables[i, j] = self._paged_alloc(st)
                st.resv[i] = max(0, int(st.resv[i]) - 1)
            elif st.pool.refcount(b) > 1:
                nb = self._paged_alloc(st)
                # int8: codes and per-block scales fork together
                st.store.copy_block(st.pool_k, st.pool_v, b, nb,
                                    scales=st.scales)
                if st.draft is not None:
                    # the draft plane shares the block tables, so its
                    # pool forks the same physical block
                    st.draft.copy_block(st.dpool_k, st.dpool_v, b, nb,
                                        scales=st.dscales)
                st.pool.deref(b)
                st.tables[i, j] = nb
                st.resv[i] = max(0, int(st.resv[i]) - 1)
                self._inc("cow_forks")

    def _dispatch(self, st, tables, toks, pos, val, do):
        """One paged step (decode or prompt chunk) with sampling on the
        device; returns the sampled tokens as a host array."""
        out = st.store.run_paged_step_sample(
            st.pool_k, st.pool_v, tables, toks, pos, val, st.gens,
            st.temps, st.top_ks, do, scales=st.scales)
        toks_dev, st.pool_k, st.pool_v = out[:3]
        if st.scales is not None:
            st.scales = out[3:]
        return toks_dev.cpu().numpy()

    def _fail_rows(self, st, rows, exc, what):
        log.error("%s dispatch failed: %r", what, exc)
        err = exc if isinstance(exc, MXNetError) \
            else MXNetError("%s dispatch failed: %r" % (what, exc))
        for i in rows:
            r = st.slots[i]
            self._release_slot(st, i)
            self._fail_request(r, err, running=True)

    def _decode_step(self, model, st, dec):
        """Advance every generating slot one token.  Slots mid-prefill
        and empty slots ride the step with all-zero tables: their writes
        land in the trash block and their outputs are discarded."""
        for i in dec:
            self._write_ready(st, i, [int(st.lengths[i])])
        n = len(st.slots)
        tables = np.zeros((n, st.tb), np.int32)
        toks = np.zeros((n, 1), np.int32)
        pos = np.zeros((n,), np.int32)
        val = np.ones((n,), np.int32)
        do = np.zeros((n,), bool)
        for i in dec:
            tables[i] = st.tables[i]
            toks[i, 0] = st.next_tok[i]
            pos[i] = st.lengths[i]
            do[i] = True
        try:
            sampled = self._dispatch(st, tables, toks, pos, val, do)
        except Exception as e:  # noqa: BLE001 — forwarded to the futures
            self._fail_rows(st, dec, e, "decode")
            return
        for i in dec:
            r = st.slots[i]
            st.lengths[i] += 1
            tok = int(sampled[i])
            self._push_token(r, tok)
            st.next_tok[i] = tok
            reason = self._finished_reason(r, tok)
            if reason:
                self._release_slot(st, i)
                self._finish(r, reason)
        self._inc("decode_steps")
        self._inc("generated_tokens", len(dec))

    def _prefill_chunk(self, model, st, pre):
        """Advance every prefilling slot one prompt chunk.  Rows that
        finish their prompt here sample their first token, register
        their blocks with the prefix cache and flip to decoding."""
        store = st.store
        bs = store.kv_block
        chunk = store.prefill_chunk
        rows = []
        for i in pre:
            r = st.slots[i]
            p0 = int(st.prog[i])
            ntok = min(chunk, len(r.prompt) - p0)
            # blocks covering NEW positions only: recomputed shared
            # positions rewrite shared blocks with identical values
            fresh = [p for p in range(p0, p0 + ntok)
                     if st.tables[i, p // bs] == 0]
            self._write_ready(st, i, fresh)
            rows.append((i, r, p0, ntok))
        n = len(st.slots)
        tables = np.zeros((n, st.tb), np.int32)
        toks = np.zeros((n, chunk), np.int32)
        pos = np.zeros((n,), np.int32)
        val = np.ones((n,), np.int32)
        do = np.zeros((n,), bool)
        for i, r, p0, ntok in rows:
            tables[i] = st.tables[i]
            toks[i, :ntok] = r.prompt[p0:p0 + ntok]
            pos[i] = p0
            val[i] = ntok
            do[i] = (p0 + ntok == len(r.prompt))
        mirror = st.draft is not None and st.spec_mirror()
        try:
            sampled = self._dispatch(st, tables, toks, pos, val, do)
            if mirror:
                # the same chunk into the draft's KV plane (logits
                # discarded): same tables, same tokens, so prefix-shared
                # blocks hold valid draft rows for every adopter
                st.draft.run_paged_step(st.dpool_k, st.dpool_v, tables,
                                        toks, pos, val, scales=st.dscales)
        except Exception as e:  # noqa: BLE001 — forwarded to the futures
            self._fail_rows(st, [i for i, _r, _p, _n in rows], e,
                            "prefill")
            return
        self._inc("prefills")
        self._inc("prefill_chunks", len(rows))
        for i, r, p0, ntok in rows:
            st.prog[i] = p0 + ntok
            st.lengths[i] = p0 + ntok
            if mirror:
                st.dlen[i] = p0 + ntok
            st.chunks_done[i] += 1
            if p0 + ntok < len(r.prompt):
                continue
            st.prefix.register(r.prompt, st.tables[i])
            tok = int(sampled[i])
            self._push_token(r, tok)
            reason = self._finished_reason(r, tok)
            if reason:
                self._release_slot(st, i)
                self._finish(r, reason)
            else:
                st.decoding[i] = True
                st.next_tok[i] = tok
        self._note_cache_hwm(model, st)

    # -- speculative decoding ------------------------------------------
    def _spec_active(self, st):
        """MXNET_SERVE_SPEC=auto's gate, checked once a tick: speculate
        while the rolling acceptance holds; else serve a plain decode
        step (the same streams), probing a speculative tick on a
        backing-off cadence to notice recovery."""
        if st.spec_forced or st.spec_ema >= _SPEC_EMA_FLOOR:
            st.spec_probe_every = _SPEC_PROBE_EVERY
            st.spec_probe = _SPEC_PROBE_EVERY
            return True
        st.spec_probe -= 1
        if st.spec_probe <= 0:
            # the probe's acceptance lands in the EMA before the next
            # gate: a recovered draft re-engages (and resets the cadence
            # above), a hostile one waits twice as long for the next
            st.spec_probe_every = min(2 * st.spec_probe_every,
                                      _SPEC_PROBE_MAX)
            st.spec_probe = st.spec_probe_every
            return True
        self._inc("spec_fallback_steps")
        return False

    @staticmethod
    def _history(r, idx):
        """Token at position ``idx`` of request ``r``'s sequence: the
        prompt, then the emitted tokens."""
        n = len(r.prompt)
        return r.prompt[idx] if idx < n else r.tokens[idx - n]

    def _spec_catch_up(self, st, dec, gap):
        """Bring the draft's KV frontier up to the target's when some
        slot lags by more than one token (after fallback ticks, or a slot
        admitted with the mirror off): the tokens are known, so they go
        through the draft's prefill door teacher-forced, one call a
        ``prefill_chunk`` (a per-row ``valid`` masks ragged gaps), the
        logits discarded.  Leaves every gap at 0."""
        draft = st.draft
        n = len(st.slots)
        chunk = draft.prefill_chunk
        done = 0
        while done < max(gap.values()):
            tables = np.zeros((n, st.tb), np.int32)
            toks = np.zeros((n, chunk), np.int32)
            pos = np.zeros((n,), np.int32)
            val = np.ones((n,), np.int32)
            for i in dec:
                take = min(chunk, gap[i] - done)
                if take <= 0:
                    continue
                base = int(st.dlen[i]) + done
                for c in range(take):
                    toks[i, c] = self._history(st.slots[i], base + c)
                tables[i] = st.tables[i]
                pos[i] = base
                val[i] = take
            draft.run_paged_step(st.dpool_k, st.dpool_v, tables, toks, pos,
                                 val, scales=st.dscales)
            self._inc("spec_draft_steps")
            done += chunk
        for i in dec:
            st.dlen[i] += gap[i]
            gap[i] = 0

    def _spec_propose(self, st, dec, win):
        """The draft's micro-steps of one speculative tick: each slot
        first feeds what its draft KV lacks (at most the last emitted
        token once caught up; those rows do not sample, so their
        generators do not advance), then samples ``win[i]`` proposals,
        each fed back on the device as the next micro-step's token.
        Returns ``(prop_toks (n, K), prop_q (n, K, vocab))`` on the
        device; no value crosses to the host between micro-steps.  Rows
        past a slot's window hold clamped leftovers that the verify's
        ``valid`` masks."""
        draft = st.draft
        n = len(st.slots)
        K = st.spec_k
        dev = draft.device
        gap = {i: int(st.lengths[i]) - int(st.dlen[i]) for i in dec}
        if max(gap.values()) > 1:
            self._spec_catch_up(st, dec, gap)
        steps = {i: gap[i] + win[i] for i in dec}
        tok_rows, q_rows = [], []
        prev = None
        for t in range(max(steps.values())):
            tables = np.zeros((n, st.tb), np.int32)
            toks = np.zeros((n,), np.int32)
            fed_back = np.zeros((n,), bool)
            pos = np.zeros((n,), np.int32)
            do = np.zeros((n,), bool)
            live = 0
            for i in dec:
                if t >= steps[i]:
                    continue
                idx = int(st.dlen[i]) + t     # the position fed this step
                if t <= gap[i]:
                    # history: up to the last emitted token, at position
                    # lengths[i], which the target's KV lacks as well
                    toks[i] = self._history(st.slots[i], idx)
                else:
                    fed_back[i] = True        # the previous proposal
                tables[i] = st.tables[i]
                pos[i] = idx
                do[i] = t >= gap[i]
                live += 1
            toks_in = torch.as_tensor(toks, device=dev)
            if fed_back.any():
                toks_in = torch.where(torch.as_tensor(fed_back, device=dev),
                                      prev, toks_in)
            out = draft.run_paged_step_sample_p(
                st.dpool_k, st.dpool_v, tables, toks_in[:, None], pos,
                np.ones((n,), np.int32), st.dgens, st.temps, st.top_ks, do,
                scales=st.dscales)
            prev, q = out[:2]
            tok_rows.append(prev)
            q_rows.append(q)
            self._inc("spec_draft_steps", live)
        for i in dec:
            st.dlen[i] += steps[i]        # draft frontier = lengths + win
        if not q_rows:
            return (torch.zeros((n, K), dtype=torch.int32, device=dev),
                    torch.zeros((n, K, draft.spec["vocab_size"]),
                                device=dev))
        # slot i's proposals are micro-steps gap[i] .. gap[i] + win[i] - 1
        g = np.zeros((n,), np.int64)
        for i in dec:
            g[i] = gap[i]
        idx = torch.as_tensor(np.minimum(g[:, None] + np.arange(K)[None, :],
                                         len(q_rows) - 1), device=dev)
        rows = torch.arange(n, device=dev)[:, None]
        return (torch.stack(tok_rows, dim=1)[rows, idx],
                torch.stack(q_rows, dim=1)[rows, idx])

    def _spec_step(self, model, st, dec):
        """One speculative decode tick: the draft proposes up to
        ``spec_k`` tokens a generating slot, the target verifies all K+1
        positions in one paged step with the accept/reject rule on the
        device, and each slot emits 1..K+1 tokens.  One blocking fetch:
        the emitted tokens with their counts.  Rejected proposals roll
        back by the frontier alone: ``lengths`` stops at the emitted
        count, and the rows written past it are never read before a
        later step rewrites them."""
        K = st.spec_k
        win = {}
        for i in dec:
            r = st.slots[i]
            # never propose past the budget: a verify emits at most the
            # window and the bonus token
            win[i] = max(0, min(K, r.max_tokens - len(r.tokens) - 1))
            L = int(st.lengths[i])
            # the verify writes positions L..L+win: allocate or fork
            # first, since the draft's micro-steps write the same blocks
            self._write_ready(st, i, list(range(L, L + win[i] + 1)))
        n = len(st.slots)
        try:
            prop_toks, prop_q = self._spec_propose(st, dec, win)
            tables = np.zeros((n, st.tb), np.int32)
            first = np.zeros((n, 1), np.int32)
            pos = np.zeros((n,), np.int32)
            val = np.ones((n,), np.int32)
            do = np.zeros((n,), bool)
            for i in dec:
                tables[i] = st.tables[i]
                first[i, 0] = st.next_tok[i]
                pos[i] = st.lengths[i]
                val[i] = win[i] + 1
                do[i] = True
            vtoks = torch.cat([torch.as_tensor(first, device=prop_toks.device),
                               prop_toks], dim=1)
            out = st.store.run_paged_verify(
                st.pool_k, st.pool_v, tables, vtoks, pos, val, prop_q,
                st.gens, st.temps, st.top_ks, do, scales=st.scales)
            out_dev, ne_dev, st.pool_k, st.pool_v = out[:4]
            if st.scales is not None:
                st.scales = out[4:]
            fetched = torch.cat([out_dev, ne_dev[:, None]],
                                dim=1).cpu().numpy()
        except Exception as e:  # noqa: BLE001 — forwarded to the futures
            self._fail_rows(st, dec, e, "speculative")
            return
        emitted = proposed = accepted = 0
        for i in dec:
            r = st.slots[i]
            ne = int(fetched[i, -1])
            proposed += win[i]
            accepted += ne - 1
            for j in range(ne):
                tok = int(fetched[i, j])
                self._push_token(r, tok)
                st.lengths[i] += 1
                emitted += 1
                st.next_tok[i] = tok
                reason = self._finished_reason(r, tok)
                if reason:
                    # EOS mid-window: the rest of the window goes with
                    # the slot
                    self._release_slot(st, i)
                    self._finish(r, reason)
                    break
            else:
                # the draft's KV holds only what matches the accepted
                # stream: clamp it to the new frontier (a full accept
                # leaves a one-token gap, the bonus token)
                st.dlen[i] = min(int(st.dlen[i]), int(st.lengths[i]))
        self._inc("decode_steps")
        self._inc("spec_steps")
        self._inc("spec_proposed", proposed)
        self._inc("spec_accepted", accepted)
        self._inc("generated_tokens", emitted)
        if proposed:
            st.spec_ema = (_SPEC_EMA_DECAY * st.spec_ema +
                           (1.0 - _SPEC_EMA_DECAY) * accepted / proposed)

    # -- retirement ----------------------------------------------------
    @staticmethod
    def _finished_reason(req, tok):
        if req.eos_id is not None and tok == req.eos_id:
            return "eos"
        if len(req.tokens) >= req.max_tokens:
            return "length"
        return None

    def _push_token(self, req, tok):
        req.tokens.append(tok)
        req.token_times.append(time.perf_counter())
        if req.stream is not None:
            req.stream.push(tok)

    def _finish(self, req, reason):
        if req.stream is not None:
            req.stream.close()
        res = GenerationResult(req.model, len(req.prompt),
                               list(req.tokens), reason, req.t_submit,
                               list(req.token_times))
        self._completer.resolve(req.future, res)
        self._inc("finished")

    def _fail_request(self, req, exc, kind="errors", running=False):
        if not running and not req.future.set_running_or_notify_cancel():
            self._inc("cancelled")
            return
        if req.stream is not None:
            req.stream.close()
        self._completer.resolve(req.future, exc=exc)
        self._inc(kind)

    def _fail_all(self):
        """Everything waiting or in flight fails fast."""
        exc = ServeClosed("generation engine closed before completion")
        for dq in self._waiting.values():
            while dq:
                self._fail_request(dq.popleft(), exc)
        self._waiting.clear()
        for st in list(self._states.values()):
            for i in st.active():
                r = st.slots[i]
                if st.paged:
                    self._release_slot(st, i)
                else:
                    self._clear_slot(st, i)
                self._fail_request(r, exc, running=True)
            st.store.cache_state = None
        self._states.clear()
