"""Autoregressive generation engine on the paged KV plane, in PyTorch.

Counterpart of the paged plane of ``mxnet_tpu/serving/decode_engine.py``
(continuous batching without metrics, tracing, priority tiers, tenant
quotas or speculative decoding).  One daemon engine thread owns the
loop:

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

The KV pool is one global pair of tensors on the model's device,
``(layers, heads, pool_blocks * kv_block, head_dim)``, updated in place.
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
from .scheduler import (FutureCompleter, ServeClosed, ServeOverloaded,
                        ServeTimeout)

__all__ = ["GenerationEngine", "GenerationResult", "TokenStream"]

log = logging.getLogger(__name__)

_STOP = object()

_COUNTERS = ("requests", "prefills", "prefill_seqs", "decode_steps",
             "generated_tokens", "finished", "timeouts", "cancelled",
             "errors", "shed", "slot_grows", "prefix_hits",
             "prefix_hit_blocks", "prefix_hit_tokens", "cow_forks",
             "prefill_chunks", "shed_pool")


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


class _PagedModelState:
    """Live paged decode batch of one model: slot table, per-slot block
    tables over the global KV pool, per-slot sampling state and the
    prefix cache.  It persists across batch drains (the prefix cache's
    pinned blocks are the point of keeping it)."""

    def __init__(self, store):
        self.store = store
        self.pool = _BlockPool(store.pool_blocks)
        self.prefix = _PrefixStore(self.pool, store.kv_block)
        self.pool_k, self.pool_v = store.new_pool()
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
        pool_bytes = 2 * self.pool_k.numel() * self.pool_k.element_size()
        per_block = pool_bytes // self.store.pool_blocks
        return {"slots": len(self.slots), "active": len(self.active()),
                "paged": True,
                "block_size": self.store.kv_block,
                "prefill_chunk": self.store.prefill_chunk,
                "pool_blocks": self.pool.capacity(),
                "pool_blocks_used": self.pool.used(),
                "pool_blocks_hwm": self.pool.hwm,
                "pool_blocks_shared": self.pool.shared(),
                "pool_blocks_reserved": self.reserved_total(),
                "prefix_entries": len(self.prefix),
                "pool_bytes": pool_bytes,
                "block_bytes": per_block,
                "cache_dtype": str(self.pool_k.dtype)}


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
        ``shed_pool``, ...) plus per-model pool state."""
        with self._stats_lock:
            out = dict(self._stats)
            out["max_active"] = self._max_active_seen
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
                    self._admit_paged(model, dq, store)
            if not self._waiting.get(model):
                self._waiting.pop(model, None)

    def _paged_state(self, model, store):
        st = self._states.get(model)
        if st is None:
            st = self._states[model] = _PagedModelState(store)
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
                self._grow_slots(st, store.batch_bucket(
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
            st.gens[slot] = None
            if r.temperature > 0:
                g = torch.Generator(device=store.device)
                g.manual_seed(r.seed & 0xFFFFFFFFFFFFFFFF)
                st.gens[slot] = g
            admitted += 1
        if admitted:
            self._inc("prefill_seqs", admitted)
            with self._stats_lock:
                self._max_active_seen = max(self._max_active_seen,
                                            len(st.active()))

    def _grow_slots(self, st, new_bb):
        grow = new_bb - len(st.slots)
        st.slots.extend([None] * grow)
        st.gens.extend([None] * grow)
        st.tables = np.concatenate(
            [st.tables, np.zeros((grow, st.tb), np.int32)])
        for name in ("lengths", "prog", "chunks_done", "next_tok",
                     "top_ks", "resv", "temps", "decoding"):
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

    # -- ticks ---------------------------------------------------------
    def _decode_tick(self):
        for model, st in list(self._states.items()):
            dec = [i for i in st.active() if st.decoding[i]]
            if dec:
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
                st.store.copy_block(st.pool_k, st.pool_v, b, nb)
                st.pool.deref(b)
                st.tables[i, j] = nb
                st.resv[i] = max(0, int(st.resv[i]) - 1)
                self._inc("cow_forks")

    def _dispatch(self, st, tables, toks, pos, val, do):
        """One paged step (decode or prompt chunk) with sampling on the
        device; returns the sampled tokens as a host array."""
        toks_dev, st.pool_k, st.pool_v = st.store.run_paged_step_sample(
            st.pool_k, st.pool_v, tables, toks, pos, val, st.gens,
            st.temps, st.top_ks, do)
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
        try:
            sampled = self._dispatch(st, tables, toks, pos, val, do)
        except Exception as e:  # noqa: BLE001 — forwarded to the futures
            self._fail_rows(st, [i for i, _r, _p, _n in rows], e,
                            "prefill")
            return
        self._inc("prefills")
        self._inc("prefill_chunks", len(rows))
        for i, r, p0, ntok in rows:
            st.prog[i] = p0 + ntok
            st.lengths[i] = p0 + ntok
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
                self._release_slot(st, i)
                self._fail_request(r, exc, running=True)
            st.store.cache_state = None
        self._states.clear()
