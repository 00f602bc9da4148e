"""Continuous batching for the forward serving plane, the serving
exceptions and the future-resolution thread (counterpart of
``mxnet_tpu/serving/scheduler.py``).

One engine thread drains a request queue into dispatches:

* the queue head opens a batch and starts its latency budget
  (``MXNET_SERVE_MAX_DELAY_MS``, measured from the head's submit time);
* while the budget lasts, later requests of the same model and tier
  join until the batch reaches ``MXNET_SERVE_MAX_BATCH`` rows or the
  model's largest bucket; other requests park in a pending deque, and a
  parked request of the batch's own stream blocks every younger one
  (per-model FIFO, no overtaking);
* the batch's inputs are concatenated, run through the model's
  :class:`~.program_store.ProgramStore` bucket, and each request's
  future resolves with views of its rows of the batch's outputs
  (device tensors: clients fetch on their own threads).  The dispatch
  only enqueues device work.

Requests carry optional deadlines (``timeout=``, 0 = already due:
:class:`ServeTimeout`), ``Future.cancel()`` is honoured at batch forming,
``max_inflight`` sheds with :class:`ServeOverloaded`, the ``latency``
tier preempts the ``batch`` tier, and per-tenant row quotas shed the
tenant over its quota alone.  ``close()`` drains; ``close(drain=False)``
fails what is queued with :class:`ServeClosed`.

Unlike the reference, whose compiled programs serve from any thread, the
engine's constructor returns once its thread has run every registered
forward model's buckets (PyTorch keeps cuDNN's execution plans per
thread).

Left out, as the port's generation engine leaves them out: the
reference's metrics histograms and counters, tracing spans,
``profiler.record_phase`` spans and race-check containers (telemetry is
ROADMAP Queue 1 item 8).  ``stats()`` reads a plain counter dict kept
under a lock.
"""
from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np

from ..base import MXNetError, get_env

__all__ = ["ServingEngine", "ServeRequest", "ServeTimeout", "ServeClosed",
           "ServeOverloaded", "FutureCompleter", "TIERS"]

log = logging.getLogger(__name__)

_STOP = object()


class FutureCompleter:
    """Future resolution on a dedicated daemon thread.

    ``set_result`` runs client done-callbacks and wakes every thread
    blocked in ``Future.result()``; each wake can cost the resolving
    thread a GIL handoff, so the engine loop only enqueues (future,
    result, exception) triples here."""

    def __init__(self, name="mxtt-serve-done"):
        self._q = queue.Queue()
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    def resolve(self, fut, result=None, exc=None):
        self._q.put((fut, result, exc))

    def _loop(self):
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            fut, result, exc = item
            try:
                if exc is not None:
                    fut.set_exception(exc)
                else:
                    fut.set_result(result)
            except InvalidStateError:
                # a client cancel() won the race: drop the resolution
                pass

    def close(self, timeout=60.0):
        """Stop after everything already enqueued has resolved."""
        self._q.put(_STOP)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise MXNetError("serving completer thread failed to stop "
                             "within %.0fs" % timeout)


class ServeTimeout(MXNetError):
    """The request's deadline expired while it waited for admission."""


class ServeClosed(MXNetError):
    """The engine is shut down (or shutting down without drain)."""


class ServeOverloaded(MXNetError):
    """Admission control shed the request (inflight budget full, a
    tenant over its row quota, or a request too large for the KV pool);
    clients should back off."""


# Admission priority tiers, highest first: "latency" requests are served
# before any "batch" request at batch forming; FIFO holds within a
# (model, tier) stream, never across tiers.
TIERS = ("latency", "batch")

_COUNTERS = ("requests", "batches", "rows", "padded_rows", "timeouts",
             "cancelled", "errors", "shed")


class ServeRequest:
    """One queued inference request (internal; clients hold the
    Future)."""

    __slots__ = ("model", "inputs", "n", "future", "deadline", "t_submit",
                 "priority", "tenant")

    def __init__(self, model, inputs, n, future, deadline, t_submit,
                 priority="batch", tenant=None):
        self.model = model
        self.inputs = inputs      # dict name -> np.ndarray (canonical)
        self.n = n                # rows
        self.future = future
        self.deadline = deadline  # monotonic seconds, or None
        self.t_submit = t_submit
        self.priority = priority  # one of TIERS
        self.tenant = tenant      # quota key, or None


class ServingEngine:
    """Continuous batcher over a :class:`~.registry.ModelRegistry`'s
    forward models.

    ``submit(model, timeout=None, priority=None, tenant=None, **inputs)``
    returns a ``concurrent.futures.Future`` that resolves to the list of
    the model's outputs for exactly the submitted rows: tensors on the
    store's device, views of the batch's outputs (fetch them on the
    caller's thread).  One engine serves every forward model of the
    registry; a batch never mixes models or tiers.
    ``tenant_quotas={tenant: rows}`` caps each tenant's accepted but
    unresolved rows.
    """

    def __init__(self, registry, max_delay_ms=None, max_batch=None,
                 max_inflight=None, tenant_quotas=None):
        self._registry = registry
        self._tenant_quotas = dict(tenant_quotas or {})
        self._tenant_rows = {}
        if max_delay_ms is None:
            max_delay_ms = float(get_env("MXNET_SERVE_MAX_DELAY_MS"))
        self._max_delay = max(0.0, float(max_delay_ms)) / 1e3
        if max_batch is None:
            max_batch = int(get_env("MXNET_SERVE_MAX_BATCH"))
        self._max_batch = max(1, int(max_batch))
        if max_inflight is None:
            max_inflight = int(get_env("MXNET_SERVE_MAX_INFLIGHT"))
        self._max_inflight = max(0, int(max_inflight))  # 0 = unbounded
        self._inflight = 0
        self._queue = queue.Queue()
        self._pending = collections.deque()
        self._closed = False
        self._drain_on_stop = True
        self._inflight_reqs = ()
        self._submit_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats = dict.fromkeys(_COUNTERS, 0)
        self._max_rows = 0
        # test seam: called with (model, live requests) right before
        # each dispatch
        self._dispatch_hook = None
        self._completer = FutureCompleter("mxtt-serve-fwd-done")
        warmed = threading.Event()
        self._thread = threading.Thread(target=self._serve_loop,
                                        args=(warmed,), name="mxtt-serve-fwd",
                                        daemon=True)
        self._thread.start()
        warmed.wait()

    def _count(self, key, n=1):
        with self._stats_lock:
            self._stats[key] += n

    # -- client side ---------------------------------------------------
    def submit(self, model, timeout=None, priority=None, tenant=None,
               **inputs):
        """Enqueue one request; returns its Future.

        ``timeout`` (seconds) bounds the time in queue: an expired
        request fails with :class:`ServeTimeout` instead of running.
        Inputs are validated and canonicalized here, on the caller's
        thread.  With an inflight budget (``max_inflight`` /
        ``MXNET_SERVE_MAX_INFLIGHT``) a submit past it is shed with
        :class:`ServeOverloaded`, as is one that would take its
        ``tenant`` past its quota.  ``priority`` is ``"latency"`` or
        ``"batch"`` (the default)."""
        with self._submit_lock:
            if self._closed:
                raise ServeClosed("serving engine is closed")
        priority = "batch" if priority is None else str(priority)
        if priority not in TIERS:
            raise MXNetError("unknown priority tier %r (want one of %s)"
                             % (priority, "/".join(TIERS)))
        tenant = None if tenant is None else str(tenant)
        store = self._registry.store(model)
        canon, n = store.canon_inputs(inputs)
        fut = Future()
        now = time.monotonic()
        req = ServeRequest(model, canon, n, fut,
                           now + timeout if timeout is not None else None,
                           now, priority=priority, tenant=tenant)
        with self._submit_lock:
            if self._closed:
                raise ServeClosed("serving engine is closed")
            if self._max_inflight and self._inflight >= self._max_inflight:
                self._count("shed")
                raise ServeOverloaded(
                    "serving engine is at its inflight budget (%d); "
                    "request shed — back off and retry"
                    % self._max_inflight)
            quota = self._tenant_quotas.get(tenant) \
                if tenant is not None else None
            if quota is not None \
                    and self._tenant_rows.get(tenant, 0) + n > quota:
                self._count("shed")
                raise ServeOverloaded(
                    "tenant %r is over its inflight row quota (%d); "
                    "request shed — back off and retry" % (tenant, quota))
            self._inflight += 1
            if tenant is not None:
                self._tenant_rows[tenant] = \
                    self._tenant_rows.get(tenant, 0) + n
            self._queue.put(req)
        # exactly one resolution per accepted request (result, error or
        # cancel) ends its inflight accounting
        fut.add_done_callback(
            lambda f, t=tenant, rows=n: self._note_resolved(t, rows))
        self._count("requests")
        return fut

    def _note_resolved(self, tenant, rows):
        with self._submit_lock:
            self._inflight -= 1
            if tenant is not None:
                left = self._tenant_rows.get(tenant, 0) - rows
                if left > 0:
                    self._tenant_rows[tenant] = left
                else:
                    self._tenant_rows.pop(tenant, None)

    def alive(self):
        """The dispatch loop is running and accepting submits."""
        with self._submit_lock:
            closed = self._closed
        return not closed and self._thread.is_alive()

    def stats(self):
        """The engine's counters (``requests``, ``batches``, ``rows``,
        ``padded_rows``, ``timeouts``, ``cancelled``, ``errors``,
        ``shed``), ``max_rows_in_batch``, the inflight accounting, each
        model's store stats and the resident weight bytes of all models
        by dtype."""
        with self._stats_lock:
            out = dict(self._stats)
            out["max_rows_in_batch"] = self._max_rows
        with self._submit_lock:
            out["inflight"] = self._inflight
            out["tenant_rows"] = dict(self._tenant_rows)
        out["max_inflight"] = self._max_inflight
        out["tenant_quotas"] = dict(self._tenant_quotas)
        out["models"] = self._registry.stats()
        rollup = {}
        for m in out["models"].values():
            for dt, n in m.get("weight_bytes", {}).get(
                    "by_dtype", {}).items():
                rollup[dt] = rollup.get(dt, 0) + n
        out["weight_bytes_by_dtype"] = rollup
        return out

    def close(self, drain=True, timeout=60.0):
        """Stop the engine.  ``drain=True`` (default) completes every
        request already submitted before the thread exits;
        ``drain=False`` fails queued requests with :class:`ServeClosed`.
        Idempotent; joins the engine thread."""
        with self._submit_lock:
            if not self._closed:
                self._closed = True
                self._drain_on_stop = bool(drain)
                self._queue.put(_STOP)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise MXNetError("serving engine thread failed to stop "
                             "within %.0fs" % timeout)
        self._completer.close(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _resolve(self, fut, result=None, exc=None):
        self._completer.resolve(fut, result, exc)

    # -- engine thread -------------------------------------------------
    def _warm_on_thread(self):
        """Run every registered forward model's buckets once on the
        engine thread before serving (the constructor waits for it).
        PyTorch keeps cuDNN's execution plans per thread, so buckets
        warmed only on the registering thread rebuild them inside the
        engine's first served batches
        (for ResNet-50 several times a warm batch's time:
        ``chip_smoke.py`` phase 25 measures it).  A model registered
        after the engine started is not warmed here."""
        for name in self._registry.models():
            try:
                store = self._registry.store(name)
            except MXNetError:      # a generative model
                continue
            try:
                store.warmup()
            except Exception:  # noqa: BLE001 — its requests will fail
                log.exception("serving engine: warming model %r on the "
                              "engine thread failed", name)

    def _serve_loop(self, warmed):
        try:
            try:
                self._warm_on_thread()
            finally:
                warmed.set()
            while self._dispatch_once():
                pass
        finally:
            # normal exit or a crashed cycle: latch closed first (later
            # submits raise ServeClosed), then fail whatever is left
            with self._submit_lock:
                self._closed = True
            self._fail_remaining()

    def _fail_remaining(self):
        """Resolve everything still in flight, parked or queued with
        ServeClosed: nothing will ever dispatch it."""
        inflight = self._inflight_reqs
        self._inflight_reqs = ()
        msg = ("serving engine dispatch loop exited before this request "
               "could be served")
        for r in inflight:
            # resolving an already-served request again is harmless: the
            # completer drops the second resolution
            self._resolve(r.future, exc=ServeClosed(msg))
        while True:
            if self._pending:
                head = self._pending.popleft()
            else:
                try:
                    head = self._queue.get_nowait()
                except queue.Empty:
                    return
            if head is not _STOP:
                self._resolve(head.future, exc=ServeClosed(msg))

    def _dispatch_once(self):
        """One cycle: wait for a head request, form its batch within its
        latency budget, dispatch it.  False when the engine should exit
        (after draining)."""
        head = self._take()
        if head is _STOP:
            self._shutdown()
            return False
        self._inflight_reqs = (head,)
        if self._failfast():
            self._resolve(head.future, exc=ServeClosed(
                "serving engine closed before dispatch"))
            self._inflight_reqs = ()
            return True
        reqs, rows, stop = self._collect(head)
        self._inflight_reqs = tuple(reqs)
        if self._failfast():
            for r in reqs:
                self._resolve(r.future, exc=ServeClosed(
                    "serving engine closed before dispatch"))
        else:
            self._dispatch_batch(head.model, reqs, rows)
        self._inflight_reqs = ()
        if stop:
            self._shutdown()
            return False
        return True

    def _take(self):
        """The next head, latency tier first: new arrivals are drained
        behind the parked ones (arrival order kept), then the oldest
        latency-tier request goes before any batch-tier one.  With no
        backlog, block on the queue (``close()`` wakes it with the stop
        sentinel)."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                # nothing can be submitted after close() latched, so the
                # sentinel stays last and the backlog is served first
                self._queue.put(item)
                break
            self._pending.append(item)
        for i, r in enumerate(self._pending):
            if r.priority == TIERS[0]:
                del self._pending[i]
                return r
        if self._pending:
            return self._pending.popleft()
        return self._queue.get()

    def _cap(self, head):
        """The head's batch cap, or None (its future failed) when its
        model is gone."""
        try:
            return min(self._max_batch,
                       self._registry.store(head.model).max_bucket())
        except MXNetError as e:  # model removed after submit
            self._resolve(head.future, exc=e)
            return None

    def _take_parked(self, reqs, rows, cap, stream):
        """Move the parked requests of ``stream`` that fit into the batch,
        in order, until one does not: nothing younger of the stream may
        join past it.  Returns ``(rows, blocked)``."""
        keep = collections.deque()
        blocked = False
        while self._pending:
            r = self._pending.popleft()
            if (r.model, r.priority) == stream and not blocked \
                    and rows + r.n <= cap:
                reqs.append(r)
                rows += r.n
            else:
                keep.append(r)
                if (r.model, r.priority) == stream:
                    blocked = True
        self._pending = keep
        return rows, blocked

    def _collect(self, head):
        """Grow ``head``'s batch within its latency budget.  Returns
        ``(reqs, rows, stop_seen)``."""
        cap = self._cap(head)
        if cap is None:
            return [], 0, False
        reqs, stream = [head], (head.model, head.priority)
        rows, blocked = self._take_parked(reqs, head.n, cap, stream)
        if blocked:
            # any same-stream arrival is younger than the parked one:
            # waiting could only add overtakers, so flush now
            return reqs, rows, False
        deadline = head.t_submit + self._max_delay
        stop = False
        while rows < cap:
            # the budget bounds waiting, never taking: a backlog still
            # fills the bucket through non-blocking gets
            remaining = deadline - time.monotonic()
            try:
                item = self._queue.get(timeout=remaining) \
                    if remaining > 0 else self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                stop = True
                break
            if (item.model, item.priority) == stream \
                    and rows + item.n <= cap:
                reqs.append(item)
                rows += item.n
            else:
                self._pending.append(item)
                if (item.model, item.priority) == stream:
                    break  # same stream but over the cap: flush now
        return reqs, rows, stop

    def _dispatch_batch(self, model, reqs, rows):
        """Concatenate the live requests' inputs, run the bucket, and
        resolve each future with views of its rows.  Enqueue-only: no
        host sync on this thread."""
        if not reqs:
            return
        now = time.monotonic()
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                self._resolve(r.future, exc=ServeTimeout(
                    "request for %r timed out after %.1f ms in queue"
                    % (r.model, (now - r.t_submit) * 1e3)))
                self._count("timeouts")
            elif r.future.set_running_or_notify_cancel():
                live.append(r)
            else:
                self._count("cancelled")
        if not live:
            return
        if self._dispatch_hook is not None:
            self._dispatch_hook(model, live)
        rows = sum(r.n for r in live)
        if len(live) == 1:
            inputs = live[0].inputs
        else:
            inputs = {k: np.concatenate([r.inputs[k] for r in live])
                      for k in live[0].inputs}
        try:
            store = self._registry.store(model)
            outs, bucket, batch_major = store.run(inputs, n=rows,
                                                  slice_outputs=False)
        except Exception as e:  # noqa: BLE001 — to the futures
            exc = e if isinstance(e, MXNetError) \
                else MXNetError("serving dispatch failed: %r" % (e,))
            for r in live:
                self._resolve(r.future, exc=exc)
            self._count("errors", len(live))
            return
        ofs = 0
        for r in live:
            self._resolve(r.future, [
                o.narrow(0, ofs, r.n) if bm and r.n != bucket else o
                for o, bm in zip(outs, batch_major)])
            ofs += r.n
        with self._stats_lock:
            self._stats["batches"] += 1
            self._stats["rows"] += rows
            self._stats["padded_rows"] += bucket - rows
            self._max_rows = max(self._max_rows, rows)

    def _failfast(self):
        """``close(drain=False)`` landed?"""
        with self._submit_lock:
            return self._closed and not self._drain_on_stop

    def _shutdown(self):
        """Drain everything already submitted (or fail it under
        ``close(drain=False)``), then let the loop exit."""
        with self._submit_lock:
            drain = self._drain_on_stop
        while True:
            if self._pending:
                head = self._pending.popleft()
            else:
                try:
                    head = self._queue.get_nowait()
                except queue.Empty:
                    return
            if head is _STOP:
                continue
            if not drain:
                self._resolve(head.future, exc=ServeClosed(
                    "serving engine closed before dispatch"))
                continue
            self._inflight_reqs = (head,)
            reqs, rows = self._collect_ready(head)
            self._inflight_reqs = tuple(reqs)
            self._dispatch_batch(head.model, reqs, rows)
            self._inflight_reqs = ()

    def _collect_ready(self, head):
        """Shutdown-time batch forming: the same stream discipline, over
        requests already queued only (no waiting)."""
        cap = self._cap(head)
        if cap is None:
            return [], 0
        reqs, stream = [head], (head.model, head.priority)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                self._pending.append(item)
        rows, _ = self._take_parked(reqs, head.n, cap, stream)
        return reqs, rows
