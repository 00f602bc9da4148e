"""Overlapped input staging: batch t+1 is copied to the device while
step t computes (counterpart of ``mxnet_tpu/io/stager.py``).

A producer thread pulls batches from the source iterator and places
each data and label array on the consumer's device, parking the placed
batches in a bounded queue (``MXNET_IO_STAGE_DEPTH`` slots, the double
buffer).  On a CUDA device a host array is first copied into pinned
memory (``cpu_pinned()``), then to the device on a side
``torch.cuda.Stream`` with ``non_blocking=True``; the consumer's stream
waits on that copy's event before the step reads the batch.

Every staged batch gets fresh device memory.  The reference relies on
jax arrays being immutable; a torch tensor is not, so the consumer also
calls ``record_stream`` on each staged tensor: the caching allocator
then keeps the memory from another batch until the work the consumer's
stream queued on it has run.

An array already on the target device (``SyntheticDataIter``'s fixed
batch) passes unchanged, as ``DataParallelTrainer._shard_batch`` takes
it.  On a device target the stager reads an epoch's first batch itself:
when every data and label array of it is already on the device, the
epoch's batches pass straight through, with no thread, queue or event
(nothing is left to overlap).  On a CPU target the same thread and
queue run, without streams.
``MXNET_IO_STAGE=0`` leaves ``Module.fit`` feeding the source
iterator's batches to the step as they are.  Values never change:
staging moves where the copy happens, not what it copies.
"""
from __future__ import annotations

import copy
import queue
import threading

import torch

from ..base import MXNetError, get_env
from ..context import cpu, cpu_pinned
from ..ndarray import NDArray, array

__all__ = ["DeviceStager", "staging_enabled", "put_interruptible"]

_EOF = object()


def staging_enabled():
    """Is overlapped input staging on (``MXNET_IO_STAGE``)?"""
    return bool(get_env("MXNET_IO_STAGE"))


def put_interruptible(q, stop, item, timeout=0.1):
    """A bounded ``q.put`` that a halt always wins against: it blocks in
    short slices and checks ``stop`` between them.  Returns False once
    stopped (the item is dropped; the halting side owns the queue)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=timeout)
            return True
        except queue.Full:
            continue
    return False


class DeviceStager:
    """An iterator over ``source``'s batches with their data and label
    arrays on ``device`` (a ``torch.device``).

    ``depth`` bounds the batches staged ahead of the consumer; it
    defaults to ``MXNET_IO_STAGE_DEPTH`` (below 1 counts as 1).
    ``provide_data``, ``provide_label``, ``batch_size`` and the rest of
    the source's attributes pass through."""

    def __init__(self, source, device, depth=None):
        self._source = source
        self._device = torch.device(device)
        if self._device.type == "cuda" and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        if depth is None:
            depth = int(get_env("MXNET_IO_STAGE_DEPTH"))
        self._depth = max(1, depth)
        self._cuda = self._device.type == "cuda"
        self._stream = None
        self._queue = None
        self._producer = None
        self._stop = threading.Event()
        self._exhausted = False
        self._passthrough = False
        self._src = None

    # -- producer -------------------------------------------------------
    def _start(self, src, first):
        # each producer has its own stop event and queue: one stuck in
        # the source must never feed (or restart) the next epoch's run
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self._depth)
        if self._cuda and self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
        self._producer = threading.Thread(
            target=self._produce, args=(self._queue, self._stop, src, first),
            name="mxt-stage", daemon=True)
        self._producer.start()

    def _produce(self, q, stop, src, batch):
        """Stage ``batch`` (None: none read yet), then the rest of
        ``src``."""
        try:
            while not stop.is_set():
                if batch is None:
                    try:
                        batch = next(src)
                    except StopIteration:
                        put_interruptible(q, stop, (_EOF, None, ()))
                        return
                put_interruptible(q, stop, self._stage_batch(batch))
                batch = None
        except BaseException as e:  # handed to the consumer, raised there
            put_interruptible(q, stop, (e, None, ()))

    def _on_device(self, batch):
        """Is every data and label array of ``batch`` on the target?"""
        for arr in list(batch.data or []) + list(batch.label or []):
            t = self._source_tensor(arr)
            if t is None or t.device != self._device:
                return False
        return True

    def _stage_batch(self, batch):
        """``(staged, event, copied)``: a shallow copy of ``batch`` with
        its data and label arrays on the device (``pad``, ``index``,
        ``bucket_key`` and ``provide_*`` ride along), the side stream's
        event after the copies (None on a CPU target) and the tensors
        copied there."""
        staged = copy.copy(batch)
        if not self._cuda:
            staged.data = [self._place_host(a) for a in batch.data or []]
            staged.label = [self._place_host(a) for a in batch.label or []]
            return staged, None, ()
        copied = []
        with torch.cuda.stream(self._stream):
            staged.data = [self._place_cuda(a, copied)
                           for a in batch.data or []]
            staged.label = [self._place_cuda(a, copied)
                            for a in batch.label or []]
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event, copied

    @staticmethod
    def _source_tensor(arr):
        if isinstance(arr, NDArray):
            return arr._data
        if isinstance(arr, torch.Tensor):
            return arr
        return None

    def _place_host(self, arr):
        t = self._source_tensor(arr)
        if t is not None and t.device == self._device:
            return arr if isinstance(arr, NDArray) else NDArray(t)
        return array(arr if t is None else t, ctx=cpu())

    def _place_cuda(self, arr, copied):
        t = self._source_tensor(arr)
        if t is not None and t.device == self._device:
            return arr if isinstance(arr, NDArray) else NDArray(t)
        # numpy float64 narrows to float32 and int64 to int32, as
        # nd.array does on the blocking path
        host = array(arr if t is None else t.detach().cpu(),
                     ctx=cpu_pinned())._data
        copied.append(host.to(self._device, non_blocking=True))
        return NDArray(copied[-1])

    # -- consumer -------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        if self._passthrough:
            return self._next_unstaged()
        if self._producer is None:
            # staging starts at the first read, so a reset at an epoch's
            # end never draws an epoch that is not going to run
            self._src = iter(self._source)
            first = None
            if self._device.type != "cpu":
                first = self._next_unstaged()
                if self._on_device(first):
                    self._passthrough = True
                    return first
            self._start(self._src, first)
        batch, event, copied = self._queue.get()
        if batch is _EOF:
            # the source is at its end until reset(); a producer started
            # again now would draw the next epoch unasked
            self._exhausted = True
            raise StopIteration
        if isinstance(batch, BaseException):
            raise MXNetError("input staging worker failed: %r"
                             % (batch,)) from batch
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for t in copied:
                t.record_stream(consumer)
        return batch

    next = __next__

    def _next_unstaged(self):
        try:
            return next(self._src)
        except StopIteration:
            self._exhausted = True
            raise

    def reset(self):
        """Stop staging and rewind the source (a new epoch; the producer
        starts again at the next read, or the epoch passes through).
        Batches staged past the consumer are dropped."""
        self._halt()
        self._exhausted = False
        self._passthrough = False
        self._source.reset()

    def close(self):
        """Stop the producer for good."""
        self._halt()

    def _halt(self):
        if self._producer is None:
            return
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._producer.join(timeout=30)
        if self._producer.is_alive():
            # resetting the source now would race its cursor from two
            # threads and lose the next epoch's first batch
            raise MXNetError(
                "input staging producer stuck in the source iterator for "
                "more than 30 s; cannot reset or close the stager")
        self._producer = None

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._source, name)

    def __del__(self):
        try:
            self.close()
        except MXNetError:
            pass
