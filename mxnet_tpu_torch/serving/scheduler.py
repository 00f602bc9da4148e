"""Serving exceptions and the future-resolution thread (copies of the
pieces of ``mxnet_tpu/serving/scheduler.py`` that the generation engine
uses)."""
from __future__ import annotations

import queue
import threading
from concurrent.futures import InvalidStateError

from ..base import MXNetError

__all__ = ["ServeTimeout", "ServeClosed", "ServeOverloaded",
           "FutureCompleter"]

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
    """Admission control shed the request (inflight budget full, or a
    request too large for the KV pool); clients should back off."""
