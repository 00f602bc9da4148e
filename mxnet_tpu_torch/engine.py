"""Execution engine facade of the port (counterpart of
``mxnet_tpu/engine.py``).

PyTorch already launches device work asynchronously on the current
CUDA stream and orders it by the stream, which is what the reference's
dependency engine provided.  What survives is the engine's control
surface:

* the dispatch seam every imperative op goes through
  (:meth:`Engine.dispatch`);
* ``NaiveEngine`` mode (``MXNET_ENGINE_TYPE=NaiveEngine``): the device
  is synchronised after every op, so an asynchronous CUDA error surfaces
  at the op that caused it;
* the ``WaitForAll`` sync point, :func:`waitall`.

The reference's cached-op switches (``imperative_jit``, the cache
statistics) belong to ``cached_op.py``, which has no counterpart yet:
eager PyTorch has no per-op trace to cache, and CUDA graphs, its
counterpart, are later work.
"""
from __future__ import annotations

import threading

import torch

from .base import get_env

__all__ = ["Engine", "get", "is_naive", "waitall"]


class Engine:
    """Process-wide engine facade."""

    _inst = None
    _lock = threading.Lock()

    def __init__(self):
        self._naive = get_env("MXNET_ENGINE_TYPE") == "NaiveEngine"

    @staticmethod
    def get():
        inst = Engine._inst
        if inst is not None:
            return inst
        with Engine._lock:
            if Engine._inst is None:
                Engine._inst = Engine()
            return Engine._inst

    @property
    def naive(self):
        return self._naive

    def set_naive(self, value):
        """Force a device synchronisation after every op (debugging)."""
        self._naive = bool(value)

    def dispatch(self, name, fn, *args, **kwargs):
        """Run ``fn``: the seam of every imperative op.  In naive mode
        the CUDA device is synchronised before it returns."""
        out = fn(*args, **kwargs)
        if self._naive and torch.cuda.is_available() \
                and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return out

    @staticmethod
    def wait_for_all():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()


def get():
    return Engine.get()


def is_naive():
    return Engine.get().naive


def waitall():
    """Block until all queued device work completes (``mx.nd.waitall``)."""
    Engine.get().wait_for_all()
