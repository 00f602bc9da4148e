"""The port's random state (counterpart of ``mxnet_tpu/random.py``).

One explicit ``torch.Generator`` on the host, seeded by :func:`seed`,
is what initializers and ``NDArrayIter(shuffle=True)`` draw from; the
global torch RNG is never used.  Draws happen on the host and are
copied to the device, so a seed gives the same numbers on every device.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator"]

_lock = threading.Lock()
_gen = None


def seed(seed_state):
    """Seed the port's generator (``mx.random.seed``)."""
    global _gen
    with _lock:
        _gen = torch.Generator(device="cpu")
        _gen.manual_seed(int(seed_state))


def generator():
    """The port's generator, seeded with 0 until :func:`seed` is
    called."""
    global _gen
    with _lock:
        if _gen is None:
            _gen = torch.Generator(device="cpu")
            _gen.manual_seed(0)
        return _gen
