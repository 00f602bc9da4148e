"""The port's random state (counterpart of ``mxnet_tpu/random.py``).

One explicit ``torch.Generator`` a device, all seeded by :func:`seed`;
the global torch RNG is never used.  The host's generator is what
initializers and ``NDArrayIter(shuffle=True)`` draw from: they draw on
the host and copy to the device, so a seed gives the same weights on
every device.  The sampling ops, ``Dropout`` and ``LeakyReLU``'s rrelu
draw on the device they run on, from that device's generator, so a seed
reproduces their draws on one device; a CUDA generator (Philox) gives
other numbers than the host's (Mersenne Twister) from the same seed,
and both give other numbers than the reference's ``jax.random`` keys:
the streams agree with the reference's in distribution only.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator"]

_lock = threading.Lock()
_seed = 0
_gens = {}   # torch.device -> torch.Generator


def seed(seed_state):
    """Seed every device's generator (``mx.random.seed``): each starts
    afresh from ``seed_state`` at its next use."""
    global _seed
    with _lock:
        _seed = int(seed_state)
        _gens.clear()


def generator(device=None):
    """The port's generator on ``device`` (a ``torch.device`` or its
    name; the host's when None), seeded with 0 until :func:`seed` is
    called."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    with _lock:
        gen = _gens.get(dev)
        if gen is None:
            gen = _gens[dev] = torch.Generator(device=dev)
            gen.manual_seed(_seed)
        return gen
