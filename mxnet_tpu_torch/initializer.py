"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``):
``InitDesc``, the name rules of ``Initializer``, ``Uniform`` and
``Xavier``.

Random draws come from the port's explicit generator
(:mod:`mxnet_tpu_torch.random`) on the host and are copied into the
array, so a seed gives the same weights on the CPU and on the card.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from . import random as _random
from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "Uniform", "Xavier", "init_registry",
           "register"]

init_registry = {}


def register(klass):
    init_registry[klass.__name__.lower()] = klass
    return klass


class InitDesc(str):
    """Name + attrs descriptor handed to initializers."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _uniform(shape, low, high):
    return torch.empty(shape, dtype=torch.float32).uniform_(
        low, high, generator=_random.generator())


class Initializer:
    """Called as ``init(desc, arr)``, fills ``arr`` in place by the
    parameter name's suffix: ``*weight`` -> :meth:`_init_weight`,
    ``*bias`` and ``*beta`` -> 0, ``*gamma`` -> 1.  A ``__init__``
    attribute on the variable names another initializer for it."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """JSON ``[name, kwargs]`` form."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be a string or InitDesc")
        attrs = getattr(desc, "attrs", {})
        if attrs.get("__init__"):
            klass, kwargs = json.loads(attrs["__init__"])
            init_registry[klass.lower()](**kwargs)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias") or name.endswith("beta"):
            arr[:] = 0.0
        elif name.endswith("gamma"):
            arr[:] = 1.0
        else:
            self._init_weight(desc, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError()


@register
class Uniform(Initializer):
    """Draw from Uniform(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = _uniform(arr.shape, -self.scale, self.scale)


def xavier_scale(shape, factor_type="avg", magnitude=3.0):
    """Xavier's bound ``sqrt(magnitude / factor)``, with the factor the
    fan-in, the fan-out or their mean (the reference's formula: fans
    count the trailing dimensions past the first two as receptive
    field)."""
    hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
    fan_in = shape[1] * hw_scale if len(shape) > 1 else shape[0]
    fan_out = shape[0] * hw_scale
    if factor_type == "avg":
        factor = (fan_in + fan_out) / 2.0
    elif factor_type == "in":
        factor = fan_in
    elif factor_type == "out":
        factor = fan_out
    else:
        raise MXNetError("Incorrect factor type")
    return float(np.sqrt(magnitude / factor))


@register
class Xavier(Initializer):
    """Glorot/Xavier scaling from fan-in/fan-out (``rnd_type`` uniform or
    gaussian, ``factor_type`` avg/in/out)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, _, arr):
        scale = xavier_scale(arr.shape, self.factor_type, self.magnitude)
        if self.rnd_type == "uniform":
            arr[:] = _uniform(arr.shape, -scale, scale)
        elif self.rnd_type == "gaussian":
            arr[:] = torch.empty(arr.shape, dtype=torch.float32).normal_(
                0.0, scale, generator=_random.generator())
        else:
            raise MXNetError("Unknown random type")
