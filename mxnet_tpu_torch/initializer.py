"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``):
``InitDesc``, the name rules of ``Initializer``, ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal``, ``Xavier``, ``LSTMBias`` (an LSTM
cell's ``i2h_bias``, set through the variable's ``__init__``
attribute) and ``FusedRNN`` (the ``RNN`` op's packed parameter vector).

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

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "LSTMBias", "FusedRNN", "init_registry",
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


_ZERO_SUFFIXES = ("bias", "beta", "moving_mean", "running_mean",
                  "moving_inv_var", "moving_avg")
_ONE_SUFFIXES = ("gamma", "moving_var", "running_var")


class Initializer:
    """Called as ``init(desc, arr)``, fills ``arr`` in place by the
    parameter name's suffix, as the reference's: ``*weight`` ->
    :meth:`_init_weight`, ``*bias`` and ``*beta`` -> 0, ``*gamma`` -> 1,
    and BatchNorm's auxiliary states ``*moving_mean`` /
    ``*running_mean`` -> 0, ``*moving_var`` / ``*running_var`` -> 1,
    ``*moving_inv_var`` and ``*moving_avg`` -> 0; any other name ->
    :meth:`_init_weight`.  A ``__init__`` attribute on the variable
    names another initializer for it, which gets this one as the
    descriptor's ``global_init`` when it has none."""

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
            if getattr(desc, "global_init", None) is None:
                desc = InitDesc(desc, attrs, global_init=self)
            init_registry[klass.lower()](**kwargs)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith(_ZERO_SUFFIXES):
            arr[:] = 0.0
        elif name.endswith(_ONE_SUFFIXES):
            arr[:] = 1.0
        else:
            self._init_weight(desc, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError()


@register
class Zero(Initializer):
    """Fill with zeros."""

    def _init_weight(self, _, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    """Fill with ones."""

    def _init_weight(self, _, arr):
        arr[:] = 1.0


@register
class Constant(Initializer):
    """Fill with ``value``."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    """Draw from Uniform(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = _uniform(arr.shape, -self.scale, self.scale)


@register
class Normal(Initializer):
    """Draw from Normal(0, sigma)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = torch.empty(arr.shape, dtype=torch.float32).normal_(
            0.0, self.sigma, generator=_random.generator())


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


@register
class LSTMBias(Initializer):
    """An LSTM cell's bias: zeros but the forget gate's slice (the
    second of the ``i, f, c, o`` quarters), which is ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, _, arr):
        v = torch.zeros(arr.shape, dtype=torch.float32)
        num_hidden = arr.shape[0] // 4
        v[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = v


@register
class FusedRNN(Initializer):
    """The ``RNN`` op's packed parameter vector, piece by piece: each
    layer's and direction's ``i2h_weight`` and ``h2h_weight`` drawn by
    ``init`` (an initializer or its ``dumps()``; the descriptor's
    ``global_init`` when None) under the names ``l<layer>_`` or
    ``r<layer>_`` + ``i2h_weight`` / ``h2h_weight``, the biases zero, and
    an LSTM's ``i2h_bias`` as :class:`LSTMBias` makes it, so the fused
    op starts where the explicit cells would."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if init is not None and not isinstance(init, str):
            init = init.dumps()
        super().__init__(init=init, num_hidden=num_hidden,
                         num_layers=num_layers, mode=mode,
                         bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = None
        if init is not None:
            klass, kwargs = json.loads(init)
            self._init = init_registry[klass.lower()](**kwargs)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        from . import ndarray as nd
        from .context import cpu
        from .ops.rnn_op import _GATES, unpack_params
        init = self._init or getattr(desc, "global_init", None)
        if init is None:
            raise MXNetError("FusedRNN: no initializer for the weights "
                             "(pass init=, or call through a global one)")
        g, h = _GATES[self._mode], self._num_hidden
        d = 2 if self._bidirectional else 1
        n = arr.shape[0]
        # the input width is what the packed length leaves for layer 0
        rest = sum(d * g * h * (h * d + h + 2)
                   for _ in range(self._num_layers - 1))
        input_size = (n - rest) // (d * g * h) - h - 2
        flat = torch.zeros(n, dtype=torch.float32)
        layers = unpack_params(flat, self._num_layers, input_size, h,
                               self._mode, self._bidirectional)
        for li, dirs in enumerate(layers):
            for di, (wi, wh, bi, _) in enumerate(dirs):
                pre = "%s%d_" % ("lr"[di], li)
                for nm, w in (("i2h_weight", wi), ("h2h_weight", wh)):
                    piece = nd.zeros(tuple(w.shape), cpu())
                    init(InitDesc(pre + nm), piece)
                    w.copy_(piece._data)
                if self._mode == "lstm":
                    bi[h:2 * h] = self._forget_bias
        arr[:] = flat
