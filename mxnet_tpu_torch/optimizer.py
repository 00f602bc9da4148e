"""Optimizers (counterpart of ``mxnet_tpu/optimizer.py``): the base
class's learning-rate and weight-decay multipliers, ``SGD`` with
momentum, ``Adam``, ``create`` and ``get_updater``.

Updates write the weight and state tensors in place, with the
arithmetic of the reference's fused update ops
(``ops/optimizer_op.py``): the gradient is rescaled, clipped when
``clip_gradient`` is set, and weight decay is added to it before the
step.
"""
from __future__ import annotations

import math

import torch

from .ndarray import zeros

__all__ = ["Optimizer", "SGD", "Adam", "create", "get_updater", "Updater",
           "register"]


class Optimizer:
    """Per-parameter learning-rate / weight-decay multipliers, update
    counting, gradient rescale and clipping.  Subclasses define
    ``create_state`` and ``update``."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, sym=None,
                 begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def _attr_mults(self, key):
        out = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and key in attr[name]:
                    out[name] = float(attr[name][key])
        return out

    def set_lr_mult(self, args_lr_mult):
        """Learning-rate multipliers: ``__lr_mult__`` symbol attributes,
        overridden by the explicit dict."""
        self.lr_mult = self._attr_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Weight-decay multipliers: 0 for every parameter not named
        ``*_weight`` or ``*_gamma``, then ``__wd_mult__`` attributes,
        then the explicit dict."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not (n.endswith("_weight") or
                                n.endswith("_gamma"))}
        self.wd_mult.update(self._attr_mults("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _prep_grad(self, weight, grad, wd):
        """``clip(grad * rescale_grad) + wd * weight``; a
        ``clip_gradient`` of None or <= 0 does not clip."""
        g = grad * self.rescale_grad
        if self.clip_gradient and self.clip_gradient > 0:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g + wd * weight


register = Optimizer.register


@register
class SGD(Optimizer):
    """SGD with momentum: ``mom = momentum * mom - lr * g``, ``w += mom``
    (plain ``w -= lr * g`` without momentum)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, weight.context, dtype=str(weight.dtype))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        g = self._prep_grad(w, grad._data, wd)
        if state is None:
            w.copy_(w - lr * g)
            return
        mom = state._data
        mom.copy_(self.momentum * mom - lr * g)
        w.copy_(w + mom)


@register
class Adam(Optimizer):
    """Adam, with the bias correction folded into the learning rate:
    ``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context, dtype=str(weight.dtype)),
                zeros(weight.shape, weight.context, dtype=str(weight.dtype)))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr *= math.sqrt(1. - self.beta2 ** t) / (1. - self.beta1 ** t)
        w = weight._data
        g = self._prep_grad(w, grad._data, wd)
        mean, var = state[0]._data, state[1]._data
        b1, b2 = self.beta1, self.beta2
        mean.copy_(b1 * mean + (1 - b1) * g)
        var.copy_(b2 * var + (1 - b2) * torch.square(g))
        w.copy_(w - lr * mean / (torch.sqrt(var) + self.epsilon))


def create(name, **kwargs):
    """Create a registered optimizer by name."""
    return Optimizer.create_optimizer(name, **kwargs)


class Updater:
    """Applies an optimizer with per-index state: ``updater(index, grad,
    weight)``."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)
