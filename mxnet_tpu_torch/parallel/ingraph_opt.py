"""Multi-tensor optimizer updates for the trainer's step (counterpart of
``mxnet_tpu/parallel/ingraph_opt.py``).

The reference compiles each optimizer's update into its training
program.  Here the step runs eagerly, and an entry updates every live
parameter of the model at once: one chain of ``torch._foreach_*`` ops
over the lists of weights, gradients and states, in place, under
``no_grad``, instead of one chain of launches a parameter array.  The
arithmetic is the fused update ops' (``ops/optimizer_op.py``), term for
term: ``g = clip(grad * rescale_grad) + wd * w``, then SGD's ``mom =
momentum * mom - lr * g; w += mom`` (``w -= lr * g`` without momentum)
or Adam's moments and ``w -= lr * mean / (sqrt(var) + epsilon)``.

Static hyperparameters (momentum, betas, epsilon, rescale_grad,
clip_gradient) are read once from the host optimizer when the entry is
built; the per-step values, lr and wd, which carry schedulers and
per-parameter multipliers, come from :meth:`InGraphOptimizer.host_hyper`
as Python float lists and reach the update through the scalar-list
overloads of the foreach ops, so a step copies nothing from the host to
the device for them.  Adam's bias correction is folded into lr on the
host, as ``Adam.update`` does.

A parameter's state is a tuple of tensors; ``state_to_host`` and
``state_from_host`` convert it to and from what the host optimizer's
``create_state`` makes (an NDArray for SGD's momentum, None without
momentum, a pair for Adam), so the trainer's state and ``Updater.states``
(and ``.states`` files) move between the trainer and ``Module``.  The
port's optimizers are ``SGD`` and ``Adam``; an optimizer without an
entry is refused, and the error names the entries there are.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError
from ..context import cpu
from ..ndarray import NDArray, array

__all__ = ["InGraphOptimizer", "supports_ingraph", "ingraph_fingerprint"]


def _nd(t):
    """A host NDArray copy of state tensor ``t``."""
    return array(t.detach(), ctx=cpu())


def _tensor(v):
    """A host tensor of a state value (NDArray, numpy or tensor)."""
    if isinstance(v, NDArray):
        return v._data.detach()
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.from_numpy(np.asarray(v))


def _prep_grads(gs, ws, wds, rescale, clip):
    """``clip(g * rescale) + wd * w`` over the lists, in place on the
    gradients (the fused update ops' ``_prep_grad``)."""
    if rescale != 1.0:
        torch._foreach_mul_(gs, rescale)
    if clip is not None and clip > 0:
        torch._foreach_clamp_min_(gs, -clip)
        torch._foreach_clamp_max_(gs, clip)
    torch._foreach_add_(gs, torch._foreach_mul(ws, wds))


# ---------------------------------------------------------------------------
# per-optimizer entries: each builder takes the host Optimizer instance and
# returns (init_state, update, state_to_host, state_from_host)
#   init_state(w)                        -> tuple of tensors
#   update(ws, gs, states, lrs, wds)     -> None; ws and states in place
# ---------------------------------------------------------------------------
def _sgd(o):
    mom = getattr(o, "momentum", 0.0)
    rescale, clip = float(o.rescale_grad), o.clip_gradient

    if mom > 0:
        def init(w):
            return (torch.zeros_like(w, requires_grad=False),)

        @torch.no_grad()
        def update(ws, gs, states, lrs, wds):
            _prep_grads(gs, ws, wds, rescale, clip)
            moms = [s[0] for s in states]
            torch._foreach_mul_(moms, mom)
            torch._foreach_mul_(gs, lrs)
            torch._foreach_sub_(moms, gs)
            torch._foreach_add_(ws, moms)

        def to_host(s):
            return _nd(s[0])

        def from_host(v):
            return (_tensor(v),)
    else:
        def init(w):
            return ()

        @torch.no_grad()
        def update(ws, gs, states, lrs, wds):
            _prep_grads(gs, ws, wds, rescale, clip)
            torch._foreach_mul_(gs, lrs)
            torch._foreach_sub_(ws, gs)

        def to_host(s):
            return None

        def from_host(v):
            return ()
    return init, update, to_host, from_host


def _adam(o):
    rescale, clip = float(o.rescale_grad), o.clip_gradient
    b1, b2, eps = o.beta1, o.beta2, o.epsilon

    def init(w):
        return (torch.zeros_like(w, requires_grad=False),
                torch.zeros_like(w, requires_grad=False))

    @torch.no_grad()
    def update(ws, gs, states, lrs, wds):
        # bias correction is folded into lr on the host (_adam_host_lr),
        # exactly as Adam.update does before its arithmetic
        _prep_grads(gs, ws, wds, rescale, clip)
        means = [s[0] for s in states]
        variances = [s[1] for s in states]
        torch._foreach_mul_(means, b1)
        torch._foreach_add_(means, torch._foreach_mul(gs, 1 - b1))
        sq = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(variances, b2)
        torch._foreach_add_(variances, sq)
        denom = torch._foreach_sqrt(variances)
        torch._foreach_add_(denom, eps)
        step = torch._foreach_mul(means, lrs)
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(ws, step)

    def to_host(s):
        return (_nd(s[0]), _nd(s[1]))

    def from_host(v):
        return (_tensor(v[0]), _tensor(v[1]))
    return init, update, to_host, from_host


def _adam_host_lr(o, index, lr):
    t = o._index_update_count[index]
    return lr * math.sqrt(1. - o.beta2 ** t) / (1. - o.beta1 ** t)


# class name (lowercased) -> (builder, host_lr_transform or None)
_ENTRIES = {
    "sgd": (_sgd, None),
    "adam": (_adam, _adam_host_lr),
}


# per-entry hyperparameters read once into the update (lr and wd stay
# per-step arguments); with the class name and the common statics they
# fully determine the update's arithmetic: the optimizer half of the
# step-program cache key (parallel/spmd.py)
_STATIC_ATTRS = {
    "sgd": ("momentum",),
    "adam": ("beta1", "beta2", "epsilon"),
}


def _entry_key(optimizer):
    key = type(optimizer).__name__.lower()
    if key not in _ENTRIES:
        raise MXNetError(
            "no in-graph update for optimizer %r (have %s)"
            % (type(optimizer).__name__, sorted(_ENTRIES)))
    return key


def supports_ingraph(optimizer):
    """True if this Optimizer instance has a multi-tensor entry."""
    return type(optimizer).__name__.lower() in _ENTRIES


def ingraph_fingerprint(optimizer):
    """Hashable identity of the update arithmetic for ``optimizer``.

    Two Optimizer instances with the same fingerprint run the same
    update (host-side bookkeeping, such as schedulers, idx2name and
    update counts, rides in the per-step lr/wd lists), so they may share
    one step program."""
    key = _entry_key(optimizer)
    statics = tuple((a, getattr(optimizer, a, None))
                    for a in _STATIC_ATTRS[key])
    clip = optimizer.clip_gradient
    return (key, float(optimizer.rescale_grad),
            float(clip) if clip else None) + statics


class InGraphOptimizer:
    """Multi-tensor update adapter around a host ``Optimizer`` instance.

    The host instance stays authoritative for bookkeeping (update
    counts, schedulers, lr/wd multipliers); ``host_hyper`` advances it
    one step and returns the per-parameter (lr, wd) lists the update
    consumes."""

    def __init__(self, optimizer):
        key = _entry_key(optimizer)
        self.optimizer = optimizer
        builder, self._host_lr = _ENTRIES[key]
        (self.init_state, self.update,
         self.state_to_host, self.state_from_host) = builder(optimizer)

    def init_states(self, ws):
        """``init_state`` of each tensor of ``ws`` (every entry's state is
        zeros of the weight's shape), filled by one multi-tensor fill, so
        the launches do not grow with the number of parameters."""
        arity = len(self.init_state(torch.empty(0)))
        flat = [torch.empty_like(w, memory_format=torch.contiguous_format)
                for w in ws for _ in range(arity)]
        if flat:
            torch._foreach_zero_(flat)
        return [tuple(flat[i * arity:(i + 1) * arity])
                for i in range(len(ws))]

    def host_hyper(self, indices):
        """Advance update counts and compute (lrs, wds) float lists for
        ``indices``, as the Updater does: every ``_update_count`` first,
        then ``_get_lr``/``_get_wd`` (and Adam's bias-correction fold),
        so a scheduler sees the step's ``num_update`` for every
        parameter."""
        o = self.optimizer
        lrs, wds = [], []
        for i in indices:
            o._update_count(i)
        for i in indices:
            lr = o._get_lr(i)
            if self._host_lr is not None:
                lr = self._host_lr(o, i, lr)
            lrs.append(float(lr))
            wds.append(float(o._get_wd(i)))
        return lrs, wds
