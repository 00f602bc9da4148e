"""Fused optimizer-update operators (counterpart of
``mxnet_tpu/ops/optimizer_op.py``): ``sgd_update``, ``sgd_mom_update``,
``adam_update``, ``rmsprop_update``, ``rmspropalex_update``, the
updates an imperative training loop calls on NDArrays
(``mx.nd.sgd_mom_update(w, w.grad, mom, lr=..., out=w)``).

Each forward returns the new weight and, after it, the new optimizer
states; the registry's ``mutate`` pairs make the imperative plane write
those states back into their inputs in place, and ``out=w`` writes the
weight in place, so a parameter stays an autograd leaf.  The arithmetic
is the reference's, term for term.
"""
from __future__ import annotations

import torch

from .registry import Float, register


def _prep_grad(grad, weight, attrs):
    g = grad * attrs["rescale_grad"]
    if attrs["clip_gradient"] > 0:
        g = torch.clamp(g, -attrs["clip_gradient"], attrs["clip_gradient"])
    return g + attrs["wd"] * weight


_COMMON = {"lr": Float(required=True), "wd": Float(0.0),
           "rescale_grad": Float(1.0), "clip_gradient": Float(-1.0)}


def _sgd_update(attrs, weight, grad):
    return weight - attrs["lr"] * _prep_grad(grad, weight, attrs)


register("sgd_update", fcompute=_sgd_update,
         arguments=("weight", "grad"), attrs=dict(_COMMON),
         doc="w - lr * (rescale_grad * clip(grad) + wd * w).")


def _sgd_mom_update(attrs, weight, grad, mom):
    g = _prep_grad(grad, weight, attrs)
    mom_new = attrs["momentum"] * mom - attrs["lr"] * g
    return weight + mom_new, mom_new


register("sgd_mom_update", fcompute=_sgd_mom_update,
         arguments=("weight", "grad", "mom"),
         attrs=dict(_COMMON, momentum=Float(0.0)),
         mutate=((1, 2),),
         doc="mom = momentum * mom - lr * g; w + mom (mom updated in "
             "place).")


def _adam_update(attrs, weight, grad, mean, var):
    g = _prep_grad(grad, weight, attrs)
    b1, b2 = attrs["beta1"], attrs["beta2"]
    mean_new = b1 * mean + (1 - b1) * g
    var_new = b2 * var + (1 - b2) * torch.square(g)
    w = weight - attrs["lr"] * mean_new / (torch.sqrt(var_new) +
                                           attrs["epsilon"])
    return w, mean_new, var_new


register("adam_update", fcompute=_adam_update,
         arguments=("weight", "grad", "mean", "var"),
         attrs=dict(_COMMON, beta1=Float(0.9), beta2=Float(0.999),
                    epsilon=Float(1e-8)),
         mutate=((1, 2), (2, 3)),
         doc="Adam step (mean and var updated in place).")


def _rmsprop_update(attrs, weight, grad, n):
    g = _prep_grad(grad, weight, attrs)
    rho = attrs["gamma1"]
    n_new = rho * n + (1 - rho) * torch.square(g)
    w = weight - attrs["lr"] * g / torch.sqrt(n_new + attrs["epsilon"])
    if attrs["clip_weights"] > 0:
        w = torch.clamp(w, -attrs["clip_weights"], attrs["clip_weights"])
    return w, n_new


register("rmsprop_update", fcompute=_rmsprop_update,
         arguments=("weight", "grad", "n"),
         attrs=dict(_COMMON, gamma1=Float(0.95), epsilon=Float(1e-8),
                    clip_weights=Float(-1.0)),
         mutate=((1, 2),),
         doc="RMSProp step (n updated in place).")


def _rmspropalex_update(attrs, weight, grad, n, g_avg, delta):
    g = _prep_grad(grad, weight, attrs)
    rho, mom = attrs["gamma1"], attrs["gamma2"]
    n_new = rho * n + (1 - rho) * torch.square(g)
    g_new = rho * g_avg + (1 - rho) * g
    delta_new = mom * delta - attrs["lr"] * g / torch.sqrt(
        n_new - torch.square(g_new) + attrs["epsilon"])
    w = weight + delta_new
    if attrs["clip_weights"] > 0:
        w = torch.clamp(w, -attrs["clip_weights"], attrs["clip_weights"])
    return w, n_new, g_new, delta_new


register("rmspropalex_update", fcompute=_rmspropalex_update,
         arguments=("weight", "grad", "n", "g", "delta"),
         attrs=dict(_COMMON, gamma1=Float(0.95), gamma2=Float(0.9),
                    epsilon=Float(1e-8), clip_weights=Float(-1.0)),
         mutate=((1, 2), (2, 3), (3, 4)),
         doc="Graves' RMSProp step (n, g and delta updated in place).")
