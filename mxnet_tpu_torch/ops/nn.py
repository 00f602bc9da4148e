"""Layer operators of the training path and the normalisation doors
(counterpart of ``mxnet_tpu/ops/nn.py``).

``FullyConnected`` is one ``torch.matmul`` (the reference leaves the
product to XLA, outside any Pallas kernel) and ``Activation`` a
pointwise op.  ``RMSNorm`` and last-axis ``LayerNorm`` normalise over
the last axis through the doors :func:`rms_norm` / :func:`layer_norm`:
they view the input as 2D rows and call the kernels' autograd
Functions (CUDA kernels forward and backward on a CUDA tensor, plain
versions on a CPU tensor).  A ``LayerNorm`` over any other axis takes
the plain PyTorch lowering, as the reference takes XLA's there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import norm as _norm
from .registry import Bool, Float, Int, Str, register

__all__ = ["rms_norm", "layer_norm"]


def _rows(x):
    return x.reshape(-1, x.shape[-1]).contiguous()


def rms_norm(x, gamma, eps=1e-6):
    """RMSNorm over the last axis of ``x``, scaled by ``gamma``."""
    return _norm.RMSNorm.apply(_rows(x), gamma, float(eps)).reshape(x.shape)


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis of ``x`` with affine gamma/beta."""
    return _norm.LayerNorm.apply(_rows(x), gamma, beta,
                                 float(eps)).reshape(x.shape)


# ---------------------------------------------------------------------------
# FullyConnected
# ---------------------------------------------------------------------------
def _fc_args(attrs):
    return ["data", "weight"] if attrs["no_bias"] else \
        ["data", "weight", "bias"]


def _fc_fcompute(attrs, data, weight, bias=None):
    out = torch.matmul(data.reshape(data.shape[0], -1), weight.t())
    return out if bias is None else out + bias


def _fc_infer(attrs, in_shapes):
    ds = in_shapes[0]
    nh = attrs["num_hidden"]
    if ds is None:
        return in_shapes, [None], []
    in_shapes[1] = (nh, int(np.prod(ds[1:])))
    if not attrs["no_bias"]:
        in_shapes[2] = (nh,)
    return in_shapes, [(ds[0], nh)], []


def _fc_infer_backward(attrs, out_shapes, in_shapes):
    out = out_shapes[0]
    if out is not None and out[0] != 0 and in_shapes[0] is not None:
        in_shapes[0] = (out[0],) + tuple(in_shapes[0][1:])
    return in_shapes


register("FullyConnected", fcompute=_fc_fcompute, arguments=_fc_args,
         attrs={"num_hidden": Int(required=True), "no_bias": Bool(False)},
         infer_shape=_fc_infer, infer_shape_backward=_fc_infer_backward,
         doc="Y = X·Wᵀ + b, one matrix product.")


# ---------------------------------------------------------------------------
# Activation
# ---------------------------------------------------------------------------
_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": torch.nn.functional.softplus,
    "softsign": torch.nn.functional.softsign,
}

register("Activation",
         fcompute=lambda attrs, x: _ACTS[attrs["act_type"]](x),
         attrs={"act_type": Str(required=True)})


# ---------------------------------------------------------------------------
# LayerNorm / RMSNorm
# ---------------------------------------------------------------------------
def _ln_fc(attrs, data, gamma, beta):
    ax = attrs["axis"] % data.dim()
    eps = attrs["eps"]
    if ax == data.dim() - 1:
        return layer_norm(data, gamma, beta, eps)
    mean = torch.mean(data, dim=ax, keepdim=True)
    var = torch.mean((data - mean) ** 2, dim=ax, keepdim=True)
    bshape = [1] * data.dim()
    bshape[ax] = data.shape[ax]
    xhat = (data - mean) * torch.rsqrt(var + eps)
    return xhat * gamma.reshape(bshape) + beta.reshape(bshape)


def _ln_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None], []
    ax = attrs["axis"] % len(ds)
    in_shapes[1] = (ds[ax],)
    in_shapes[2] = (ds[ax],)
    return in_shapes, [ds], []


register("LayerNorm", fcompute=_ln_fc,
         arguments=("data", "gamma", "beta"),
         attrs={"axis": Int(-1), "eps": Float(1e-5)},
         infer_shape=_ln_infer,
         doc="Layer normalization over `axis` with affine gamma/beta; the "
             "last axis runs the LayerNorm kernels.")


def _rms_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None], []
    in_shapes[1] = (ds[-1],)
    return in_shapes, [ds], []


register("RMSNorm",
         fcompute=lambda attrs, data, gamma: rms_norm(data, gamma,
                                                      attrs["eps"]),
         arguments=("data", "gamma"),
         attrs={"eps": Float(1e-6)},
         infer_shape=_rms_infer,
         doc="Root-mean-square normalization over the last axis scaled by "
             "gamma; runs the RMSNorm kernels.")
