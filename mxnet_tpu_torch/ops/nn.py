"""Layer operators (counterpart of ``mxnet_tpu/ops/nn.py``).

``FullyConnected`` is one ``torch.matmul`` (the reference leaves the
product to XLA, outside any Pallas kernel), except for a weight that
arrives as a :class:`~..kernels.dequant_matmul.QuantizedWeight` (int8
serving, ``ProgramStore(compute_dtype='int8')``): that one goes through
the ``dequant_matmul`` kernel on the flattened input made contiguous
fp32, as the reference's door does.  ``Activation`` is a pointwise op.
``RMSNorm`` and last-axis ``LayerNorm`` normalise over the last axis
through the doors :func:`rms_norm` / :func:`layer_norm`:
they view the input as 2D rows and call the kernels' autograd
Functions (CUDA kernels forward and backward on a CUDA tensor, plain
versions on a CPU tensor).  A ``LayerNorm`` over any other axis takes
the plain PyTorch lowering, as the reference takes XLA's there.

The convolution family, pooling and the other layers are XLA in the
reference, outside any Pallas kernel, so here they are PyTorch's
functional ops (cuDNN on the card, fp32 with TF32 off, as
``context.default_device`` sets it), in the reference's NCHW / OIHW
layouts and with its output sizes:

* ``Deconvolution``'s weight is ``(in, out / group, k...)``, as
  ``conv_transpose``'s.  It takes the whole transposed convolution and
  cuts the reference's window from it, zero-padded where ``adj`` (or
  the one ``target_shape`` implies) runs past the end: one route for
  every ``adj``, where ``output_padding`` must stay below the stride.
  The reference applies no ``dilate`` to a deconvolution, and neither
  does this one.
* ``Pooling`` pads explicitly (``-inf`` for max, 0 for avg and sum) and
  pools without padding, whatever the convention: ``full`` always has
  ``ceil((d + 2p - k) / s) + 1`` windows, which PyTorch's ``ceil_mode``
  cuts where the last window starts in the padding, and PyTorch refuses
  padding above half the kernel.  ``avg`` divides by ``prod(kernel)``
  over the padding too; ``global_pool`` ignores ``kernel``, and its
  ``sum`` is a mean, as the reference's.
* ``BatchNorm`` (auxiliary states ``moving_mean``, ``moving_var``)
  normalises with the biased batch variance through ``F.batch_norm``
  without running arrays, and updates its moving statistics itself,
  ``momentum * old + (1 - momentum) * batch`` from the biased variance,
  outside autograd: PyTorch's running update weighs the other way and
  takes the unbiased variance.  ``fix_gamma`` uses ones for gamma (its
  gradient is 0); ``use_global_stats`` or inference uses the moving
  statistics.
* ``Dropout`` and ``LeakyReLU(act_type='rrelu')`` draw from the
  generator they are handed, in training only: a keep mask scaled by
  ``1 / (1 - p)``, and a slope for each element uniform in ``[lower_bound,
  upper_bound]``.  At inference Dropout is the identity and rrelu uses
  the midpoint slope.  The reference's rrelu takes the midpoint in
  training too (ROADMAP Queue 3, differences by design).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..kernels import dequant_matmul as _dq
from ..kernels import norm as _norm
from .registry import (Bool, Float, Int, Shape, Str, register,
                       register_alias)

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
    x = data.reshape(data.shape[0], -1)
    if isinstance(weight, _dq.QuantizedWeight):
        # int8 weight-only serving: inference only, no training plane
        # feeds a QuantizedWeight
        out = _dq.dequant_matmul(x.float().contiguous(), weight.codes,
                                 weight.scales)
    else:
        out = torch.matmul(x, weight.t())
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


# ---------------------------------------------------------------------------
# LeakyReLU
# ---------------------------------------------------------------------------
def _leaky_args(attrs):
    return ["data", "gamma"] if attrs["act_type"] == "prelu" else ["data"]


def _leaky_fstateful(attrs, inputs, aux, is_train, generator):
    data = inputs[0]
    t, slope = attrs["act_type"], attrs["slope"]
    if t == "leaky":
        out = torch.where(data > 0, data, slope * data)
    elif t == "elu":
        out = torch.where(data > 0, data, slope * torch.expm1(data))
    elif t == "prelu":
        g = inputs[1].reshape((1, -1) + (1,) * (data.dim() - 2))
        out = torch.where(data > 0, data, g * data)
    elif t == "rrelu":
        lo, hi = attrs["lower_bound"], attrs["upper_bound"]
        if is_train:
            slope = torch.empty_like(data).uniform_(lo, hi,
                                                    generator=generator)
        else:
            slope = (lo + hi) / 2
        out = torch.where(data > 0, data, slope * data)
    else:
        raise MXNetError("unknown LeakyReLU act_type %r" % t)
    return (out,), ()


def _leaky_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if attrs["act_type"] == "prelu" and ds is not None:
        in_shapes[1] = (ds[1],)
    return in_shapes, [ds], []


register("LeakyReLU", fstateful=_leaky_fstateful, arguments=_leaky_args,
         attrs={"act_type": Str("leaky"), "slope": Float(0.25),
                "lower_bound": Float(0.125), "upper_bound": Float(0.334)},
         infer_shape=_leaky_infer, needs_rng=True, rng_at_eval=False,
         doc="Leaky, parametric (prelu), exponential (elu) or randomized "
             "(rrelu) rectifier.")


# ---------------------------------------------------------------------------
# Convolution / Deconvolution
# ---------------------------------------------------------------------------
def _conv_args(attrs):
    return ["data", "weight"] if attrs["no_bias"] else \
        ["data", "weight", "bias"]


def _tuple_n(v, n, name):
    if v is None:
        return (1,) * n if name != "pad" else (0,) * n
    if len(v) != n:
        raise MXNetError("%s must have %d elements, got %s" % (name, n, v))
    return tuple(v)


def _conv_geometry(attrs):
    n = len(attrs["kernel"])
    if not 1 <= n <= 3:
        raise MXNetError("convolutions are 1-, 2- or 3-D, got kernel %s"
                         % (attrs["kernel"],))
    return (n, tuple(attrs["kernel"]), _tuple_n(attrs["stride"], n, "stride"),
            _tuple_n(attrs["pad"], n, "pad"),
            _tuple_n(attrs["dilate"], n, "dilate"))


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _conv_fcompute(attrs, data, weight, bias=None):
    n, _, stride, pad, dilate = _conv_geometry(attrs)
    return _CONV[n](data, weight, bias, stride, pad, dilate,
                    attrs["num_group"])


def _conv_out_dim(d, k, s, p, dil):
    return (d + 2 * p - (dil * (k - 1) + 1)) // s + 1


def _conv_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None], []
    _, kernel, stride, pad, dilate = _conv_geometry(attrs)
    nf, ng = attrs["num_filter"], attrs["num_group"]
    in_shapes[1] = (nf, ds[1] // ng) + kernel
    if not attrs["no_bias"]:
        in_shapes[2] = (nf,)
    spatial = tuple(_conv_out_dim(d, k, s, p, dil) for d, k, s, p, dil
                    in zip(ds[2:], kernel, stride, pad, dilate))
    return in_shapes, [(ds[0], nf) + spatial], []


_CONV_ATTRS = {
    "kernel": Shape(required=True), "stride": Shape(None), "pad": Shape(None),
    "dilate": Shape(None), "num_filter": Int(required=True),
    "num_group": Int(1), "no_bias": Bool(False),
    "workspace": Int(1024), "cudnn_tune": Str(None),
    "cudnn_off": Bool(False), "layout": Str(None),
}

register("Convolution", fcompute=_conv_fcompute, arguments=_conv_args,
         attrs=_CONV_ATTRS, infer_shape=_conv_infer,
         doc="1-, 2- or 3-D convolution, NC(D)HW data and OI(D)HW weight, "
             "with groups and dilation; the workspace and cudnn_* "
             "attributes are accepted and ignored.")
register_alias("Convolution", "Convolution_v1")


def _deconv_adj(attrs, in_spatial, kernel, stride, pad):
    n = len(kernel)
    if attrs["target_shape"]:
        return tuple(t - ((i - 1) * s - 2 * p + k) for t, i, s, p, k in zip(
            attrs["target_shape"], in_spatial, stride, pad, kernel))
    return _tuple_n(attrs["adj"], n, "adj") if attrs["adj"] else (0,) * n


def _deconv_fcompute(attrs, data, weight, bias=None):
    """The gradient of a convolution with respect to its data: output
    size ``(i - 1) * s - 2 * p + k + adj`` a dimension."""
    n, kernel, stride, pad, _ = _conv_geometry(attrs)
    g = attrs["num_group"]
    adj = _deconv_adj(attrs, data.shape[2:], kernel, stride, pad)
    # the whole transposed convolution, (i - 1) * s + k a dimension, cut
    # to the reference's window [p, p + out), zero-padded where it runs
    # past the end
    full = _DECONV[n](data, weight, None, stride, 0, 0, g)
    for ax, (i, s, p, k, a) in enumerate(zip(data.shape[2:], stride, pad,
                                             kernel, adj)):
        out = (i - 1) * s - 2 * p + k + a
        dim = 2 + ax
        full = full.narrow(dim, p, min(out, full.shape[dim] - p))
        short = out - full.shape[dim]
        if short > 0:
            widths = [0, 0] * (full.dim() - 1 - dim) + [0, short]
            full = F.pad(full, widths)
    if bias is not None:
        full = full + bias.reshape((1, -1) + (1,) * n)
    return full


def _deconv_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None], []
    n, kernel, stride, pad, _ = _conv_geometry(attrs)
    nf = attrs["num_filter"]
    in_shapes[1] = (ds[1], nf // attrs["num_group"]) + kernel
    if not attrs["no_bias"]:
        in_shapes[2] = (nf,)
    if attrs["target_shape"]:
        spatial = tuple(attrs["target_shape"])
    else:
        adj = _tuple_n(attrs["adj"], n, "adj") if attrs["adj"] else (0,) * n
        spatial = tuple((d - 1) * s - 2 * p + k + a for d, k, s, p, a
                        in zip(ds[2:], kernel, stride, pad, adj))
    return in_shapes, [(ds[0], nf) + spatial], []


register("Deconvolution", fcompute=_deconv_fcompute, arguments=_conv_args,
         attrs=dict(_CONV_ATTRS, adj=Shape(None), target_shape=Shape(None)),
         infer_shape=_deconv_infer,
         doc="Transposed convolution (the gradient of Convolution with "
             "respect to its data); weight (in, out / group, k...).")


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------
def _pool_fcompute(attrs, data):
    pool = attrs["pool_type"]
    if pool not in ("max", "avg", "sum"):
        raise MXNetError("unknown pool_type %r" % pool)
    if attrs["global_pool"]:
        axes = tuple(range(2, data.dim()))
        if pool == "max":
            return torch.amax(data, dim=axes, keepdim=True)
        return torch.mean(data, dim=axes, keepdim=True)
    kernel = tuple(attrs["kernel"])
    n = len(kernel)
    stride = _tuple_n(attrs["stride"], n, "stride")
    pad = _tuple_n(attrs["pad"], n, "pad")
    if n == 1:   # pooled as 2-D over a unit trailing dimension
        out = _pool_fcompute(dict(attrs, kernel=kernel + (1,),
                                  stride=stride + (1,), pad=pad + (0,)),
                             data.unsqueeze(-1))
        return out.squeeze(-1)
    data = pool_pad(attrs, data, kernel, stride, pad)
    if pool == "max":
        fn = F.max_pool2d if n == 2 else F.max_pool3d
        return fn(data, kernel, stride)
    fn = F.avg_pool2d if n == 2 else F.avg_pool3d
    return fn(data, kernel, stride,
              divisor_override=1 if pool == "sum" else None)


def pool_pad(attrs, data, kernel, stride, pad):
    """``data`` padded for a pool without padding: ``pad`` on the left
    and on the right of each spatial axis, and on the right up to the
    last of the ``full`` convention's windows; ``-inf`` for max, 0
    for avg and sum."""
    widths = []
    for d, k, s, p in zip(data.shape[2:], kernel, stride, pad):
        right = p
        if attrs["pooling_convention"] == "full":
            out = int(np.ceil((d + 2 * p - k) / s)) + 1
            right = max((out - 1) * s + k - d - p, p)
        widths = [p, right] + widths
    if not any(widths):
        return data
    return F.pad(data, widths,
                 value=-np.inf if attrs["pool_type"] == "max" else 0.0)


def _pool_infer(attrs, in_shapes):
    (ds,) = in_shapes
    if ds is None:
        return in_shapes, [None], []
    if attrs["global_pool"]:
        return in_shapes, [tuple(ds[:2]) + (1,) * (len(ds) - 2)], []
    n = len(attrs["kernel"])
    kernel = tuple(attrs["kernel"])
    stride = _tuple_n(attrs["stride"], n, "stride")
    pad = _tuple_n(attrs["pad"], n, "pad")
    rounder = np.ceil if attrs["pooling_convention"] == "full" else np.floor
    spatial = tuple(int(rounder((d + 2 * p - k) / s)) + 1
                    for d, k, s, p in zip(ds[2:], kernel, stride, pad))
    return in_shapes, [tuple(ds[:2]) + spatial], []


register("Pooling", fcompute=_pool_fcompute,
         attrs={"kernel": Shape(None), "pool_type": Str("max"),
                "global_pool": Bool(False), "stride": Shape(None),
                "pad": Shape(None), "pooling_convention": Str("valid")},
         infer_shape=_pool_infer,
         doc="Max, average or sum pooling over 1-, 2- or 3-D windows, or "
             "over the whole of each channel (global_pool).")
register_alias("Pooling", "Pooling_v1")


# ---------------------------------------------------------------------------
# BatchNorm (auxiliary states moving_mean, moving_var)
# ---------------------------------------------------------------------------
def _bn_fstateful(attrs, inputs, aux, is_train, generator):
    data, gamma, beta = inputs
    moving_mean, moving_var = aux
    eps, momentum = attrs["eps"], attrs["momentum"]
    if attrs["fix_gamma"]:
        gamma = torch.ones_like(gamma)
    if attrs["use_global_stats"] or not is_train:
        out = F.batch_norm(data, moving_mean, moving_var, gamma, beta,
                           training=False, eps=eps)
        mean, var = moving_mean, moving_var
        new_aux = (moving_mean, moving_var)
    else:
        out = F.batch_norm(data, None, None, gamma, beta, training=True,
                           eps=eps)
        axes = [0] + list(range(2, data.dim()))
        # differentiable only where they are outputs too
        with torch.set_grad_enabled(attrs["output_mean_var"] and
                                    torch.is_grad_enabled()):
            var, mean = torch.var_mean(data, dim=axes, correction=0)
        with torch.no_grad():
            new_aux = (momentum * moving_mean + (1 - momentum) * mean,
                       momentum * moving_var + (1 - momentum) * var)
    if attrs["output_mean_var"]:
        return (out, mean, var), new_aux
    return (out,), new_aux


def _bn_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None] * (3 if attrs["output_mean_var"] else 1), \
            [None, None]
    c = (ds[1],)
    in_shapes[1] = c
    in_shapes[2] = c
    outs = [ds, c, c] if attrs["output_mean_var"] else [ds]
    return in_shapes, outs, [c, c]


register("BatchNorm", fstateful=_bn_fstateful,
         arguments=("data", "gamma", "beta"),
         aux_states=("moving_mean", "moving_var"),
         attrs={"eps": Float(1e-3), "momentum": Float(0.9),
                "fix_gamma": Bool(True), "use_global_stats": Bool(False),
                "output_mean_var": Bool(False)},
         num_outputs=lambda attrs: 3 if attrs["output_mean_var"] else 1,
         outputs=lambda attrs: (["output", "mean", "var"]
                                if attrs["output_mean_var"] else ["output"]),
         infer_shape=_bn_infer,
         doc="Batch normalization over every axis but the channels (1), "
             "with moving averages of the batch statistics as auxiliary "
             "states.")


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------
def _dropout_fstateful(attrs, inputs, aux, is_train, generator):
    (data,) = inputs
    p = attrs["p"]
    if not is_train or p <= 0:
        return (data,), ()
    keep = 1.0 - p
    mask = torch.empty_like(data).bernoulli_(keep, generator=generator)
    return ((data * mask) / keep,), ()


register("Dropout", fstateful=_dropout_fstateful,
         attrs={"p": Float(0.5)}, needs_rng=True, rng_at_eval=False,
         doc="Inverted dropout in training (each element kept with "
             "probability 1 - p and scaled by 1 / (1 - p)); the identity "
             "at inference.")


# ---------------------------------------------------------------------------
# LRN, InstanceNorm, L2Normalization, UpSampling
# ---------------------------------------------------------------------------
def _lrn_fc(attrs, x):
    alpha, beta, knorm, nsize = (attrs["alpha"], attrs["beta"],
                                 attrs["knorm"], attrs["nsize"])
    half = nsize // 2
    sqp = F.pad(torch.square(x), [0, 0] * (x.dim() - 2) + [half, half])
    acc = sum(sqp[:, i:i + x.shape[1]] for i in range(nsize))
    return x * torch.pow(knorm + (alpha / nsize) * acc, -beta)


register("LRN", fcompute=_lrn_fc,
         attrs={"alpha": Float(1e-4), "beta": Float(0.75),
                "knorm": Float(2.0), "nsize": Int(required=True)},
         doc="Local response normalization across nsize channels.")


def _in_fc(attrs, data, gamma, beta):
    axes = tuple(range(2, data.dim()))
    mean = torch.mean(data, dim=axes, keepdim=True)
    var = torch.mean(torch.square(data - mean), dim=axes, keepdim=True)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + attrs["eps"]) \
        * gamma.reshape(bshape) + beta.reshape(bshape)


def _in_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None], []
    in_shapes[1] = (ds[1],)
    in_shapes[2] = (ds[1],)
    return in_shapes, [ds], []


register("InstanceNorm", fcompute=_in_fc,
         arguments=("data", "gamma", "beta"),
         attrs={"eps": Float(1e-3)}, infer_shape=_in_infer,
         doc="Normalization of each sample's channel over its spatial "
             "axes, with affine gamma/beta.")

_L2_AXES = {"instance": lambda nd: tuple(range(1, nd)),
            "channel": lambda nd: (1,),
            "spatial": lambda nd: tuple(range(2, nd))}


def _l2norm_fc(attrs, x):
    mode = attrs["mode"]
    if mode not in _L2_AXES:
        raise MXNetError("unknown L2Normalization mode %r" % mode)
    axes = _L2_AXES[mode](x.dim())
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=True)
                      + attrs["eps"])
    return x / norm


register("L2Normalization", fcompute=_l2norm_fc,
         attrs={"eps": Float(1e-10), "mode": Str("instance")},
         doc="x / sqrt(sum(x^2) + eps) over each instance, channel or "
             "spatial slice.")


def _upsampling_fc(attrs, *xs):
    scale = attrs["scale"]
    outs = [x.repeat_interleave(scale, dim=2).repeat_interleave(scale, dim=3)
            for x in xs]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _upsampling_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None], []
    scale = attrs["scale"]
    c = sum(s[1] for s in in_shapes if s is not None)
    return in_shapes, [(ds[0], c, ds[2] * scale, ds[3] * scale)], []


register("UpSampling", fcompute=_upsampling_fc, arguments=("arg",),
         key_var_num_args="num_args",
         attrs={"scale": Int(required=True), "num_args": Int(required=True),
                "sample_type": Str("nearest"), "num_filter": Int(0),
                "multi_input_mode": Str("concat"), "workspace": Int(512)},
         infer_shape=_upsampling_infer,
         doc="Nearest-neighbour upsampling of NCHW inputs by `scale`, "
             "concatenated over the channels.")
