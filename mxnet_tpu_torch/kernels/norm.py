"""RMSNorm and LayerNorm forward: CUDA kernels and their plain versions.

Counterpart of ``mxnet_tpu/pallas_ops/norm.py`` (forward only; the
backward kernels arrive with the training slice).  ``rms_norm`` and
``layer_norm`` take a 2D ``(rows, width)`` fp32 tensor and normalise
each row over its last axis with fp32 statistics.  A CPU tensor runs
the plain version beside them; a CUDA tensor launches
``csrc/norm.cu`` or raises.
"""
from __future__ import annotations

import torch

from . import _build, count_launch

__all__ = ["rms_norm", "layer_norm", "rms_norm_reference",
           "layer_norm_reference"]


def rms_norm_reference(x, gamma, eps=1e-6):
    """Plain PyTorch ``x * rsqrt(mean(x^2) + eps) * gamma`` per row."""
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r * gamma.float()).to(x.dtype)


def layer_norm_reference(x, gamma, beta, eps=1e-5):
    """Plain PyTorch LayerNorm per row, variance as ``mean((x-mu)^2)``."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) * (xf - mu), dim=-1, keepdim=True)
    xhat = (xf - mu) * torch.rsqrt(var + eps)
    return (xhat * gamma.float() + beta.float()).to(x.dtype)


def _check_rows(name, x, *vecs):
    if x.dim() != 2:
        raise ValueError("%s takes a 2D (rows, width) tensor, got shape %s"
                         % (name, tuple(x.shape)))
    for t in (x,) + vecs:
        if t.device != x.device:
            raise ValueError("%s: all tensors must be on %s"
                             % (name, x.device))
        if t.dtype != torch.float32:
            raise ValueError("%s: the CUDA kernel takes float32, got %s"
                             % (name, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s: tensors must be contiguous" % name)
    for v in vecs:
        if v.shape != (x.shape[1],):
            raise ValueError("%s: parameter shape %s does not match width "
                             "%d" % (name, tuple(v.shape), x.shape[1]))


def _route(name, x):
    """True for the CUDA kernel, False for the plain version."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError("%s: no kernel for device %s" % (name, x.device))
    return True


def rms_norm(x, gamma, eps=1e-6):
    """RMS normalisation of 2D ``x`` over its last axis, scaled by
    ``gamma``."""
    if not _route("rms_norm", x):
        return rms_norm_reference(x, gamma, eps)
    _check_rows("rms_norm", x, gamma)
    y = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(lib.mxt_rms_norm_f32(
            x.data_ptr(), gamma.data_ptr(), y.data_ptr(), x.shape[0],
            x.shape[1], float(eps), stream), "rms_norm")
    count_launch("rms_norm")
    return y


def layer_norm(x, gamma, beta, eps=1e-5):
    """Layer normalisation of 2D ``x`` over its last axis with affine
    ``gamma``/``beta``."""
    if not _route("layer_norm", x):
        return layer_norm_reference(x, gamma, beta, eps)
    _check_rows("layer_norm", x, gamma, beta)
    y = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(lib.mxt_layer_norm_f32(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            x.shape[0], x.shape[1], float(eps), stream), "layer_norm")
    count_launch("layer_norm")
    return y
