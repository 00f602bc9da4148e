"""RMSNorm and LayerNorm, forward and backward: CUDA kernels and their
plain versions.

Counterpart of ``mxnet_tpu/pallas_ops/norm.py``.  ``rms_norm`` and
``layer_norm`` take a 2D ``(rows, width)`` fp32 tensor and normalise
each row over its last axis with fp32 statistics; ``rms_norm_bwd`` and
``layer_norm_bwd`` return ``dx`` and the weight gradients.  A CPU tensor
runs the plain version beside each; a CUDA tensor launches
``csrc/norm.cu`` or raises.  :class:`RMSNorm` and :class:`LayerNorm`
pair each forward with its backward as one ``torch.autograd.Function``
whose residuals are ``(x, gamma)``, as the reference's ``custom_vjp``.
"""
from __future__ import annotations

import torch

from ._build import KernelError, check_args, launch, route

__all__ = ["rms_norm", "layer_norm", "rms_norm_bwd", "layer_norm_bwd",
           "rms_norm_reference", "layer_norm_reference",
           "rms_norm_bwd_reference", "layer_norm_bwd_reference",
           "RMSNorm", "LayerNorm"]

BWD_ROWS_PER_BLOCK = 16   # kBwdRowsPerBlock of csrc/norm.cu


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


def rms_norm_bwd_reference(x, gamma, dy, eps=1e-6):
    """Plain PyTorch ``(dx, dgamma)`` of :func:`rms_norm`: with ``w = dy *
    gamma``, ``dx = r*w - r^3 * x * mean(w*x)``, ``dgamma = sum_rows dy *
    x * r``."""
    xf, g, d = x.float(), gamma.float(), dy.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    w = d * g
    dx = r * w - (r * r * r) * xf * torch.mean(w * xf, dim=-1, keepdim=True)
    dg = torch.sum(d * xf * r, dim=0)
    return dx.to(x.dtype), dg.to(gamma.dtype)


def layer_norm_bwd_reference(x, gamma, dy, eps=1e-5):
    """Plain PyTorch ``(dx, dgamma, dbeta)`` of :func:`layer_norm`: with
    ``w = dy * gamma``, ``dx = r * (w - mean(w) - xhat * mean(w *
    xhat))``, ``dgamma = sum_rows dy * xhat``, ``dbeta = sum_rows dy``."""
    xf, g, d = x.float(), gamma.float(), dy.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) * (xf - mu), dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    xhat = (xf - mu) * r
    w = d * g
    dx = r * (w - torch.mean(w, dim=-1, keepdim=True)
              - xhat * torch.mean(w * xhat, dim=-1, keepdim=True))
    return (dx.to(x.dtype), torch.sum(d * xhat, dim=0).to(gamma.dtype),
            torch.sum(d, dim=0).to(gamma.dtype))


def _check_rows(name, x, *vecs, like=()):
    if x.dim() != 2:
        raise KernelError("%s takes a 2D (rows, width) tensor, got shape %s"
                          % (name, tuple(x.shape)))
    check_args(name, x, *vecs, *like)
    for v in vecs:
        if v.shape != (x.shape[1],):
            raise KernelError("%s: parameter shape %s does not match width "
                              "%d" % (name, tuple(v.shape), x.shape[1]))
    for t in like:
        if t.shape != x.shape:
            raise KernelError("%s: gradient shape %s is not x's %s"
                              % (name, tuple(t.shape), tuple(x.shape)))


def rms_norm(x, gamma, eps=1e-6):
    """RMS normalisation of 2D ``x`` over its last axis, scaled by
    ``gamma``."""
    if not route("rms_norm", x):
        return rms_norm_reference(x, gamma, eps)
    _check_rows("rms_norm", x, gamma)
    y = torch.empty_like(x)
    launch(x, "rms_norm", "mxt_rms_norm_f32", x.data_ptr(),
           gamma.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
           float(eps))
    return y


def layer_norm(x, gamma, beta, eps=1e-5):
    """Layer normalisation of 2D ``x`` over its last axis with affine
    ``gamma``/``beta``."""
    if not route("layer_norm", x):
        return layer_norm_reference(x, gamma, beta, eps)
    _check_rows("layer_norm", x, gamma, beta)
    y = torch.empty_like(x)
    launch(x, "layer_norm", "mxt_layer_norm_f32", x.data_ptr(),
           gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), x.shape[0],
           x.shape[1], float(eps))
    return y


def _partials(x):
    nb = -(-x.shape[0] // BWD_ROWS_PER_BLOCK)
    return torch.empty(nb, x.shape[1], dtype=torch.float32, device=x.device)


def rms_norm_bwd(x, gamma, dy, eps=1e-6):
    """``(dx, dgamma)`` of :func:`rms_norm` for cotangent ``dy``.  The
    kernel writes per-block partial dgamma rows; they are summed here."""
    if not route("rms_norm_bwd", x):
        return rms_norm_bwd_reference(x, gamma, dy, eps)
    _check_rows("rms_norm_bwd", x, gamma, like=(dy,))
    dx, dgp = torch.empty_like(x), _partials(x)
    launch(x, "rms_norm_bwd", "mxt_rms_norm_bwd_f32", x.data_ptr(),
           gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(), dgp.data_ptr(),
           x.shape[0], x.shape[1], float(eps))
    return dx, torch.sum(dgp, dim=0)


def layer_norm_bwd(x, gamma, dy, eps=1e-5):
    """``(dx, dgamma, dbeta)`` of :func:`layer_norm` for cotangent
    ``dy``; per-block partials summed here."""
    if not route("layer_norm_bwd", x):
        return layer_norm_bwd_reference(x, gamma, dy, eps)
    _check_rows("layer_norm_bwd", x, gamma, like=(dy,))
    dx, dgp, dbp = torch.empty_like(x), _partials(x), _partials(x)
    launch(x, "layer_norm_bwd", "mxt_layer_norm_bwd_f32", x.data_ptr(),
           gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(), dgp.data_ptr(),
           dbp.data_ptr(), x.shape[0], x.shape[1], float(eps))
    return dx, torch.sum(dgp, dim=0), torch.sum(dbp, dim=0)


class RMSNorm(torch.autograd.Function):
    """``RMSNorm.apply(x, gamma, eps)`` on 2D ``x``: the forward kernel,
    and the backward kernel from the residuals ``(x, gamma)``."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return rms_norm(x, gamma, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dg = rms_norm_bwd(x, gamma, dy.contiguous(), ctx.eps)
        return dx, dg, None


class LayerNorm(torch.autograd.Function):
    """``LayerNorm.apply(x, gamma, beta, eps)`` on 2D ``x``: the forward
    kernel, and the backward kernel from the residuals ``(x, gamma)``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return layer_norm(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x, gamma, dy.contiguous(), ctx.eps)
        return dx, dg, db, None
