"""RMSNorm and LayerNorm, forward and backward: CUDA kernels and their
plain versions.

Counterpart of ``mxnet_tpu/pallas_ops/norm.py``.  ``rms_norm`` and
``layer_norm`` take a 2D ``(rows, width)`` fp32 or bf16 tensor (its
parameters in the same dtype) and normalise each row over its last axis
with fp32 statistics, writing the output in the input's dtype; the bf16
launches count as ``rms_norm_bf16`` and ``layer_norm_bf16``.
``rms_norm_bwd`` and ``layer_norm_bwd`` take the same dtypes and return
``dx`` in the input's dtype and the weight gradients in gamma's, summed
in fp32 and rounded once (the bf16 launches count as
``rms_norm_bwd_bf16`` and ``layer_norm_bwd_bf16``); :func:`_bwd_plan`
picks their kernel's path (v3, bf16 rows held packed; v2, the row in
registers; or v1, any row) and grid.  A CPU tensor runs the plain
version beside each; a CUDA tensor launches ``csrc/norm.cu`` or
raises.
:class:`RMSNorm` and :class:`LayerNorm` pair each forward with its
backward as one ``torch.autograd.Function`` whose residuals are ``(x,
gamma)``, as the reference's ``custom_vjp``.
"""
from __future__ import annotations

import collections

import torch

from ._build import SUFFIX as _FWD
from ._build import (KernelError, align_bytes, check_args, launch, route,
                     sm_count)

__all__ = ["rms_norm", "layer_norm", "rms_norm_bwd", "layer_norm_bwd",
           "rms_norm_reference", "layer_norm_reference",
           "rms_norm_bwd_reference", "layer_norm_bwd_reference",
           "RMSNorm", "LayerNorm"]

# the backward's paths (csrc/norm.cu): CTA warps, the widest v2 and v3
# row (32 lanes x 8 float4 chunks, or 4 chunks of 8 bf16, in registers),
# v1's rows a warp and most CTAs
BWD_WARPS = {"v1": 4, "v2": 8, "v3": 8}
BWD_V2_MAX_WIDTH = 1024
BWD_V1_ROWS_PER_WARP = 4
BWD_V1_MAX_CTAS = 1024
_BWD_PATH = {"v1": 0, "v2": 1, "v3": 2}   # the C entry points' path
BwdPlan = collections.namedtuple("BwdPlan", "path ctas rows_per_warp")


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


def _check_rows(name, x, *vecs, like=(), dtypes=(torch.float32,)):
    if x.dim() != 2:
        raise KernelError("%s takes a 2D (rows, width) tensor, got shape %s"
                          % (name, tuple(x.shape)))
    check_args(name, x, *vecs, *like, dtypes=dtypes)
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
    _check_rows("rms_norm", x, gamma, dtypes=tuple(_FWD))
    tag, sfx = _FWD[x.dtype]
    y = torch.empty_like(x)
    launch(x, "rms_norm" + tag, "mxt_rms_norm" + sfx, x.data_ptr(),
           gamma.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
           float(eps))
    return y


def layer_norm(x, gamma, beta, eps=1e-5):
    """Layer normalisation of 2D ``x`` over its last axis with affine
    ``gamma``/``beta``."""
    if not route("layer_norm", x):
        return layer_norm_reference(x, gamma, beta, eps)
    _check_rows("layer_norm", x, gamma, beta, dtypes=tuple(_FWD))
    tag, sfx = _FWD[x.dtype]
    y = torch.empty_like(x)
    launch(x, "layer_norm" + tag, "mxt_layer_norm" + sfx, x.data_ptr(),
           gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), x.shape[0],
           x.shape[1], float(eps))
    return y


# the bytes every row tensor's start is a multiple of, up to 16 (the
# widest chunk a backward path loads)
_bwd_align = align_bytes


def _v3_ctas_per_sm(width, layer):
    """v3's CTAs an SM (``v3_ctas_per_sm`` of csrc/norm.cu): two under a
    128-register cap for RMSNorm up to width 512; one for LayerNorm
    (``layer``), whose extra column sums spill under that cap, and for
    widths to 1024."""
    return 1 if layer or width > 512 else 2


def _bwd_path(width, align, dtype):
    """The norm backward's path for rows of ``width`` and ``dtype``
    (fp32 or bf16) whose tensors start on multiples of ``align`` bytes
    (:func:`_bwd_align`): ``"v3"`` (bf16 rows held packed) for bf16 rows
    of ``width <= 1024``, ``width % 8 == 0`` and 16-byte alignment;
    else ``"v2"`` (the row in registers, widened to fp32) for ``width <=
    1024``, ``width % 4 == 0`` and pointers on a 4-element chunk (16
    bytes fp32, 8 bf16); else ``"v1"``."""
    elem = torch.empty((), dtype=dtype).element_size()
    if width % 4 or width > BWD_V2_MAX_WIDTH or align % (4 * elem):
        return "v1"
    if dtype == torch.bfloat16 and width % 8 == 0 and align % 16 == 0:
        return "v3"
    return "v2"


def _bwd_grid(path, rows, width, sms, layer=False):
    """``path``'s launch on ``rows`` x ``width`` on a card of ``sms``
    SMs, for LayerNorm's backward if ``layer``, else RMSNorm's.  v3: one
    wave of :func:`_v3_ctas_per_sm` CTAs an SM; v2: one wave of one CTA
    an SM (at width 512 a v2 thread holds 144-169
    registers, so one 8-warp CTA fills an SM's register file); in both
    each warp takes as many rows as the wave needs.  v1: 4 rows a warp,
    more where the CTAs would pass ``BWD_V1_MAX_CTAS``.  Each CTA writes
    one partial weight-gradient row, which the entry point sums."""
    if path == "v3":
        max_ctas, min_rpw = _v3_ctas_per_sm(width, layer) * sms, 1
    elif path == "v2":
        max_ctas, min_rpw = sms, 1
    else:
        max_ctas, min_rpw = BWD_V1_MAX_CTAS, BWD_V1_ROWS_PER_WARP
    warps = BWD_WARPS[path]
    rpw = max(min_rpw, -(-rows // (warps * max_ctas)))
    ctas = -(-rows // (warps * rpw))
    return BwdPlan(path, ctas, rpw)


def _bwd_plan(rows, width, align, sms, dtype=torch.float32, layer=False):
    """The launch of a norm backward (LayerNorm's if ``layer``) on
    ``rows`` x ``width`` of ``dtype`` on a card of ``sms`` SMs, its row
    tensors on multiples of ``align`` bytes: :func:`_bwd_path`'s path on
    :func:`_bwd_grid`'s grid."""
    return _bwd_grid(_bwd_path(width, align, dtype), rows, width, sms,
                     layer)


def _bwd_launch(name, x, gamma, dy, eps, grads):
    """One launch of ``name``'s entry point: ``dx`` and the ``grads``
    (dgamma, or dgamma and dbeta) summed from per-CTA partial rows, all
    inside the entry point."""
    rows, width = x.shape
    dx = torch.empty_like(x)
    plan = _bwd_plan(rows, width, _bwd_align(x, gamma, dy, dx),
                     sm_count(x.device.index), x.dtype, grads == 2)
    outs = [torch.empty_like(gamma) for _ in range(grads)]
    parts = torch.empty(grads, plan.ctas, width, dtype=torch.float32,
                        device=x.device)
    tag, sfx = _FWD[x.dtype]
    launch(x, name + tag, "mxt_%s%s" % (name, sfx), x.data_ptr(),
           gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(),
           *(o.data_ptr() for o in outs), *(p.data_ptr() for p in parts),
           rows, width, float(eps), _BWD_PATH[plan.path],
           plan.rows_per_warp)
    return (dx, *outs)


def rms_norm_bwd(x, gamma, dy, eps=1e-6):
    """``(dx, dgamma)`` of :func:`rms_norm` for cotangent ``dy``."""
    if not route("rms_norm_bwd", x):
        return rms_norm_bwd_reference(x, gamma, dy, eps)
    _check_rows("rms_norm_bwd", x, gamma, like=(dy,), dtypes=tuple(_FWD))
    return _bwd_launch("rms_norm_bwd", x, gamma, dy, eps, 1)


def layer_norm_bwd(x, gamma, dy, eps=1e-5):
    """``(dx, dgamma, dbeta)`` of :func:`layer_norm` for cotangent
    ``dy``."""
    if not route("layer_norm_bwd", x):
        return layer_norm_bwd_reference(x, gamma, dy, eps)
    _check_rows("layer_norm_bwd", x, gamma, like=(dy,),
                dtypes=tuple(_FWD))
    return _bwd_launch("layer_norm_bwd", x, gamma, dy, eps, 2)


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
