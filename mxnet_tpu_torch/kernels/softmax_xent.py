"""The SoftmaxOutput loss head: CUDA kernels and their plain versions.

Counterpart of ``softmax_output_head`` in
``mxnet_tpu/pallas_ops/softmax_xent.py``.  ``softmax_rows`` is the row
softmax of a 2D ``(rows, classes)`` fp32 tensor; ``xent_grad_from_probs``
is the implicit-loss gradient ``(p - onehot(label)) * scale`` with
float32 labels truncated to int32.  A CPU tensor runs the plain version
beside each; a CUDA tensor launches ``csrc/softmax_xent.cu`` or raises.
:class:`SoftmaxOutputHead` pairs them as one ``torch.autograd.Function``
with the reference's contract: the backward ignores the incoming
cotangent and gives the label no gradient.
"""
from __future__ import annotations

import torch

from ._build import KernelError, check_args, launch, route

__all__ = ["softmax_rows", "xent_grad_from_probs", "softmax_rows_reference",
           "xent_grad_from_probs_reference", "SoftmaxOutputHead",
           "softmax_output_head"]


def softmax_rows_reference(x):
    """Plain PyTorch ``e / sum(e)`` with ``e = exp(x - max(x))`` per
    row."""
    xf = x.float()
    e = torch.exp(xf - torch.amax(xf, dim=-1, keepdim=True))
    return (e / torch.sum(e, dim=-1, keepdim=True)).to(x.dtype)


def xent_grad_from_probs_reference(p, label, scale=1.0):
    """Plain PyTorch ``(p - onehot(int32(label))) * scale``."""
    lbl = label.reshape(-1, 1).to(torch.int32)
    cols = torch.arange(p.shape[1], dtype=torch.int32, device=p.device)
    onehot = (cols[None, :] == lbl).to(torch.float32)
    return ((p.float() - onehot) * scale).to(p.dtype)


def _check_2d(name, x):
    if x.dim() != 2:
        raise KernelError("%s takes a 2D (rows, classes) tensor, got shape "
                          "%s" % (name, tuple(x.shape)))


def softmax_rows(x):
    """Row softmax of 2D ``x``."""
    if not route("softmax_rows", x):
        return softmax_rows_reference(x)
    _check_2d("softmax_rows", x)
    check_args("softmax_rows", x)
    p = torch.empty_like(x)
    launch(x, "softmax_rows", "mxt_softmax_rows_f32", x.data_ptr(),
           p.data_ptr(), x.shape[0], x.shape[1])
    return p


def xent_grad_from_probs(p, label, scale=1.0):
    """``(p - onehot(label)) * scale`` for 2D probabilities ``p`` and a
    ``(rows,)`` float32 label vector."""
    if not route("xent_grad_from_probs", p):
        return xent_grad_from_probs_reference(p, label, scale)
    _check_2d("xent_grad_from_probs", p)
    check_args("xent_grad_from_probs", p, label)
    if label.shape != (p.shape[0],):
        raise KernelError("xent_grad_from_probs: label shape %s, want (%d,)"
                          % (tuple(label.shape), p.shape[0]))
    grad = torch.empty_like(p)
    launch(p, "xent_grad_from_probs", "mxt_xent_grad_from_probs_f32",
           p.data_ptr(), label.data_ptr(), grad.data_ptr(), p.shape[0],
           p.shape[1], float(scale))
    return grad


class SoftmaxOutputHead(torch.autograd.Function):
    """``SoftmaxOutputHead.apply(data, label, scale)``: forward the row
    softmax, backward ``(p - onehot(label)) * scale`` from the saved
    ``(p, label)`` whatever cotangent arrives; no gradient for the
    label."""

    @staticmethod
    def forward(ctx, data, label, scale):
        p = softmax_rows(data)
        ctx.save_for_backward(p, label)
        ctx.scale = scale
        return p

    @staticmethod
    def backward(ctx, _ignored):
        p, label = ctx.saved_tensors
        return xent_grad_from_probs(p, label, ctx.scale), None, None


def softmax_output_head(data, label, scale=1.0):
    """SoftmaxOutput's plain 2D head: probabilities forward, the implicit
    cross-entropy gradient backward."""
    return SoftmaxOutputHead.apply(data, label, float(scale))
