"""``SoftmaxOutput``: softmax forward, implicit cross-entropy gradient
backward (counterpart of ``mxnet_tpu/ops/softmax.py``).

The backward ignores the incoming head gradient and emits
``softmax(x) - onehot(label)`` (times the normalisation and
``grad_scale``), the reference ``softmax_output.cc`` contract.  The
plain 2D head, under exactly the reference's conditions, goes to the
kernel pair of ``kernels/softmax_xent.py`` with ``normalization='batch'
|'valid'`` folded into its scale; the decorated configs
(``multi_output``, ``use_ignore``, ``smooth_alpha``, ``out_grad``,
``preserve_shape``) take :class:`_DecoratedSoftmaxOutput`, plain
PyTorch with the reference's backward formulas.
"""
from __future__ import annotations

import torch

from ..kernels.softmax_xent import softmax_output_head
from .registry import Bool, Float, Str, register, register_alias


def _softmax_value(cfg, data):
    multi_output, preserve_shape = cfg[2], cfg[4]
    if not multi_output and data.dim() > 2 and not preserve_shape:
        return torch.softmax(data.reshape(data.shape[0], -1),
                             dim=-1).reshape(data.shape)
    return torch.softmax(data, dim=1 if multi_output else -1)


def _onehot(label, num_class, dtype):
    """One-hot rows of int32(label); a label outside [0, num_class) (the
    ignore label) gives a zero row, as ``jax.nn.one_hot``."""
    cols = torch.arange(num_class, dtype=torch.int32, device=label.device)
    return (label.to(torch.int32).unsqueeze(-1) == cols).to(dtype)


class _DecoratedSoftmaxOutput(torch.autograd.Function):
    """SoftmaxOutput's configs beyond the plain 2D head."""

    @staticmethod
    def forward(ctx, data, label, cfg):
        prob = _softmax_value(cfg, data)
        ctx.save_for_backward(prob, label)
        ctx.cfg = cfg
        return prob

    @staticmethod
    def backward(ctx, g):
        prob, label = ctx.saved_tensors
        (grad_scale, ignore_label, multi_output, use_ignore, _,
         normalization, out_grad, smooth_alpha) = ctx.cfg
        if multi_output:
            # data (n, c, d1...), label (n, prod(d1...)) or (n, d1...)
            num_class = prob.shape[1]
            lbl = label.reshape((label.shape[0],) + prob.shape[2:])
            onehot = _onehot(lbl, num_class, prob.dtype).movedim(-1, 1)
        else:
            num_class = prob.shape[-1]
            onehot = _onehot(label, num_class, prob.dtype).reshape(
                prob.shape)
        if smooth_alpha:
            # the target becomes 1 - alpha, the other classes alpha/(k-1)
            onehot = (onehot * (1.0 - smooth_alpha)
                      + (1.0 - onehot) * (smooth_alpha / (num_class - 1)))
        grad = prob - onehot
        if out_grad:
            grad = grad * g
        if use_ignore:
            if multi_output:
                mask = (lbl != ignore_label).to(prob.dtype)
                grad = grad * mask.unsqueeze(1)
            else:
                mask = (label != ignore_label).to(prob.dtype)
                grad = grad * mask.reshape(mask.shape +
                                           (1,) * (grad.dim() - mask.dim()))
        if normalization == "batch":
            grad = grad / prob.shape[0]
        elif normalization == "valid" and use_ignore:
            valid = torch.clamp(torch.sum(label != ignore_label), min=1)
            grad = grad / valid.to(grad.dtype)
        elif normalization == "valid":
            grad = grad / float(label.numel())
        return grad * grad_scale, None, None


def _softmax_output_fc(attrs, data, label):
    if (data.dim() == 2 and label.dim() == 1
            and not attrs["multi_output"] and not attrs["use_ignore"]
            and not attrs["preserve_shape"] and not attrs["out_grad"]
            and attrs["smooth_alpha"] == 0.0
            and attrs["normalization"] in ("null", "batch", "valid")):
        scale = attrs["grad_scale"]
        if attrs["normalization"] in ("batch", "valid"):
            # without use_ignore, valid-normalization divides by
            # label.size == rows for a 2D head
            scale = scale / data.shape[0]
        return softmax_output_head(data.contiguous(), label.contiguous(),
                                   scale)
    cfg = (attrs["grad_scale"], attrs["ignore_label"], attrs["multi_output"],
           attrs["use_ignore"], attrs["preserve_shape"],
           attrs["normalization"], attrs["out_grad"], attrs["smooth_alpha"])
    return _DecoratedSoftmaxOutput.apply(data, label, cfg)


def _softmax_output_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None], []
    if attrs["multi_output"]:
        rest = 1
        for d in ds[2:]:
            rest *= d
        in_shapes[1] = (ds[0], rest)
    else:
        in_shapes[1] = (ds[0],)
    return in_shapes, [ds], []


register("SoftmaxOutput", fcompute=_softmax_output_fc,
         arguments=("data", "label"),
         attrs={"grad_scale": Float(1.0), "ignore_label": Float(-1.0),
                "multi_output": Bool(False), "use_ignore": Bool(False),
                "preserve_shape": Bool(False),
                "normalization": Str("null"),
                "out_grad": Bool(False), "smooth_alpha": Float(0.0)},
         infer_shape=_softmax_output_infer,
         doc="Softmax forward; backward emits the softmax-cross-entropy "
             "gradient w.r.t. data (reference softmax_output.cc).")
register_alias("SoftmaxOutput", "Softmax")
