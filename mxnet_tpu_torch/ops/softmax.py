"""Softmax operators (counterpart of ``mxnet_tpu/ops/softmax.py``):
the plain ``softmax`` / ``log_softmax`` / ``SoftmaxActivation``, the
``softmax_cross_entropy`` loss and the ``SoftmaxOutput`` head.

``softmax_cross_entropy(data, label)`` returns ``sum(loss)`` with shape
``(1,)`` in ``data``'s dtype.  Under the reference's kernel condition
(``data`` 2D, ``label`` 1D, at least two classes, a float dtype) it runs
:func:`~..kernels.softmax_xent.softmax_xent_loss`, per row
``logsumexp(x) - x[label]`` (a label outside the classes adds the row's
``logsumexp``: the kernel's rule), forward and gradient as kernels on a
CUDA tensor (fp32 or bf16 logits as they are, the label as float32;
the per-row loss is float32 and its sum is cast to ``data``'s dtype, as
the reference's ``jnp.sum(loss).astype(data.dtype)``; fp16 raises);
other shapes take the reference's plain formula
``-sum(onehot(label) * log_softmax(data))``.

``SoftmaxActivation`` and ``SoftmaxOutput`` (and its alias
``Softmax``) widen integer data to float32 first and give float32
probabilities, as the reference does.

``SoftmaxOutput``: softmax forward, implicit cross-entropy gradient
backward.  The backward ignores the incoming head gradient and emits
``softmax(x) - onehot(label)`` (times the normalisation and
``grad_scale``), the reference ``softmax_output.cc`` contract.  The
plain 2D head, under exactly the reference's conditions, goes to the
kernel pair of ``kernels/softmax_xent.py`` with ``normalization='batch'
|'valid'`` folded into its scale; the decorated configs
(``multi_output``, ``use_ignore``, ``smooth_alpha``, ``out_grad``,
``preserve_shape``) take :class:`_DecoratedSoftmaxOutput`, plain
PyTorch with the reference's backward formulas.

The regression heads ``LinearRegressionOutput`` (identity),
``LogisticRegressionOutput`` (sigmoid) and ``MAERegressionOutput``
(identity), ``SVMOutput`` (identity, hinge-loss gradient) and
``IdentityAttachKLSparseReg`` (identity plus a sparsity penalty's
gradient) are ``autograd.Function``s with the reference's
``custom_vjp`` formulas: the heads ignore the head gradient, and their
label gets a zero gradient.
"""
from __future__ import annotations

import torch

from ..kernels.softmax_xent import softmax_output_head, softmax_xent_loss
from .registry import Bool, Float, Int, Str, register, register_alias

_FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

register("softmax",
         fcompute=lambda attrs, x: torch.softmax(
             x / attrs["temperature"], dim=attrs["axis"]),
         attrs={"axis": Int(-1), "temperature": Float(1.0)},
         doc="Softmax over `axis` of `x / temperature`.")
register("log_softmax",
         fcompute=lambda attrs, x: torch.log_softmax(
             x / attrs["temperature"], dim=attrs["axis"]),
         attrs={"axis": Int(-1), "temperature": Float(1.0)},
         doc="Log-softmax over `axis` of `x / temperature`.")


def _widened(x):
    """Integer data as float32: the reference's ``jax.nn.softmax`` of an
    integer array gives float32 probabilities (``exp`` widens), and
    torch's softmax has no integer kernel."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _softmax_act_fc(attrs, x):
    x = _widened(x)
    if attrs["mode"] == "channel":
        return torch.softmax(x, dim=1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


register("SoftmaxActivation", fcompute=_softmax_act_fc,
         attrs={"mode": Str("instance")},
         doc="Softmax over each instance (all axes but the first) or "
             "over the channel axis.")


def _sce_fc(attrs, data, label):
    if (data.dim() == 2 and label.dim() == 1 and data.shape[1] >= 2
            and data.dtype in _FLOAT_DTYPES):
        loss = softmax_xent_loss(data.contiguous(),
                                 label.to(torch.float32).contiguous())
        return torch.sum(loss).to(data.dtype).reshape(1)
    logp = torch.log_softmax(data, dim=-1)
    onehot = _onehot(label, data.shape[-1], data.dtype)
    return torch.sum(-onehot * logp).reshape(1)


register("softmax_cross_entropy", fcompute=_sce_fc,
         arguments=("data", "label"),
         infer_shape=lambda attrs, ins: (ins, [(1,)], []),
         doc="Summed softmax cross entropy of `data` against integer "
             "`label`s, shape (1,).")


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
    data = _widened(data)
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
        return softmax_output_head(data.contiguous(),
                                   label.to(torch.float32).contiguous(),
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


# ---------------------------------------------------------------------------
# Regression heads
# ---------------------------------------------------------------------------
_REGRESSION = {
    # name: (forward, gradient of the output against the label)
    "LinearRegressionOutput": (lambda d: d.view_as(d), lambda o, l: o - l),
    "LogisticRegressionOutput": (torch.sigmoid, lambda o, l: o - l),
    "MAERegressionOutput": (lambda d: d.view_as(d),
                            lambda o, l: torch.sign(o - l)),
}


class _RegressionOutput(torch.autograd.Function):
    """``out = forward(data)``; the backward emits ``grad(out, label) *
    grad_scale / num_output``, ``num_output`` the elements of a row (the
    reference's ``regression_output-inl.h``)."""

    @staticmethod
    def forward(ctx, data, label, name, grad_scale):
        out = _REGRESSION[name][0](data)
        ctx.save_for_backward(out, label)
        ctx.name, ctx.grad_scale = name, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        num_output = max(out.numel() // out.shape[0], 1)
        grad = _REGRESSION[ctx.name][1](out, label.reshape(out.shape)) * \
            (ctx.grad_scale / num_output)
        return grad, torch.zeros_like(label), None, None


def _same_shape_label(attrs, in_shapes):
    if in_shapes[0] is not None:
        in_shapes[1] = in_shapes[0]
    return in_shapes, [in_shapes[0]], []


for _name in _REGRESSION:
    register(_name,
             fcompute=lambda attrs, d, l, n=_name: _RegressionOutput.apply(
                 d, l, n, attrs["grad_scale"]),
             arguments=("data", "label"), attrs={"grad_scale": Float(1.0)},
             infer_shape=_same_shape_label,
             doc="Regression head (%s); the label has the data's shape."
                 % _name[:-len("RegressionOutput")].lower())


class _SVMOutput(torch.autograd.Function):
    """Identity forward; the hinge loss's gradient against one-hot
    labels backward (the reference's ``svm_output.cc``: squared hinge,
    or linear with ``use_linear``)."""

    @staticmethod
    def forward(ctx, data, label, margin, reg_coef, use_linear):
        ctx.save_for_backward(data, label)
        ctx.cfg = (margin, reg_coef, use_linear)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        margin, reg_coef, use_linear = ctx.cfg
        onehot = _onehot(label, data.shape[-1], data.dtype)
        sign = torch.where(onehot > 0, -1.0, 1.0).to(data.dtype)
        viol = (margin + sign * data) > 0
        if use_linear:
            grad = torch.where(viol, sign * reg_coef, 0.0)
        else:
            grad = torch.where(
                viol, 2.0 * reg_coef * (margin + sign * data) * sign, 0.0)
        return (grad.to(data.dtype), torch.zeros_like(label), None, None,
                None)


register("SVMOutput",
         fcompute=lambda attrs, d, l: _SVMOutput.apply(
             d, l, attrs["margin"], attrs["regularization_coefficient"],
             attrs["use_linear"]),
         arguments=("data", "label"),
         attrs={"margin": Float(1.0), "regularization_coefficient": Float(1.0),
                "use_linear": Bool(False)},
         infer_shape=lambda attrs, ins: (
             [ins[0], None if ins[0] is None else (ins[0][0],)],
             [ins[0]], []),
         doc="Hinge-loss head over integer labels (one per row).")


class _KLSparseReg(torch.autograd.Function):
    """Identity forward; the backward adds the gradient of a KL penalty
    pulling each unit's mean sigmoid activation toward
    ``sparseness_target``."""

    @staticmethod
    def forward(ctx, data, sparseness_target, penalty):
        ctx.save_for_backward(data)
        ctx.cfg = (sparseness_target, penalty)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        (data,) = ctx.saved_tensors
        rho, penalty = ctx.cfg
        rho_hat = torch.mean(torch.sigmoid(data), dim=0, keepdim=True)
        grad_reg = penalty * (-rho / rho_hat + (1 - rho) / (1 - rho_hat))
        return g + grad_reg * torch.ones_like(data) / data.shape[0], None, \
            None


register("IdentityAttachKLSparseReg",
         fcompute=lambda attrs, x: _KLSparseReg.apply(
             x, attrs["sparseness_target"], attrs["penalty"]),
         attrs={"sparseness_target": Float(0.1), "penalty": Float(0.001),
                "momentum": Float(0.9)},
         doc="Identity with a KL sparsity penalty's gradient.")
