"""Elementwise operators (counterpart of ``mxnet_tpu/ops/elemwise.py``):
``elemwise_add`` and ``_plus_scalar``, which ``Symbol.__add__`` emits,
unary math, ``Cast`` / ``cast``, and the gradient-control ops
``BlockGrad`` / ``stop_gradient``, ``make_loss`` and ``MakeLoss``."""
from __future__ import annotations

import torch

from .registry import Dtype, Float, Str, register, register_alias

register("elemwise_add", fcompute=lambda attrs, a, b: torch.add(a, b),
         arguments=("lhs", "rhs"),
         doc="Elementwise `add(lhs, rhs)` on same-shape inputs.")
register_alias("elemwise_add", "_plus")
register_alias("elemwise_add", "_add")


def _scalar(name, fn, doc):
    """A ``*_scalar`` op: the scalar is cast to ``x``'s dtype first, as
    the reference's ``jnp.asarray(scalar, dtype=x.dtype)`` (an int32
    ``x`` plus 2.7 adds 2 and stays int32)."""
    register(name,
             fcompute=lambda attrs, x: fn(x, torch.tensor(
                 attrs["scalar"], dtype=torch.float64).to(x.dtype)),
             attrs={"scalar": Float(required=True)}, doc=doc)


_scalar("_plus_scalar", torch.add, "Elementwise `add(x, scalar)`.")


def _unary(name, fn):
    register(name, fcompute=lambda attrs, x: fn(x),
             doc="Elementwise `%s(x)`." % name)


for _name, _fn in (("relu", torch.relu), ("sigmoid", torch.sigmoid),
                   ("tanh", torch.tanh), ("negative", torch.neg),
                   ("abs", torch.abs), ("square", torch.square),
                   ("sqrt", torch.sqrt), ("exp", torch.exp),
                   ("log", torch.log), ("sin", torch.sin),
                   ("cos", torch.cos)):
    _unary(_name, _fn)


def saturating_cast(x, dtype):
    """A copy of ``x`` in ``dtype``.  From a floating ``x`` to an integer
    ``dtype`` it saturates, as the reference's XLA convert does:
    truncated toward zero, clamped to the dtype's range, NaN to 0
    (PyTorch's own conversion wraps there, or gives the dtype's minimum
    for what it cannot hold).  The arithmetic runs in float64, which
    holds every int32 bound exactly; int64's top, 2**63 - 1, is set
    apart.  Every other pair of dtypes converts as ``Tensor.to``."""
    if not x.is_floating_point() or dtype.is_floating_point or \
            dtype.is_complex or dtype == torch.bool:
        return x.to(dtype, copy=True)
    info = torch.iinfo(dtype)
    t = torch.nan_to_num(torch.trunc(x.detach().double()), nan=0.0)
    out = t.clamp(info.min, info.max).to(dtype)
    if info.max >= 2 ** 53:
        out = torch.where(t >= float(info.max), info.max, out)
    return out


# the recorded cast (NDArray.astype is a copy outside the tape); its
# backward casts the cotangent back to the input's dtype, so an fp32
# leaf cast to bf16 gets an fp32 gradient
register("Cast",
         fcompute=lambda attrs, x: saturating_cast(
             x, getattr(torch, attrs["dtype"])),
         attrs={"dtype": Dtype(required=True)},
         doc="Cast `data` to `dtype`; the gradient is cast back to the "
             "input's dtype.")
register_alias("Cast", "cast")


register("BlockGrad", fcompute=lambda attrs, x: x.detach(),
         doc="Output = input; the gradient is blocked.")
register_alias("BlockGrad", "stop_gradient")


class _MakeLoss(torch.autograd.Function):
    """Identity forward; the backward ignores the head gradient and
    emits ``scale * ones`` (the reference's make_loss-inl.h)."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, head):
        one = torch.ones((), dtype=head.dtype, device=head.device)
        return (one * ctx.scale).expand(head.shape), None


register("make_loss",
         fcompute=lambda attrs, x: _MakeLoss.apply(x, attrs["grad_scale"]),
         attrs={"grad_scale": Float(1.0)},
         doc="Treat the input as a loss head: the backward emits "
             "grad_scale * ones.")


def _make_loss_layer_fc(attrs, data):
    """``MakeLoss`` with ``normalization``: ``batch`` divides the scale
    by the batch size, ``valid`` by the count of elements whose
    magnitude exceeds ``valid_thresh`` (at least 1)."""
    scale = attrs["grad_scale"]
    norm = attrs["normalization"]
    if norm == "batch":
        scale = scale / data.shape[0]
    elif norm == "valid":
        valid = torch.sum(torch.abs(data.detach()) > attrs["valid_thresh"])
        scale = scale / torch.clamp(valid, min=1).to(data.dtype)
    return _MakeLoss.apply(data, scale)


register("MakeLoss", fcompute=_make_loss_layer_fc,
         attrs={"grad_scale": Float(1.0), "valid_thresh": Float(0.0),
                "normalization": Str("null")},
         doc="Loss-head layer with batch/valid normalization.")
