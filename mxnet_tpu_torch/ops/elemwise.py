"""Elementwise operators (counterpart of ``mxnet_tpu/ops/elemwise.py``):
the unary math, ``smooth_l1``, the same-shape binary ops
(``elemwise_*``, ``_maximum``, ``_power``, ``_mod``, ...), the
broadcasting ``broadcast_*`` family, every ``*_scalar`` op, the
comparisons, the n-ary ``add_n``, ``Cast`` / ``cast``, and the
gradient-control ops ``BlockGrad`` / ``stop_gradient``, ``make_loss``
and ``MakeLoss``.

Each keeps the reference's result dtype: the comparisons between two
arrays (``broadcast_equal``, ``_greater``, ...) return float32 0/1,
those against a scalar (``_equal_scalar``, ...) ``x``'s dtype;
division of integers is true division (float32); ``_mod`` is the floor
modulo (``torch.remainder``), as ``jnp.mod``; ``gamma`` is
``exp(gammaln(x))``, the reference's formula, so it is positive for
negative ``x`` too.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import Dtype, Float, Int, Str, register, register_alias


# ---------------------------------------------------------------------------
# Unary math
# ---------------------------------------------------------------------------
def _unary(name, fn, aliases=(), doc=""):
    register(name, fcompute=lambda attrs, x: fn(x),
             doc=doc or "Elementwise `%s(x)`." % name.lstrip("_"))
    for a in aliases:
        register_alias(name, a)


def _float(x):
    return x if x.is_floating_point() else x.to(torch.float32)


def _cbrt(x):
    """The real cube root, sign and all (torch has no ``cbrt``)."""
    x = _float(x)
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


for _name, _fn in (
        ("relu", torch.relu), ("sigmoid", torch.sigmoid),
        ("softsign", lambda x: x / (torch.abs(x) + 1)),
        ("tanh", torch.tanh), ("negative", torch.neg), ("abs", torch.abs),
        ("sign", torch.sign), ("round", torch.round),
        ("rint", lambda x: torch.round(_float(x))),
        ("ceil", torch.ceil), ("floor", torch.floor), ("trunc", torch.trunc),
        ("fix", torch.trunc), ("square", torch.square),
        ("sqrt", torch.sqrt), ("rsqrt", torch.rsqrt), ("cbrt", _cbrt),
        ("rcbrt", lambda x: 1.0 / _cbrt(x)), ("exp", torch.exp),
        ("log", torch.log), ("log10", torch.log10), ("log2", torch.log2),
        ("log1p", torch.log1p), ("expm1", torch.expm1),
        ("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan),
        ("arcsin", torch.asin), ("arccos", torch.acos),
        ("arctan", torch.atan), ("sinh", torch.sinh), ("cosh", torch.cosh),
        ("arcsinh", torch.asinh), ("arccosh", torch.acosh),
        ("arctanh", torch.atanh), ("degrees", torch.rad2deg),
        ("radians", torch.deg2rad),
        ("gamma", lambda x: torch.exp(torch.lgamma(x))),
        ("gammaln", torch.lgamma), ("erf", torch.erf)):
    _unary(_name, _fn)
_unary("_copy", torch.clone, aliases=("identity",),
       doc="Elementwise identity copy.")


def _smooth_l1_fc(attrs, x):
    """``0.5 (s x)^2`` where ``|x| < 1/s^2``, else ``|x| - 0.5/s^2``;
    its gradient, ``s^2 x`` or ``sign(x)``, is autograd's of this
    formula, as the reference's is ``jax.vjp``'s."""
    s2 = attrs["scalar"] ** 2
    ax = torch.abs(x)
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)


register("smooth_l1", fcompute=_smooth_l1_fc, attrs={"scalar": Float(1.0)},
         doc="Smooth-L1 loss transform with sigma `scalar`.")


# ---------------------------------------------------------------------------
# Binary: same-shape (elemwise_*) and broadcasting (broadcast_*)
# ---------------------------------------------------------------------------
def _hypot(a, b):
    """``jnp.hypot``'s formula, ``hi * sqrt(1 + (lo / hi)^2)`` over the
    magnitudes, so a bf16 input rounds at the reference's steps;
    integers are promoted to float32 first."""
    a, b = torch.abs(_float(a)), torch.abs(_float(b))
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    zero = hi == 0
    out = torch.where(zero, hi, hi * torch.sqrt(
        1 + torch.square(lo / torch.where(zero, torch.ones_like(hi), hi))))
    return torch.where(torch.isinf(a) | torch.isinf(b),
                       torch.full_like(out, float("inf")), out)


def _logic(fn):
    return lambda a, b: fn(a, b).to(torch.float32)


# an integer base to a negative integer power is the truncated real
# power (0 but for bases 1 and -1), as MXNet's; the reference's XLA
# integer power is undefined there
_ARITH = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
          "div": torch.true_divide, "power": torch.pow,
          "maximum": torch.maximum, "minimum": torch.minimum,
          "hypot": _hypot, "mod": torch.remainder}
_COMPARE = {"equal": torch.eq, "not_equal": torch.ne,
            "greater": torch.gt, "greater_equal": torch.ge,
            "lesser": torch.lt, "lesser_equal": torch.le}


def _binary(name, fn, infer_shape=None, infer_type=None, doc=""):
    register(name, fcompute=lambda attrs, a, b: fn(a, b),
             arguments=("lhs", "rhs"), infer_shape=infer_shape,
             infer_type=infer_type,
             doc=doc or "Elementwise `%s(lhs, rhs)` on same-shape inputs."
             % name.lstrip("_"))


for _name in ("add", "sub", "mul", "div"):
    _binary("elemwise_" + _name, _ARITH[_name])
for _alias, _name in (("_plus", "add"), ("_add", "add"), ("_minus", "sub"),
                      ("_sub", "sub"), ("_mul", "mul"), ("_div", "div")):
    register_alias("elemwise_" + _name, _alias)
_binary("_grad_add", torch.add,
        doc="Gradient accumulation: `lhs + rhs` on same-shape inputs.")
for _name in ("maximum", "minimum", "power", "hypot", "mod"):
    _binary("_" + _name, _ARITH[_name])


def _broadcast_shape(lhs, rhs):
    try:
        return tuple(torch.broadcast_shapes(tuple(lhs), tuple(rhs)))
    except RuntimeError:
        raise MXNetError("incompatible broadcast shapes %s %s" % (lhs, rhs))


def _bcast_infer_shape(attrs, in_shapes):
    lhs, rhs = in_shapes
    if lhs is None or rhs is None:
        return in_shapes, [None], []
    return in_shapes, [_broadcast_shape(lhs, rhs)], []


def _float32_type(attrs, in_types):
    return in_types, ["float32"], []


for _name, _fn in _ARITH.items():
    _binary("broadcast_" + _name, _fn, infer_shape=_bcast_infer_shape,
            doc="Elementwise `%s(lhs, rhs)` with numpy-style broadcasting."
            % _name)
register_alias("broadcast_add", "broadcast_plus")
register_alias("broadcast_sub", "broadcast_minus")
# the comparisons return float32 0/1; the same-shape names are aliases,
# broadcasting subsumes the same-shape case
for _name, _fn in _COMPARE.items():
    _binary("broadcast_" + _name, _logic(_fn),
            infer_shape=_bcast_infer_shape, infer_type=_float32_type,
            doc="Elementwise `%s(lhs, rhs)` with numpy-style broadcasting; "
                "float32 0/1." % _name)
    register_alias("broadcast_" + _name, "_" + _name)


# ---------------------------------------------------------------------------
# Scalar binary
# ---------------------------------------------------------------------------
def _scalar(name, fn, doc):
    """A ``*_scalar`` op: the scalar is cast to ``x``'s dtype first, as
    the reference's ``jnp.asarray(scalar, dtype=x.dtype)`` (an int32
    ``x`` plus 2.7 adds 2 and stays int32).  The scalar is filled in on
    ``x``'s device, so no host copy waits for the device's queue."""
    register(name,
             fcompute=lambda attrs, x: fn(x, torch.full(
                 (), attrs["scalar"], dtype=torch.float64,
                 device=x.device).to(x.dtype)),
             attrs={"scalar": Float(required=True)}, doc=doc)


for _name in ("plus", "minus", "mul", "div", "power", "maximum", "minimum",
              "mod", "hypot"):
    _fn = _ARITH[{"plus": "add", "minus": "sub"}.get(_name, _name)]
    _scalar("_%s_scalar" % _name, _fn, "Elementwise `%s(x, scalar)`." % _name)
for _name in ("minus", "div", "power", "mod"):
    _fn = _ARITH[{"minus": "sub"}.get(_name, _name)]
    _scalar("_r%s_scalar" % _name, lambda x, s, f=_fn: f(s, x),
            "Elementwise `%s(scalar, x)`, the scalar on the left." % _name)
# against a scalar the comparisons keep x's dtype
for _name, _fn in _COMPARE.items():
    _scalar("_%s_scalar" % _name, lambda x, s, f=_fn: f(x, s).to(x.dtype),
            "Elementwise `%s(x, scalar)` as 0/1 in x's dtype." % _name)


# ---------------------------------------------------------------------------
# N-ary sum
# ---------------------------------------------------------------------------
def _sum_n(attrs, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


register("add_n", fcompute=_sum_n, arguments=("arg",),
         attrs={"num_args": Int(required=True)}, key_var_num_args="num_args",
         doc="Sum of `num_args` arrays, added left to right.")
register_alias("add_n", "ElementWiseSum")
register_alias("add_n", "_sum")


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
         infer_type=lambda attrs, ts: (ts, [attrs["dtype"]], []),
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
