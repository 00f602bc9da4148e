"""Reduction operators (counterpart of ``mxnet_tpu/ops/reduce.py``):
``sum``/``sum_axis``, ``mean``, ``prod``, ``nansum``, ``nanprod``,
``max``/``max_axis``, ``min``/``min_axis`` over ``axis`` (all axes when
None; ``exclude`` reduces the others), ``norm`` (the L2 norm of every
element), ``argmax``/``argmin``/``argmax_channel`` with the reference's
float32 output, and ``broadcast_to`` / ``broadcast_axis``
(``broadcast_axes``)."""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import Bool, IntOrNone, Shape, register, register_alias


def _norm_axes(axis, ndim):
    if axis is None or axis == ():
        return tuple(range(ndim))
    if isinstance(axis, int):
        axis = (axis,)
    return tuple(a % ndim for a in axis)


def _reduce_out_shape(ds, axis, keepdims, exclude=False):
    axes = _norm_axes(axis, len(ds))
    if exclude:
        axes = tuple(i for i in range(len(ds)) if i not in axes)
    if keepdims:
        return tuple(1 if i in axes else d for i, d in enumerate(ds))
    return tuple(d for i, d in enumerate(ds) if i not in axes)


def _reduce_infer(attrs, in_shapes):
    (ds,) = in_shapes
    if ds is None:
        return in_shapes, [None], []
    out = _reduce_out_shape(ds, attrs["axis"], attrs["keepdims"],
                            attrs.get("exclude", False))
    return in_shapes, [out], []


# jnp's accumulation dtypes: a sum or product of a narrow signed int or
# of bool is int32, of a narrow unsigned int uint32
_ACC_DTYPES = {torch.bool: torch.int32, torch.int8: torch.int32,
               torch.int16: torch.int32, torch.uint8: torch.uint32,
               torch.uint16: torch.uint32}


def _int_reduce(reduce, x):
    """``reduce(x, dtype)`` of an integer or bool ``x`` in jnp's result
    dtype: accumulated in int64 (torch sums no uint32) and cast down,
    which wraps as an accumulation in the narrower type would."""
    return reduce(x, torch.int64).to(_ACC_DTYPES.get(x.dtype, x.dtype))


def _sum(x, axes, keepdim):
    def reduce(t, dtype=None):
        return torch.sum(t, dim=axes, keepdim=keepdim, dtype=dtype)
    return reduce(x) if x.is_floating_point() else _int_reduce(reduce, x)


def _nansum(x, axes, keepdim):
    if not x.is_floating_point():
        return _sum(x, axes, keepdim)
    return torch.nansum(x, dim=axes, keepdim=keepdim)


def _mean(x, axes, keepdim):
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x, dim=axes, keepdim=keepdim)


def _prod(x, axes, keepdim):
    # torch.prod takes one dim: move the reduced ones last and flatten
    rest = [i for i in range(x.dim()) if i not in axes]
    flat = x.permute(rest + list(axes)).reshape(
        [x.shape[i] for i in rest] + [-1])

    def reduce(t, dtype=None):
        return torch.prod(t, dim=-1, dtype=dtype)
    out = reduce(flat) if x.is_floating_point() else \
        _int_reduce(reduce, flat)
    if keepdim:
        out = out.reshape([1 if i in axes else d
                           for i, d in enumerate(x.shape)])
    return out


def _nanprod(x, axes, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), axes,
                 keepdim)


def _register_reduce(name, fn, aliases=()):
    def fc(attrs, x):
        axes = _norm_axes(attrs["axis"], x.dim())
        if attrs["exclude"]:
            axes = tuple(i for i in range(x.dim()) if i not in axes)
        if not axes:
            # no axis left: jnp's axis=() reduces nothing (torch's dim=()
            # would reduce all); a new unit axis gives the input in the
            # reduction's result dtype
            return fn(x[..., None], (x.dim(),), False)
        return fn(x, axes, attrs["keepdims"])

    register(name, fcompute=fc,
             attrs={"axis": Shape(None), "keepdims": Bool(False),
                    "exclude": Bool(False)},
             infer_shape=_reduce_infer,
             doc="`%s` over `axis` (all axes when None)." % name)
    for a in aliases:
        register_alias(name, a)


_register_reduce("sum", _sum, aliases=("sum_axis",))
_register_reduce("mean", _mean)
_register_reduce("prod", _prod)
_register_reduce("nansum", _nansum)
_register_reduce("nanprod", _nanprod)
_register_reduce("max", lambda x, a, k: torch.amax(x, dim=a, keepdim=k),
                 aliases=("max_axis",))
_register_reduce("min", lambda x, a, k: torch.amin(x, dim=a, keepdim=k),
                 aliases=("min_axis",))


def _arg_reduce_infer(attrs, in_shapes):
    (ds,) = in_shapes
    if ds is None:
        return in_shapes, [None], []
    ax = attrs["axis"]
    if ax is None:
        return in_shapes, [() if not attrs["keepdims"]
                           else (1,) * len(ds)], []
    return in_shapes, [_reduce_out_shape(ds, ax, attrs["keepdims"])], []


def _float32_type(attrs, in_types):
    return in_types, ["float32"], []


def _register_argreduce(name, fn):
    def fc(attrs, x):
        ax = attrs["axis"]
        if ax is None:
            res = fn(x.reshape(-1), dim=0)
            if attrs["keepdims"]:
                res = res.reshape((1,) * x.dim())
        else:
            res = fn(x, dim=ax, keepdim=attrs["keepdims"])
        return res.to(torch.float32)

    register(name, fcompute=fc,
             attrs={"axis": IntOrNone(None), "keepdims": Bool(False)},
             infer_shape=_arg_reduce_infer, infer_type=_float32_type,
             doc="Index of the %s along `axis` (float32)."
                 % name[3:].replace("max", "maximum").replace(
                     "min", "minimum"))


_register_argreduce("argmax", torch.argmax)
_register_argreduce("argmin", torch.argmin)

register("argmax_channel",
         fcompute=lambda attrs, x: torch.argmax(x, dim=1).to(torch.float32),
         infer_shape=lambda attrs, ins: (
             ins, [None if ins[0] is None else
                   (ins[0][0],) + tuple(ins[0][2:])], []),
         infer_type=_float32_type,
         doc="Index of the maximum along axis 1 (float32).")

register("norm",
         fcompute=lambda attrs, x: torch.sqrt(torch.sum(torch.square(x))),
         infer_shape=lambda attrs, ins: (ins, [()], []),
         doc="The L2 norm of all elements, shape ().")


def _broadcast_to_target(attrs, shape):
    return tuple(t if t != 0 else d for t, d in zip(attrs["shape"], shape))


def _broadcast_to_infer(attrs, in_shapes):
    (ds,) = in_shapes
    if ds is None:
        return in_shapes, [tuple(attrs["shape"])], []
    return in_shapes, [_broadcast_to_target(attrs, ds)], []


# broadcasts are materialised: an expanded view would share one element
# among many, which a later in-place write refuses
register("broadcast_to",
         fcompute=lambda attrs, x: x.expand(
             _broadcast_to_target(attrs, x.shape)).contiguous(),
         attrs={"shape": Shape(required=True)},
         infer_shape=_broadcast_to_infer,
         doc="Broadcast to `shape` (a 0 keeps the input's dimension).")


def _broadcast_axis_target(attrs, shape):
    tgt = list(shape)
    for a, size in zip(attrs["axis"], attrs["size"]):
        tgt[a] = size
    return tuple(tgt)


def _broadcast_axis_fc(attrs, x):
    for a in attrs["axis"]:
        if x.shape[a] != 1:
            raise MXNetError("broadcast_axis: axis %d must have size 1" % a)
    return x.expand(_broadcast_axis_target(attrs, x.shape)).contiguous()


register("broadcast_axis", fcompute=_broadcast_axis_fc,
         attrs={"axis": Shape(required=True), "size": Shape(required=True)},
         infer_shape=lambda attrs, ins: (
             ins, [None if ins[0] is None else
                   _broadcast_axis_target(attrs, ins[0])], []),
         doc="Broadcast the size-1 axes `axis` to `size`.")
register_alias("broadcast_axis", "broadcast_axes")
