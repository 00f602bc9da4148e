"""Reduction operators (counterpart of ``mxnet_tpu/ops/reduce.py``):
``sum``/``sum_axis``, ``mean``, ``prod``, ``nansum``, ``nanprod``,
``max``/``max_axis``, ``min``/``min_axis`` over ``axis`` (all axes when
None; ``exclude`` reduces the others), and ``argmax``/``argmin`` with the
reference's float32 output."""
from __future__ import annotations

import torch

from .registry import Bool, Shape, register, register_alias, AttrSpec


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


def _int_dtype(x):
    # integer sums and products stay in their dtype, as jnp's
    return None if x.is_floating_point() else x.dtype


def _sum(x, axes, keepdim):
    return torch.sum(x, dim=axes, keepdim=keepdim, dtype=_int_dtype(x))


def _mean(x, axes, keepdim):
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x, dim=axes, keepdim=keepdim)


def _prod(x, axes, keepdim):
    # torch.prod takes one dim: move the reduced ones last and flatten
    rest = [i for i in range(x.dim()) if i not in axes]
    flat = x.permute(rest + list(axes)).reshape(
        [x.shape[i] for i in rest] + [-1])
    out = torch.prod(flat, dim=-1, dtype=_int_dtype(x))
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
_register_reduce("nansum", lambda x, a, k: torch.nansum(
    x, dim=a, keepdim=k, dtype=_int_dtype(x)))
_register_reduce("nanprod", _nanprod)
_register_reduce("max", lambda x, a, k: torch.amax(x, dim=a, keepdim=k),
                 aliases=("max_axis",))
_register_reduce("min", lambda x, a, k: torch.amin(x, dim=a, keepdim=k),
                 aliases=("min_axis",))


def _parse_int_or_none(v):
    if v is None or v == "None":
        return None
    return int(v)


def _arg_reduce_infer(attrs, in_shapes):
    (ds,) = in_shapes
    if ds is None:
        return in_shapes, [None], []
    ax = attrs["axis"]
    if ax is None:
        return in_shapes, [() if not attrs["keepdims"]
                           else (1,) * len(ds)], []
    return in_shapes, [_reduce_out_shape(ds, ax, attrs["keepdims"])], []


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
             attrs={"axis": AttrSpec(_parse_int_or_none, None, False),
                    "keepdims": Bool(False)},
             infer_shape=_arg_reduce_infer,
             doc="Index of the %s along `axis` (float32)."
                 % name[3:].replace("max", "maximum").replace(
                     "min", "minimum"))


_register_argreduce("argmax", torch.argmax)
_register_argreduce("argmin", torch.argmin)
