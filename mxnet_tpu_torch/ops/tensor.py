"""Matrix and shape operators (counterpart of
``mxnet_tpu/ops/tensor.py``): ``Reshape`` with MXNet's special codes,
``Flatten``, ``transpose``, ``expand_dims``, ``SwapAxis``, ``slice`` /
``crop``, ``slice_axis``, ``dot``, ``batch_dot``, ``clip``, ``repeat``,
``tile``, ``reverse`` / ``flip``, ``where``, ``Concat`` (variadic),
``SliceChannel`` / ``split`` (``num_outputs`` outputs) and ``Pad``.

``dot`` and ``batch_dot`` are plain products (the reference's are XLA's,
outside any Pallas kernel); fp32 products run without TF32, PyTorch's
default.  ``dot``'s ``transpose_a`` / ``transpose_b`` reverse every axis
of an N-d operand, as the reference's ``.T``, and beyond two dimensions
the product contracts the last axis of ``lhs`` with the first of
``rhs`` (``tensordot(axes=1)``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import (Bool, Float, Int, IntOrNone, Shape, Str, register,
                       register_alias)

__all__ = ["infer_reshape_shape"]


def infer_reshape_shape(data_shape, target):
    """Target shape of ``Reshape``, with the reference's special codes:
    0 copies the input dimension, -1 infers one dimension, -2 copies all
    remaining dimensions, -3 merges two input dimensions, -4 splits one
    into the next two target values (either may be -1)."""
    out = []
    src = list(data_shape)
    i = 0
    k = 0
    while k < len(target):
        d = target[k]
        if d == 0:
            out.append(src[i])
            i += 1
        elif d == -1:
            out.append(-1)
            i += 1
        elif d == -2:
            out.extend(src[i:])
            i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif d == -4:
            a, b = target[k + 1], target[k + 2]
            cur = src[i]
            i += 1
            if a == -1:
                a = cur // b
            if b == -1:
                b = cur // a
            out.extend([a, b])
            k += 2
        else:
            out.append(d)
            i += 1
        k += 1
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1]))
        total = int(np.prod(data_shape))
        out[out.index(-1)] = total // max(known, 1)
    return tuple(out)


def _target(attrs, shape):
    if attrs["reverse"]:
        return infer_reshape_shape(tuple(shape)[::-1],
                                   tuple(attrs["shape"])[::-1])[::-1]
    return infer_reshape_shape(tuple(shape), attrs["shape"])


def _reshape_infer(attrs, in_shapes):
    (ds,) = in_shapes
    if ds is None:
        return in_shapes, [None], []
    return in_shapes, [_target(attrs, ds)], []


register("Reshape",
         fcompute=lambda attrs, x: x.reshape(_target(attrs, x.shape)),
         attrs={"shape": Shape(required=True), "reverse": Bool(False)},
         infer_shape=_reshape_infer)
register_alias("Reshape", "reshape")


def _axes(attrs, ndim):
    return attrs["axes"] if attrs["axes"] else tuple(reversed(range(ndim)))


def _transpose_infer(attrs, in_shapes):
    (ds,) = in_shapes
    if ds is None:
        return in_shapes, [None], []
    return in_shapes, [tuple(ds[a] for a in _axes(attrs, len(ds)))], []


register("transpose",
         fcompute=lambda attrs, x: x.permute(_axes(attrs, x.dim())),
         attrs={"axes": Shape(())}, infer_shape=_transpose_infer)


def _flatten_infer(attrs, in_shapes):
    (ds,) = in_shapes
    if ds is None:
        return in_shapes, [None], []
    return in_shapes, [(ds[0], int(np.prod(ds[1:])) if len(ds) > 1 else 1)], []


register("Flatten", fcompute=lambda attrs, x: x.reshape(x.shape[0], -1),
         infer_shape=_flatten_infer,
         doc="Collapse every axis after the first: (d0, d1*...*dn).")
register_alias("Flatten", "flatten")


def _expand_dims_infer(attrs, in_shapes):
    (ds,) = in_shapes
    if ds is None:
        return in_shapes, [None], []
    ax = attrs["axis"]
    if ax < 0:
        ax += len(ds) + 1
    return in_shapes, [tuple(ds[:ax]) + (1,) + tuple(ds[ax:])], []


register("expand_dims", fcompute=lambda attrs, x: x.unsqueeze(attrs["axis"]),
         attrs={"axis": Int(required=True)}, infer_shape=_expand_dims_infer,
         doc="A size-1 axis inserted at `axis`.")


def _swapaxis_infer(attrs, in_shapes):
    (ds,) = in_shapes
    if ds is None:
        return in_shapes, [None], []
    s = list(ds)
    a, b = attrs["dim1"], attrs["dim2"]
    s[a], s[b] = s[b], s[a]
    return in_shapes, [tuple(s)], []


register("SwapAxis",
         fcompute=lambda attrs, x: x.transpose(attrs["dim1"], attrs["dim2"]),
         attrs={"dim1": Int(0), "dim2": Int(0)}, infer_shape=_swapaxis_infer,
         doc="Swap axes `dim1` and `dim2`.")
register_alias("SwapAxis", "swapaxes")


# ---------------------------------------------------------------------------
# Slicing
# ---------------------------------------------------------------------------
def _norm_slice(begin, end, shape):
    idx = []
    for i, dim in enumerate(shape):
        b = begin[i] if i < len(begin) and begin[i] is not None else 0
        e = end[i] if i < len(end) and end[i] is not None else dim
        idx.append(slice(b, e))
    return tuple(idx)


def _slice_infer(attrs, in_shapes):
    (ds,) = in_shapes
    if ds is None:
        return in_shapes, [None], []
    idx = _norm_slice(attrs["begin"], attrs["end"], ds)
    out = tuple(len(range(*s.indices(d))) for s, d in zip(idx, ds))
    return in_shapes, [out], []


register("slice",
         fcompute=lambda attrs, x: x[
             _norm_slice(attrs["begin"], attrs["end"], x.shape)],
         attrs={"begin": Shape(required=True), "end": Shape(required=True)},
         infer_shape=_slice_infer,
         doc="`x[begin:end]` over the leading axes (Python's rules for "
             "negative bounds).")
register_alias("slice", "crop")


def _slice_axis_bounds(attrs, dim):
    end = attrs["end"] if attrs["end"] is not None else dim
    return slice(attrs["begin"], end)


def _slice_axis_infer(attrs, in_shapes):
    (ds,) = in_shapes
    if ds is None:
        return in_shapes, [None], []
    ax = attrs["axis"] % len(ds)
    s = list(ds)
    s[ax] = len(range(*_slice_axis_bounds(attrs, ds[ax]).indices(ds[ax])))
    return in_shapes, [tuple(s)], []


def _slice_axis_fc(attrs, x):
    ax = attrs["axis"] % x.dim()
    idx = [slice(None)] * x.dim()
    idx[ax] = _slice_axis_bounds(attrs, x.shape[ax])
    return x[tuple(idx)]


register("slice_axis", fcompute=_slice_axis_fc,
         attrs={"axis": Int(required=True), "begin": Int(required=True),
                "end": IntOrNone(None)},
         infer_shape=_slice_axis_infer,
         doc="`[begin, end)` along `axis` (`end` None: to the end).")


# ---------------------------------------------------------------------------
# dot / batch_dot
# ---------------------------------------------------------------------------
def _reversed_axes(t):
    return t.permute(tuple(reversed(range(t.dim()))))


def _dot_fc(attrs, a, b):
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    a2 = _reversed_axes(a) if attrs["transpose_a"] else a
    b2 = _reversed_axes(b) if attrs["transpose_b"] else b
    if a2.dim() <= 2 and b2.dim() <= 2:
        return torch.matmul(a2, b2)
    return torch.tensordot(a2, b2, dims=1)


def _dot_infer(attrs, in_shapes):
    sa, sb = in_shapes
    if sa is None or sb is None:
        return in_shapes, [None], []
    if len(sa) == 1 and len(sb) == 1:
        return in_shapes, [()], []
    a = tuple(reversed(sa)) if attrs["transpose_a"] else tuple(sa)
    b = tuple(reversed(sb)) if attrs["transpose_b"] else tuple(sb)
    return in_shapes, [a[:-1] + b[1:]], []


register("dot", fcompute=_dot_fc, arguments=("lhs", "rhs"),
         attrs={"transpose_a": Bool(False), "transpose_b": Bool(False)},
         infer_shape=_dot_infer,
         doc="Matrix product; a transposed operand has all its axes "
             "reversed.")


def _batch_dot_fc(attrs, a, b):
    a2 = a.transpose(-1, -2) if attrs["transpose_a"] else a
    b2 = b.transpose(-1, -2) if attrs["transpose_b"] else b
    return torch.matmul(a2, b2)


def _batch_dot_infer(attrs, in_shapes):
    sa, sb = in_shapes
    if sa is None or sb is None:
        return in_shapes, [None], []
    a = (sa[0], sa[2], sa[1]) if attrs["transpose_a"] else tuple(sa)
    b = (sb[0], sb[2], sb[1]) if attrs["transpose_b"] else tuple(sb)
    return in_shapes, [(a[0], a[1], b[2])], []


register("batch_dot", fcompute=_batch_dot_fc, arguments=("lhs", "rhs"),
         attrs={"transpose_a": Bool(False), "transpose_b": Bool(False)},
         infer_shape=_batch_dot_infer,
         doc="Batched matrix product of (B, M, K) and (B, K, N).")


# ---------------------------------------------------------------------------
# clip / repeat / tile / reverse / where
# ---------------------------------------------------------------------------
register("clip",
         fcompute=lambda attrs, x: torch.clamp(x, attrs["a_min"],
                                               attrs["a_max"]),
         attrs={"a_min": Float(required=True), "a_max": Float(required=True)},
         doc="Clamp every element into `[a_min, a_max]`.")


def _repeat_infer(attrs, in_shapes):
    (ds,) = in_shapes
    if ds is None:
        return in_shapes, [None], []
    r, ax = attrs["repeats"], attrs["axis"]
    if ax is None:
        return in_shapes, [(int(np.prod(ds)) * r,)], []
    s = list(ds)
    s[ax] *= r
    return in_shapes, [tuple(s)], []


register("repeat",
         fcompute=lambda attrs, x: torch.repeat_interleave(
             x, attrs["repeats"], dim=attrs["axis"]),
         attrs={"repeats": Int(required=True), "axis": IntOrNone(None)},
         infer_shape=_repeat_infer,
         doc="Repeat each element `repeats` times along `axis` (the "
             "flattened array when None).")


def _tile_infer(attrs, in_shapes):
    (ds,) = in_shapes
    if ds is None:
        return in_shapes, [None], []
    reps = attrs["reps"]
    nd = max(len(ds), len(reps))
    s = (1,) * (nd - len(ds)) + tuple(ds)
    r = (1,) * (nd - len(reps)) + tuple(reps)
    return in_shapes, [tuple(a * b for a, b in zip(s, r))], []


register("tile", fcompute=lambda attrs, x: torch.tile(x, attrs["reps"]),
         attrs={"reps": Shape(required=True)}, infer_shape=_tile_infer,
         doc="The array repeated `reps` times along each axis.")
register("reverse",
         fcompute=lambda attrs, x: torch.flip(x, attrs["axis"]),
         attrs={"axis": Shape(required=True)},
         doc="Reverse the order of the elements along `axis`.")
register_alias("reverse", "flip")


def _where_infer(attrs, in_shapes):
    cond, x, y = in_shapes
    s = x if x is not None else y
    return [cond if cond is not None else s, s, s], [s], []


def _where_fc(attrs, c, x, y):
    c = c.to(torch.bool)
    return torch.where(c.reshape(c.shape + (1,) * (x.dim() - c.dim())), x, y)


register("where", fcompute=_where_fc, arguments=("condition", "x", "y"),
         infer_shape=_where_infer,
         doc="`x` where `condition` is nonzero, else `y`; a condition of "
             "fewer axes selects whole leading slices.")


# ---------------------------------------------------------------------------
# Concat / SliceChannel
# ---------------------------------------------------------------------------
def _concat_infer(attrs, in_shapes):
    if any(s is None for s in in_shapes):
        return in_shapes, [None], []
    dim = attrs["dim"]
    out = list(in_shapes[0])
    out[dim] = sum(s[dim] for s in in_shapes)
    return in_shapes, [tuple(out)], []


register("Concat",
         fcompute=lambda attrs, *xs: torch.cat(xs, dim=attrs["dim"]),
         arguments=("arg",), key_var_num_args="num_args",
         attrs={"num_args": Int(required=True), "dim": Int(1)},
         infer_shape=_concat_infer,
         doc="Join `num_args` arrays along `dim`.")
register_alias("Concat", "concat")


def _slice_channel_infer(attrs, in_shapes):
    (ds,) = in_shapes
    n = attrs["num_outputs"]
    if ds is None:
        return in_shapes, [None] * n, []
    ax = attrs["axis"]
    s = list(ds)
    if s[ax] % n != 0:
        raise MXNetError("SliceChannel: dim %d not divisible by %d"
                         % (s[ax], n))
    s[ax] //= n
    if attrs["squeeze_axis"]:
        s.pop(ax)
    return in_shapes, [tuple(s)] * n, []


def _slice_channel_infer_backward(attrs, out_shapes, in_shapes):
    known = [o for o in out_shapes if o is not None]
    if known and not attrs["squeeze_axis"]:
        s = list(known[0])
        s[attrs["axis"]] *= attrs["num_outputs"]
        in_shapes[0] = tuple(s)
    return in_shapes


def _slice_channel_fc(attrs, x):
    ax, n = attrs["axis"], attrs["num_outputs"]
    if x.shape[ax] % n:
        raise MXNetError("SliceChannel: dim %d not divisible by %d"
                         % (x.shape[ax], n))
    parts = torch.split(x, x.shape[ax] // n, dim=ax)
    if attrs["squeeze_axis"]:
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts)


register("SliceChannel", fcompute=_slice_channel_fc,
         attrs={"num_outputs": Int(required=True), "axis": Int(1),
                "squeeze_axis": Bool(False)},
         outputs=lambda attrs: ["output%d" % i
                                for i in range(attrs["num_outputs"])],
         num_outputs=lambda attrs: attrs["num_outputs"],
         infer_shape=_slice_channel_infer,
         infer_shape_backward=_slice_channel_infer_backward,
         doc="Split `axis` into `num_outputs` equal parts, one output "
             "each.")
register_alias("SliceChannel", "split")


# ---------------------------------------------------------------------------
# Pad
# ---------------------------------------------------------------------------
def _pad_widths(pad_width, ndim):
    pw = list(pad_width)
    return tuple((pw[2 * i], pw[2 * i + 1]) for i in range(ndim))


def _pad_fc(attrs, x):
    """``jnp.pad`` in ``constant``, ``edge`` or ``reflect`` mode.  torch
    pads the trailing axes, from the last one: ``edge`` and ``reflect``
    take 4-D or 5-D input with the batch and channel axes unpadded, as
    the reference's ``Pad``."""
    mode = attrs["mode"]
    widths = _pad_widths(attrs["pad_width"], x.dim())
    if mode == "constant":
        flat = [w for pair in reversed(widths) for w in pair]
        return F.pad(x, flat, value=attrs["constant_value"])
    if mode not in ("edge", "reflect"):
        raise MXNetError("Pad: unknown mode %r" % mode)
    if x.dim() not in (4, 5) or any(widths[0]) or any(widths[1]):
        raise MXNetError("Pad: mode %r pads the spatial axes of a 4-D or "
                         "5-D input only" % mode)
    flat = [w for pair in reversed(widths[2:]) for w in pair]
    return F.pad(x, flat, mode="replicate" if mode == "edge" else "reflect")


def _pad_infer(attrs, in_shapes):
    (ds,) = in_shapes
    if ds is None:
        return in_shapes, [None], []
    widths = _pad_widths(attrs["pad_width"], len(ds))
    return in_shapes, [tuple(d + a + b
                             for d, (a, b) in zip(ds, widths))], []


register("Pad", fcompute=_pad_fc,
         attrs={"mode": Str("constant"), "pad_width": Shape(required=True),
                "constant_value": Float(0.0)},
         infer_shape=_pad_infer,
         doc="Pad with `pad_width` (before, after) pairs per axis: a "
             "constant, the edge values or a reflection.")
register_alias("Pad", "pad")
