"""Shape operators: ``Reshape`` with MXNet's special codes, and
``transpose`` (counterpart of ``mxnet_tpu/ops/tensor.py``)."""
from __future__ import annotations

import numpy as np

from .registry import Bool, Shape, register, register_alias

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
