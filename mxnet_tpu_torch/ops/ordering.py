"""Ordering operators (counterpart of ``mxnet_tpu/ops/ordering.py``):
``sort``, ``argsort`` and ``topk``, over ``axis`` (the flattened array
when None).

Indices come back as float32, as the reference's.  Ties follow the
reference, whose two rules differ: ``argsort(is_ascend=False)`` reverses
a stable ascending argsort, so tied elements come higher index first;
``topk`` takes the first ``k`` of a stable ascending argsort of
``sign * x``, so tied elements come lower index first.  ``topk`` is
built from a stable sort and a slice, since ``torch.topk`` promises no
order among ties on CUDA.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .registry import Bool, Int, IntOrNone, Str, register


def _along(attrs, x):
    """``x`` and the axis to order along (the flattened ``x`` when
    ``axis`` is None)."""
    if attrs["axis"] is None:
        return x.reshape(-1), 0
    return x, attrs["axis"] % x.dim()


def _sort_fc(attrs, x):
    x, ax = _along(attrs, x)
    out = torch.sort(x, dim=ax, stable=True).values
    return out if attrs["is_ascend"] else torch.flip(out, (ax,))


def _flat_shape(attrs, ds):
    if ds is None or attrs["axis"] is not None:
        return ds
    return (int(np.prod(ds)),)


register("sort", fcompute=_sort_fc,
         attrs={"axis": IntOrNone(-1), "is_ascend": Bool(True)},
         infer_shape=lambda attrs, ins: (ins, [_flat_shape(attrs, ins[0])],
                                         []),
         doc="The elements sorted along `axis`.")


def _argsort_fc(attrs, x):
    x, ax = _along(attrs, x)
    idx = torch.argsort(x, dim=ax, stable=True)
    if not attrs["is_ascend"]:
        idx = torch.flip(idx, (ax,))
    return idx.to(torch.float32)


register("argsort", fcompute=_argsort_fc,
         attrs={"axis": IntOrNone(-1), "is_ascend": Bool(True)},
         infer_type=lambda attrs, ts: (ts, ["float32"], []),
         doc="Indices (float32) that sort `axis`; descending order "
             "reverses the stable ascending one.")


def _topk_fc(attrs, x):
    x, ax = _along(attrs, x)
    sign = 1 if attrs["is_ascend"] else -1
    idx = torch.argsort(sign * x, dim=ax, stable=True).narrow(
        ax, 0, attrs["k"])
    rt = attrs["ret_typ"]
    if rt == "indices":
        return idx.to(torch.float32)
    if rt == "mask":
        return torch.zeros_like(x).scatter(ax, idx, 1)
    vals = torch.gather(x, ax, idx)
    if rt == "value":
        return vals
    if rt == "both":
        return vals, idx.to(torch.float32)
    raise MXNetError("topk: unknown ret_typ %r" % rt)


def _topk_infer(attrs, ins):
    (ds,) = ins
    n = 2 if attrs["ret_typ"] == "both" else 1
    if ds is None:
        return ins, [None] * n, []
    out = list(_flat_shape(attrs, ds))
    if attrs["ret_typ"] != "mask":
        out[0 if attrs["axis"] is None else attrs["axis"] % len(ds)] = \
            attrs["k"]
    return ins, [tuple(out)] * n, []


def _topk_type(attrs, ts):
    rt = attrs["ret_typ"]
    if rt == "both":
        return ts, [ts[0], "float32"], []
    return ts, ["float32" if rt == "indices" else ts[0]], []


register("topk", fcompute=_topk_fc,
         attrs={"axis": IntOrNone(-1), "k": Int(1),
                "ret_typ": Str("indices"), "is_ascend": Bool(False)},
         num_outputs=lambda attrs: 2 if attrs["ret_typ"] == "both" else 1,
         outputs=lambda attrs: (["value", "indices"]
                                if attrs["ret_typ"] == "both"
                                else ["output"]),
         infer_shape=_topk_infer, infer_type=_topk_type,
         doc="The `k` largest (or smallest, `is_ascend`) along `axis`: "
             "their values, indices (float32), both, or a 0/1 mask.")
