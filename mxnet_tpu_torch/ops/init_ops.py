"""Initialization operators (counterpart of ``mxnet_tpu/ops/init_ops.py``):
``_zeros``, ``_ones`` and ``_arange``, which take no input and place
their result on ``ctx`` (the current context, ``cuda:0``, when None),
and ``zeros_like`` / ``ones_like``."""
from __future__ import annotations

import numpy as np
import torch

from ..context import Context, default_device
from .registry import AttrSpec, Dtype, Float, IntOrNone, Shape, register


def _parse_ctx(v):
    """A :class:`Context`, or its string form (``'cpu(0)'``)."""
    if v is None or isinstance(v, Context):
        return v
    if v == "None":
        return None
    kind, _, dev_id = str(v).rstrip(")").partition("(")
    return Context(kind, int(dev_id or 0))


def _dtype(attrs):
    return getattr(torch, attrs["dtype"] or "float32")


def _type(attrs, ts):
    return [], [attrs["dtype"] or "float32"], []


def _register_filler(name, value):
    register(name,
             fcompute=lambda attrs: torch.full(
                 attrs["shape"], value, dtype=_dtype(attrs),
                 device=default_device(attrs["ctx"])),
             arguments=(),
             attrs={"shape": Shape(required=True), "dtype": Dtype("float32"),
                    "ctx": AttrSpec(_parse_ctx, None, False)},
             infer_shape=lambda attrs, ins: ([], [tuple(attrs["shape"])], []),
             infer_type=_type,
             doc="An array of %ds of `shape` on `ctx`." % value)


_register_filler("_zeros", 0)
_register_filler("_ones", 1)


def _arange_fc(attrs):
    arr = torch.arange(attrs["start"], attrs["stop"], attrs["step"],
                       dtype=_dtype(attrs),
                       device=default_device(attrs["ctx"]))
    if attrs["repeat"] and attrs["repeat"] > 1:
        arr = torch.repeat_interleave(arr, attrs["repeat"])
    return arr


def _arange_infer(attrs, ins):
    start, stop, step = attrs["start"], attrs["stop"], attrs["step"]
    n = int(np.ceil((stop - start) / step)) if stop is not None else 0
    n *= max(int(attrs["repeat"] or 1), 1)
    return [], [(n,)], []


register("_arange", fcompute=_arange_fc, arguments=(),
         attrs={"start": Float(0.0), "stop": Float(None),
                "step": Float(1.0), "repeat": IntOrNone(1),
                "dtype": Dtype("float32"),
                "ctx": AttrSpec(_parse_ctx, None, False)},
         infer_shape=_arange_infer, infer_type=_type,
         doc="Evenly spaced values in `[start, stop)`, each repeated "
             "`repeat` times.")
register("zeros_like", fcompute=lambda attrs, x: torch.zeros_like(x),
         doc="Zeros of the input's shape and dtype.")
register("ones_like", fcompute=lambda attrs, x: torch.ones_like(x),
         doc="Ones of the input's shape and dtype.")
