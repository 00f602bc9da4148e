"""Elementwise operators that ``Symbol.__add__`` emits (counterpart of
``elemwise_add`` and ``_plus_scalar`` in ``mxnet_tpu/ops/elemwise.py``)."""
from __future__ import annotations

import torch

from .registry import Float, register, register_alias

register("elemwise_add", fcompute=lambda attrs, a, b: torch.add(a, b),
         arguments=("lhs", "rhs"),
         doc="Elementwise `add(lhs, rhs)` on same-shape inputs.")
register_alias("elemwise_add", "_plus")
register_alias("elemwise_add", "_add")

register("_plus_scalar",
         fcompute=lambda attrs, x: x + attrs["scalar"],
         attrs={"scalar": Float(required=True)},
         doc="Elementwise `add(x, scalar)`.")
