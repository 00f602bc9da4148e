"""``Embedding`` (counterpart of ``mxnet_tpu/ops/indexing.py``): a row
gather whose gradient PyTorch scatter-adds into the table.  Token ids
arrive as float32, as an ``NDArrayIter`` over token grids yields them,
and are truncated to integers as the reference's ``astype(int32)``; ids
outside the table follow ``jnp.take``'s rule (:func:`_embedding_fc`).
``data`` is registered as an index input, so a module in bf16 hands the
ids to ``Embedding`` in their master dtype (the reference rounds them to
bf16, which changes ids past 256)."""
from __future__ import annotations

import torch

from .registry import Dtype, Int, register


def _embedding_infer(attrs, in_shapes):
    ds = in_shapes[0]
    in_shapes[1] = (attrs["input_dim"], attrs["output_dim"])
    if ds is None:
        return in_shapes, [None], []
    return in_shapes, [tuple(ds) + (attrs["output_dim"],)], []


def _embedding_fc(attrs, data, weight):
    """``jnp.take(weight, ids, axis=0)``: an id in ``[-n, 0)`` wraps to
    row ``n + id``, any other id outside ``[0, n)`` gives a row of NaN
    (the smallest integer for an integer table).  The ids are clamped
    before the gather, so no gather reads out of range (on CUDA that is
    a device-side assert)."""
    n = weight.shape[0]
    ids = data.long()
    ids = torch.where(ids < 0, ids + n, ids)
    ok = (ids >= 0) & (ids < n)
    rows = torch.nn.functional.embedding(torch.where(ok, ids, 0), weight)
    fill = float("nan") if weight.is_floating_point() else \
        torch.iinfo(weight.dtype).min
    return torch.where(ok[..., None], rows,
                       torch.tensor(fill, dtype=weight.dtype,
                                    device=weight.device))


register("Embedding", fcompute=_embedding_fc,
         arguments=("data", "weight"),
         attrs={"input_dim": Int(required=True),
                "output_dim": Int(required=True), "dtype": Dtype("float32")},
         infer_shape=_embedding_infer, index_inputs=("data",))
