"""``Embedding`` (counterpart of ``mxnet_tpu/ops/indexing.py``): a row
gather whose gradient PyTorch scatter-adds into the table.  Token ids
arrive as float32, as an ``NDArrayIter`` over token grids yields them,
and are truncated to integers as the reference's ``astype(int32)``."""
from __future__ import annotations

import torch

from .registry import Dtype, Int, register


def _embedding_infer(attrs, in_shapes):
    ds = in_shapes[0]
    in_shapes[1] = (attrs["input_dim"], attrs["output_dim"])
    if ds is None:
        return in_shapes, [None], []
    return in_shapes, [tuple(ds) + (attrs["output_dim"],)], []


register("Embedding",
         fcompute=lambda attrs, data, weight: torch.nn.functional.embedding(
             data.long(), weight),
         arguments=("data", "weight"),
         attrs={"input_dim": Int(required=True),
                "output_dim": Int(required=True), "dtype": Dtype("float32")},
         infer_shape=_embedding_infer)
