"""Indexing operators (counterpart of ``mxnet_tpu/ops/indexing.py``):
``Embedding``, ``take``, ``batch_take``, ``one_hot`` and ``pick``.

Every index is made safe before any gather: on CUDA, torch's gathers
turn an index out of range into a device-side assert, which ends the
process's CUDA context.  The reference's rules for such an index are
kept: ``take`` and ``pick`` clip (the default) or wrap it;
``batch_take`` follows ``take_along_axis`` (an index in ``[-n, 0)``
wraps once, any other outside ``[0, n)`` gives NaN); ``one_hot`` gives a
row of ``off_value``.  Float indices are truncated as the reference's
``astype(int32)`` (:func:`~.elemwise.saturating_cast`).

``Embedding``: a row gather whose gradient PyTorch scatter-adds into the
table.  Token ids
arrive as float32, as an ``NDArrayIter`` over token grids yields them,
and are truncated to integers as the reference's ``astype(int32)``; ids
outside the table follow ``jnp.take``'s rule (:func:`_embedding_fc`).
``data`` is registered as an index input, so a module in bf16 hands the
ids to ``Embedding`` in their master dtype (the reference rounds them to
bf16, which changes ids past 256)."""
from __future__ import annotations

import torch

from .elemwise import saturating_cast
from .registry import Bool, Dtype, Float, Int, Str, register


def _ids(t):
    return saturating_cast(t, torch.int32).long()


def _fill_value(dtype):
    """``jnp.take``'s fill for an index out of range: NaN, or the
    smallest signed / largest unsigned integer."""
    if dtype.is_floating_point:
        return float("nan")
    info = torch.iinfo(dtype)
    return info.max if info.min == 0 else info.min


def _in_range(idx, n):
    """``take_along_axis``'s rule: an index in ``[-n, 0)`` wraps once.
    Returns the index made safe (0 where out of range) and the mask of
    the indices in range."""
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, idx, 0), ok


def _filled(out, ok):
    # a fill on out's device: a tensor made from the host value would be
    # a copy that waits for the device's queue, once a step
    fill = torch.full((), _fill_value(out.dtype), dtype=out.dtype,
                      device=out.device)
    return torch.where(ok, out, fill)


def _embedding_infer(attrs, in_shapes):
    ds = in_shapes[0]
    in_shapes[1] = (attrs["input_dim"], attrs["output_dim"])
    if ds is None:
        return in_shapes, [None], []
    return in_shapes, [tuple(ds) + (attrs["output_dim"],)], []


def _embedding_fc(attrs, data, weight):
    """``jnp.take(weight, ids, axis=0)``: an id in ``[-n, 0)`` wraps to
    row ``n + id``, any other id outside ``[0, n)`` gives a row of NaN
    (the smallest integer for an integer table).  The ids are made safe
    before the gather."""
    ids, ok = _in_range(data.long(), weight.shape[0])
    return _filled(torch.nn.functional.embedding(ids, weight), ok[..., None])


register("Embedding", fcompute=_embedding_fc,
         arguments=("data", "weight"),
         attrs={"input_dim": Int(required=True),
                "output_dim": Int(required=True), "dtype": Dtype("float32")},
         infer_shape=_embedding_infer, index_inputs=("data",))


def _take_fc(attrs, a, indices):
    """``mode`` ``clip`` (the default) or ``wrap``; any other mode takes
    ``jnp.take``'s own rule, as the reference passes it through."""
    axis, n = attrs["axis"], a.shape[attrs["axis"]]
    idx, ok = _ids(indices), None
    if attrs["mode"] == "clip":
        idx = torch.clamp(idx, 0, n - 1)
    elif attrs["mode"] == "wrap":
        idx = torch.remainder(idx, n)
    else:
        idx, ok = _in_range(idx, n)
    out = torch.index_select(a, axis, idx.reshape(-1)).reshape(
        a.shape[:axis] + idx.shape + a.shape[axis + 1:])
    if ok is None:
        return out
    return _filled(out, ok.reshape((1,) * axis + ok.shape +
                                   (1,) * (a.dim() - axis - 1)))


def _take_infer(attrs, in_shapes):
    sa, si = in_shapes
    if sa is None or si is None:
        return in_shapes, [None], []
    ax = attrs["axis"]
    return in_shapes, [tuple(sa[:ax]) + tuple(si) + tuple(sa[ax + 1:])], []


register("take", fcompute=_take_fc, arguments=("a", "indices"),
         attrs={"axis": Int(0), "mode": Str("clip")},
         infer_shape=_take_infer, index_inputs=("indices",),
         doc="Slices of `a` along `axis` at `indices`; an index out of "
             "range is clipped (`mode='clip'`) or wrapped (`'wrap'`).")


def _batch_take_fc(attrs, a, indices):
    """``a[i, indices[i]]`` per row, ``take_along_axis``'s rules."""
    idx, ok = _in_range(_ids(indices).reshape(-1, 1), a.shape[1])
    return _filled(torch.gather(a, 1, idx), ok).reshape(-1)


register("batch_take", fcompute=_batch_take_fc, arguments=("a", "indices"),
         infer_shape=lambda attrs, ins: (
             ins, [None if ins[0] is None else (ins[0][0],)], []),
         index_inputs=("indices",),
         doc="`a[i, indices[i]]` for each row i; -1 takes the last "
             "column, an index past the row gives NaN.")


def _one_hot_fc(attrs, indices):
    depth = attrs["depth"]
    cols = torch.arange(depth, device=indices.device)
    hot = (_ids(indices).unsqueeze(-1) == cols).to(
        getattr(torch, attrs["dtype"] or "float32"))
    return hot * (attrs["on_value"] - attrs["off_value"]) + attrs["off_value"]


def _one_hot_infer(attrs, in_shapes):
    (ds,) = in_shapes
    if ds is None:
        return in_shapes, [None], []
    return in_shapes, [tuple(ds) + (attrs["depth"],)], []


register("one_hot", fcompute=_one_hot_fc, arguments=("indices",),
         attrs={"depth": Int(required=True), "on_value": Float(1.0),
                "off_value": Float(0.0), "dtype": Dtype("float32")},
         infer_shape=_one_hot_infer,
         infer_type=lambda attrs, ts: (ts, [attrs["dtype"] or "float32"], []),
         index_inputs=("indices",),
         doc="`on_value` at each index along a new last axis of `depth`, "
             "`off_value` elsewhere (a whole row for an index outside "
             "`[0, depth)`).")


def _pick_fc(attrs, data, index):
    axis = attrs["axis"] % data.dim()
    n = data.shape[axis]
    idx = _ids(index)
    if attrs["mode"] == "wrap":
        idx = torch.remainder(idx, n)
    else:
        idx = torch.clamp(idx, 0, n - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if attrs["keepdims"] else out.squeeze(axis)


def _pick_infer(attrs, in_shapes):
    ds, _ = in_shapes
    if ds is None:
        return in_shapes, [None], []
    axis = attrs["axis"] % len(ds)
    out = list(ds)
    if attrs["keepdims"]:
        out[axis] = 1
    else:
        out.pop(axis)
    return in_shapes, [tuple(out)], []


register("pick", fcompute=_pick_fc, arguments=("data", "index"),
         attrs={"axis": Int(-1), "keepdims": Bool(False), "mode": Str("clip")},
         infer_shape=_pick_infer,
         # the output follows data's dtype, not the index's
         infer_type=lambda attrs, ts: (ts, [ts[0]], []),
         index_inputs=("index",),
         doc="`data[..., index[...], ...]` along `axis`, one element per "
             "index; an index out of range is clipped or wrapped (`mode`).")
