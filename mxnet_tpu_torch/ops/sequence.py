"""Sequence operators (counterpart of ``mxnet_tpu/ops/sequence.py``):
``SequenceLast``, ``SequenceMask`` and ``SequenceReverse`` on
time-major ``(T, N, ...)`` data, with an optional ``sequence_length``
input of shape ``(N,)`` (``use_sequence_length``).  Lengths are
truncated to integers as the reference's ``astype(int32)``; the step
each one selects is clamped into ``[0, T)``, as the reference's gathers
clamp, so no gather reads out of range."""
from __future__ import annotations

import torch

from .elemwise import saturating_cast
from .registry import Bool, Float, register


def _seq_args(attrs):
    return ["data", "sequence_length"] if attrs["use_sequence_length"] \
        else ["data"]


def _lengths(sequence_length):
    return saturating_cast(sequence_length, torch.int32).long()


def _seq_last_fc(attrs, data, sequence_length=None):
    if sequence_length is None:
        return data[-1]
    t = data.shape[0]
    idx = _lengths(sequence_length) - 1
    idx = torch.clamp(torch.where(idx < 0, idx + t, idx), 0, t - 1)
    return data[idx, torch.arange(data.shape[1], device=data.device)]


def _seq_last_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if attrs["use_sequence_length"] and ds is not None:
        in_shapes[1] = (ds[1],)
    if ds is None:
        return in_shapes, [None], []
    return in_shapes, [tuple(ds[1:])], []


register("SequenceLast", fcompute=_seq_last_fc, arguments=_seq_args,
         attrs={"use_sequence_length": Bool(False)},
         infer_shape=_seq_last_infer,
         doc="The last step of each sequence: `data[length - 1, n]`.")


def _steps(data):
    return torch.arange(data.shape[0], device=data.device).reshape(-1, 1)


def _per_step(t, data):
    """(T, N) ``t`` shaped to broadcast over ``data``'s trailing axes."""
    return t.reshape(t.shape + (1,) * (data.dim() - 2))


def _seq_mask_fc(attrs, data, sequence_length=None):
    if sequence_length is None:
        return data
    mask = _steps(data) < _lengths(sequence_length).reshape(1, -1)
    return torch.where(_per_step(mask, data), data, attrs["value"])


def _seq_mask_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if attrs["use_sequence_length"] and ds is not None:
        in_shapes[1] = (ds[1],)
    return in_shapes, [ds], []


register("SequenceMask", fcompute=_seq_mask_fc, arguments=_seq_args,
         attrs={"use_sequence_length": Bool(False), "value": Float(0.0)},
         infer_shape=_seq_mask_infer,
         doc="Steps at or past each sequence's length set to `value`.")


def _seq_reverse_fc(attrs, data, sequence_length=None):
    if sequence_length is None:
        return torch.flip(data, (0,))
    steps = _steps(data)
    lens = _lengths(sequence_length).reshape(1, -1)
    rev = torch.where(steps < lens, lens - 1 - steps, steps)
    rev = _per_step(torch.clamp(rev, 0, data.shape[0] - 1), data)
    return torch.gather(data, 0, rev.expand(data.shape))


register("SequenceReverse", fcompute=_seq_reverse_fc, arguments=_seq_args,
         attrs={"use_sequence_length": Bool(False)},
         infer_shape=_seq_mask_infer,
         doc="Each sequence's first `length` steps reversed, the rest "
             "kept.")
