"""A thin ``NDArray`` over a ``torch.Tensor`` and the ``.params`` file
format (counterpart of ``mxnet_tpu/ndarray.py``, reduced to what
Module, metrics and optimizers use).

``save``/``load`` read and write the reference's npz container: a dict
or list of arrays plus the ``__mx_format__`` key, under ``fname + ".npz"``
unless the name already ends so; ``load`` accepts either name.  So a
checkpoint written by one package loads in the other.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from .base import MXNetError

__all__ = ["NDArray", "array", "zeros", "ones", "save", "load"]


class NDArray:
    """An n-dimensional array on one device; ``_data`` is the tensor.
    Operations that the reference performs by rebinding its immutable
    buffer (``[:] =``, optimizer updates) write the tensor in place."""

    __slots__ = ("_data",)

    def __init__(self, data):
        self._data = data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np.dtype(str(self._data.dtype).replace("torch.", ""))

    @property
    def context(self):
        return self._data.device

    @property
    def size(self):
        return self._data.numel()

    def asnumpy(self):
        return self._data.detach().cpu().numpy().copy()

    def __setitem__(self, key, value):
        if not (isinstance(key, slice) and key == slice(None)):
            raise MXNetError("the port's NDArray supports only [:] "
                             "assignment")
        if isinstance(value, NDArray):
            value = value._data
        if isinstance(value, torch.Tensor):
            self._data.copy_(value)
        elif np.isscalar(value):
            self._data.fill_(value)
        else:
            self._data.copy_(torch.as_tensor(
                np.asarray(value, dtype=self.dtype)).reshape(self.shape))

    def copyto(self, other):
        """Copy into NDArray ``other``, or onto device ``other`` as a new
        array."""
        if isinstance(other, NDArray):
            other._data.copy_(self._data)
            return other
        return NDArray(self._data.to(torch.device(other), copy=True))

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self.context)


def _device(ctx):
    return torch.device("cpu") if ctx is None else torch.device(ctx)


def array(source, ctx=None, dtype=None):
    """An NDArray holding a copy of ``source`` (numpy, tensor, NDArray or
    nested lists; lists default to float32, as in the reference)."""
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        t = source.detach().clone()
    else:
        arr = np.asarray(source)
        if dtype is None and not isinstance(source, np.ndarray):
            dtype = np.float32
        t = torch.from_numpy(np.array(arr, dtype=dtype, copy=True))
    if dtype is not None:
        t = t.to(getattr(torch, np.dtype(dtype).name))
    return NDArray(t.to(_device(ctx)))


def _torch_dtype(dtype):
    return getattr(torch, np.dtype(dtype).name)


def zeros(shape, ctx=None, dtype="float32"):
    return NDArray(torch.zeros(shape, dtype=_torch_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype="float32"):
    return NDArray(torch.ones(shape, dtype=_torch_dtype(dtype),
                              device=_device(ctx)))


def _npz_save_name(fname):
    return fname if fname.endswith(".npz") else fname + ".npz"


def _npz_load_name(fname):
    if fname.endswith(".npz") or not os.path.exists(fname + ".npz"):
        return fname
    return fname + ".npz"


def save(fname, data):
    """Save an NDArray, a list of them or a dict name -> NDArray in the
    reference's npz format; the file is written to a temporary name and
    renamed, so a crash never leaves a torn checkpoint."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        arrays = {k: v.asnumpy() for k, v in data.items()}
        fmt = "dict"
    elif isinstance(data, (list, tuple)):
        arrays = {"arr_%d" % i: v.asnumpy() for i, v in enumerate(data)}
        fmt = "list"
    else:
        raise MXNetError("save requires NDArray, list or dict")
    path = _npz_save_name(fname)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __mx_format__=np.array(fmt), **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load(fname):
    """Load what ``save`` (of either package) wrote: a list or dict of
    NDArrays on the host."""
    with np.load(_npz_load_name(fname)) as zf:
        fmt = str(zf["__mx_format__"])
        if fmt == "dict":
            return {k: array(v) for k, v in zf.items()
                    if k != "__mx_format__"}
        items = sorted((k for k in zf.files if k.startswith("arr_")),
                       key=lambda k: int(k[4:]))
        return [array(zf[k]) for k in items]
