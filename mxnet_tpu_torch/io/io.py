"""Data iterators (counterpart of ``mxnet_tpu/io/io.py``): ``DataDesc``,
``DataBatch`` and ``NDArrayIter`` over in-memory arrays.

``NDArrayIter`` keeps the reference's batch order and its handling of
the last batch (``pad`` wraps around to the first rows, ``discard``
drops the remainder, ``roll_over`` carries it into the next epoch), and
shuffles once, at construction, from the port's explicit generator
(:mod:`mxnet_tpu_torch.random`).  Batches are host NDArrays; the module
copies them to its device.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from .. import random as _random
from ..ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name + shape (+dtype/layout) of one input."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret


class DataBatch:
    """One batch: ``data``/``label`` NDArray lists plus ``pad``, the
    number of fill rows in the final batch."""

    def __init__(self, data, label=None, pad=None, index=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index


class DataIter:
    """Base iterator: ``next`` builds a batch from ``iter_next`` and the
    ``get*`` accessors."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        """Rewind to the start of the data (a new epoch)."""

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getpad(self):
        raise NotImplementedError()


def _init_data(data, allow_empty, default_name):
    """Normalise input data to a list of (name, numpy array)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    return [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays in batches, with shuffle and
    last-batch handling."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size."
        # the shuffle is an index array that batches gather through
        self._order = None
        if shuffle:
            self._order = torch.randperm(
                self.num_data, generator=_random.generator()).numpy()
        if last_batch_handle == "discard":
            new_n = self.num_data - self.num_data % batch_size
            if self._order is not None:
                self._order = self._order[:new_n]
            else:
                self.data = [(k, v[:new_n]) for k, v in self.data]
                self.label = [(k, v[:new_n]) for k, v in self.label]
            self.num_data = new_n
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, "DataIter needs reset."
        end = self.cursor + self.batch_size
        if self._order is not None:
            if end <= self.num_data:
                sel = self._order[self.cursor:end]
            else:
                sel = np.concatenate((self._order[self.cursor:],
                                      self._order[:end - self.num_data]))
            return [array(v.take(sel, axis=0)) for _, v in data_source]
        if end <= self.num_data:
            return [array(v[self.cursor:end]) for _, v in data_source]
        pad = end - self.num_data
        return [array(np.concatenate((v[self.cursor:], v[:pad]), axis=0))
                for _, v in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0
