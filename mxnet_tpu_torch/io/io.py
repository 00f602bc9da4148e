"""Data iterators (counterpart of ``mxnet_tpu/io/io.py``): ``DataDesc``,
``DataBatch`` and ``NDArrayIter`` over in-memory arrays, and
``SyntheticDataIter``, the image-classification benchmark's iterator
(a copy of ``examples/image-classification/common/data.py``'s): one
fixed batch of ``uniform(-1, 1)`` images and random labels, made once on
the device and handed out ``max_iter`` times.

``NDArrayIter`` keeps the reference's batch order and its handling of
the last batch (``pad`` wraps around to the first rows, ``discard``
drops the remainder, ``roll_over`` carries it into the next epoch), and
shuffles once, at construction, from the port's explicit generator
(:mod:`mxnet_tpu_torch.random`).  Batches of numpy data are host
NDArrays, which the module copies to its device; data given as NDArrays
on a GPU stays there, and its batches are gathered on that device.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from .. import random as _random
from ..context import cpu
from ..ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "SyntheticDataIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name + shape (+dtype/layout) of one input.  ``layout`` names the
    axes (``"NCHW"``, ``"NT"``, ``"TN"``); its ``N`` is the batch
    axis."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        """The position of the batch axis (``N``) in ``layout``; 0 when
        there is no layout."""
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """One batch: ``data``/``label`` NDArray lists plus ``pad``, the
    number of fill rows in the final batch; a bucketing iterator adds
    the batch's ``bucket_key`` and its own ``provide_data`` /
    ``provide_label``."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


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
    return [(k, v if isinstance(v, NDArray) and v.context.device_type == "gpu"
             else v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
            for k, v in data.items()]


def _rows(v, sel):
    """Rows ``sel`` (a slice or an index array) of a source: a host
    NDArray of a numpy source, an NDArray on the source's device of a
    device NDArray."""
    if isinstance(v, NDArray):
        if isinstance(sel, slice):
            return NDArray(v._data[sel].clone())
        return NDArray(v._data[torch.from_numpy(sel).to(v._data.device)])
    return array(v[sel], ctx=cpu())


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
            sel = self._order[self.cursor:end]
            if end > self.num_data:
                sel = np.concatenate((sel, self._order[:end - self.num_data]))
        elif end <= self.num_data:
            sel = slice(self.cursor, end)
        else:   # the last batch wraps around to the first rows
            sel = np.concatenate((np.arange(self.cursor, self.num_data),
                                  np.arange(end - self.num_data)))
        return [_rows(v, sel) for _, v in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class SyntheticDataIter(DataIter):
    """``max_iter`` batches of one fixed batch held on the current
    context: ``data_shape`` images drawn from ``uniform(-1, 1)`` and
    labels in ``[0, num_classes)``, from numpy's global generator."""

    def __init__(self, num_classes, data_shape, max_iter, dtype="float32"):
        super().__init__(data_shape[0])
        self.cur_iter = 0
        self.max_iter = max_iter
        self.dtype = dtype
        label = np.random.randint(0, num_classes, (self.batch_size,))
        data = np.random.uniform(-1, 1, data_shape)
        self.data = array(data.astype(dtype))
        self.label = array(label.astype(np.float32))
        self.provide_data = [DataDesc("data", tuple(data_shape))]
        self.provide_label = [DataDesc("softmax_label", (self.batch_size,))]

    def next(self):
        self.cur_iter += 1
        if self.cur_iter > self.max_iter:
            raise StopIteration
        return DataBatch(data=[self.data], label=[self.label], pad=0)

    def reset(self):
        self.cur_iter = 0
