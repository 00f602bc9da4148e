"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``):
``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``,
``Perplexity``, ``CrossEntropy``, the regression metrics ``MAE``, ``MSE``
and ``RMSE``, ``Loss`` (the mean of the raw outputs, on the host), and
``create`` (of a name, a metric, or a list of
either).

Each classification metric first reduces on the predictions' device to
the numbers it needs per row (the argmax, or the probability of the
label), fetches those to the host, and then does the reference's numpy
arithmetic on them, so the values equal the reference's on the same
arrays while a training step fetches one value per row instead of the
whole output.  The regression metrics fetch their one value per row as
it is and do the reference's arithmetic: one batch's error per update.

``update_device`` accumulates on the predictions' device instead, with
no host copy a batch, as the reference's does for its fused
``Module.fit``: each update adds a float32 sum and an int32 count to two
device scalars (the count saturates at 2**31 - 1 and ``get`` raises
``OverflowError`` on it), and the host reads them only at ``get()``.
Whether the device path applies is decided before anything runs, from
the metric, the arrays' kinds, dtypes and shapes and their device; it
returns False where it does not, and the caller takes ``update``.
"""
from __future__ import annotations

import numpy as _np
import torch

from .ndarray import NDArray, host_numpy

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "Perplexity", "CrossEntropy", "MAE", "MSE", "RMSE", "Loss",
           "create"]


def check_label_shapes(labels, preds):
    if len(labels) != len(preds):
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(len(labels), len(preds)))


def _tensor(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(_np.asarray(x))


def _count(n, device):
    """A count known on the host as an int32 scalar on ``device``, made
    by a fill on the device: ``torch.tensor(n, device=...)`` would copy
    from the host and wait for the device's queue."""
    return torch.full((), n, dtype=torch.int32, device=device)


def _label_probs(label, pred):
    """(label as int32 numpy, pred[i, label[i]] as float numpy) per row
    of ``pred`` viewed as (rows, classes); the gather runs on pred's
    device."""
    p = _tensor(pred)
    p = p.reshape(-1, p.shape[-1])
    lbl = _tensor(label).reshape(-1).to(torch.int32)
    probs = p[torch.arange(p.shape[0], device=p.device),
              lbl.to(device=p.device, dtype=torch.int64)]
    return lbl.cpu().numpy(), host_numpy(probs)


_INT32_MAX = 2 ** 31 - 1
_LABEL_DTYPES = (torch.float32, torch.float64, torch.float16,
                 torch.bfloat16, torch.int32, torch.int64, torch.int8,
                 torch.uint8, torch.int16)


def _on_one_device(labels, preds):
    """``(labels, preds)`` as tensors on the predictions' one device, the
    labels moved there, or None where the device path cannot take them:
    an array that is not an NDArray or tensor, predictions on several
    devices or not floating, labels of another kind than float or
    integer."""
    if len(labels) != len(preds) or not preds:
        return None
    ps = []
    for p in preds:
        p = p._data if isinstance(p, NDArray) else p
        if not isinstance(p, torch.Tensor) or not p.is_floating_point():
            return None
        ps.append(p.detach())
    device = ps[0].device
    if any(p.device != device for p in ps):
        return None
    ls = []
    for lbl in labels:
        lbl = lbl._data if isinstance(lbl, NDArray) else lbl
        if not isinstance(lbl, torch.Tensor) or \
                lbl.dtype not in _LABEL_DTYPES:
            return None
        ls.append(lbl.detach().to(device, non_blocking=True))
    return ls, ps


class EvalMetric:
    """Running ``sum_metric / num_inst``."""

    def __init__(self, name):
        self.name = name
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError()

    # -- device-side accumulation ----------------------------------------
    def device_stat_fn(self):
        """``fn(labels, preds) -> (sum, count)`` over tensors on one
        device (a float32 and an int32 scalar there, the batch's share
        of ``sum_metric`` and ``num_inst``), or None when this metric
        has no device path."""
        return None

    def _device_shapes_ok(self, labels, preds):
        """Do these tensors' shapes take the device path?  (The host
        ``update`` raises on the shapes that do not.)"""
        return True

    def update_device(self, labels, preds):
        """Accumulate on the predictions' device without a host copy;
        False (nothing done) where the device path does not apply, and
        the caller takes :meth:`update`."""
        pairs = self._device_pairs(labels, preds)
        if pairs is None:
            return False
        self._accumulate(*pairs)
        return True

    def _device_pairs(self, labels, preds):
        """The tensors the device path takes, or None."""
        fn = self.device_stat_fn()
        pairs = None if fn is None else _on_one_device(labels, preds)
        if pairs is None or not self._device_shapes_ok(*pairs):
            return None
        return pairs

    def _accumulate(self, labels, preds):
        s, c = self.device_stat_fn()(labels, preds)
        if self._dev_state is None:
            self._dev_state = (s, c)
            return
        s0, c0 = self._dev_state
        # a sum of non-negative counts that got smaller wrapped: the
        # lane saturates, so get() sees the overflow however many
        # batches follow it
        nc = c0 + c
        nc = torch.where(nc < c0, torch.full_like(nc, _INT32_MAX), nc)
        self._dev_state = (s0 + s, nc)

    def _drain_device(self):
        if self._dev_state is None:
            return
        s, c = self._dev_state
        c = int(c)
        if c < 0 or c == _INT32_MAX:
            raise OverflowError(
                "device metric count lane overflowed int32: call get() at "
                "least once every 2**31 accumulated instances")
        self._dev_state = None
        self.sum_metric += float(s)
        self.num_inst += c

    def reset(self):
        self._dev_state = None
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        self._drain_device()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        return [(name, value)]

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together; ``get`` gives their names and
    values as two lists."""

    def __init__(self, metrics=None):
        self.metrics = [create(m) for m in metrics or []]
        super().__init__("composite")

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def update_device(self, labels, preds):
        """All members on the device, or none: every member's device
        path is checked before any accumulates, so a False leaves the
        whole set to the host ``update``."""
        pairs = [m._device_pairs(labels, preds) for m in self.metrics]
        if not pairs or any(p is None for p in pairs):
            return False
        for m, p in zip(self.metrics, pairs):
            m._accumulate(*p)
        return True

    def reset(self):
        for metric in self.metrics:
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.append(name)
            values.append(value)
        return names, values

    def get_name_value(self):
        return list(zip(*self.get()))


class Accuracy(EvalMetric):
    """Share of rows whose argmax over ``axis`` equals the label."""

    def __init__(self, axis=1):
        super().__init__("accuracy")
        self.axis = axis

    def _device_shapes_ok(self, labels, preds):
        for label, pred in zip(labels, preds):
            if tuple(pred.shape) != tuple(label.shape):
                if not -pred.dim() <= self.axis < pred.dim():
                    return False
                rows = pred.numel() // max(pred.shape[self.axis], 1)
            else:
                rows = pred.numel()
            if rows != label.numel():
                return False
        return True

    def device_stat_fn(self):
        axis = self.axis

        def fn(labels, preds):
            correct = torch.zeros((), dtype=torch.float32,
                                  device=preds[0].device)
            count = 0
            for label, pred in zip(labels, preds):
                if tuple(pred.shape) != tuple(label.shape):
                    pred = torch.argmax(pred, dim=axis)
                p = pred.reshape(-1).to(torch.int32)
                lbl = label.reshape(-1).to(torch.int32)
                correct = correct + (p == lbl).sum().to(torch.float32)
                count += p.numel()
            return correct, _count(count, preds[0].device)
        return fn

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _tensor(label)
            pred = _tensor(pred)
            if tuple(pred.shape) != tuple(label.shape):
                pred = torch.argmax(pred, dim=self.axis)
            pred_label = host_numpy(pred).astype("int32")
            label = host_numpy(label).astype("int32")
            pred_label, label = pred_label.flatten(), label.flatten()
            if pred_label.shape != label.shape:
                raise ValueError("Shape of labels {} does not match shape "
                                 "of predictions {}".format(
                                     label.shape, pred_label.shape))
            self.sum_metric += (pred_label == label).sum()
            self.num_inst += len(pred_label)


class TopKAccuracy(EvalMetric):
    """Share of rows whose label is among the ``top_k`` largest
    predictions (``top_k_accuracy_<k>``); the top k are found on the
    predictions' device and one hit count a row is fetched."""

    def __init__(self, top_k=1):
        super().__init__("top_k_accuracy")
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    def _device_shapes_ok(self, labels, preds):
        return all(pred.dim() in (1, 2) and label.numel() == pred.shape[0]
                   for label, pred in zip(labels, preds))

    def device_stat_fn(self):
        top_k = self.top_k

        def fn(labels, preds):
            correct = torch.zeros((), dtype=torch.float32,
                                  device=preds[0].device)
            count = 0
            for label, pred in zip(labels, preds):
                lbl = label.reshape(-1).to(torch.int32)
                if pred.dim() == 1:
                    hits = (pred.to(torch.int32) == lbl).sum()
                else:
                    k = min(pred.shape[1], top_k)
                    top = torch.topk(pred.float(), k, dim=1).indices
                    hits = (top == lbl[:, None]).sum()
                correct = correct + hits.to(torch.float32)
                count += lbl.numel()
            return correct, _count(count, preds[0].device)
        return fn

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _tensor(pred)
            assert pred.dim() <= 2, "Predictions should be no more than 2 dims"
            lbl = _tensor(label).reshape(-1).to(device=pred.device,
                                                dtype=torch.int32)
            if pred.dim() == 1:
                hits = pred.to(torch.int32) == lbl
            else:
                k = min(pred.shape[1], self.top_k)
                top = torch.topk(pred.float(), k, dim=1).indices
                hits = (top == lbl[:, None]).sum(dim=1)
            self.sum_metric += host_numpy(hits).astype("int64").sum()
            self.num_inst += int(lbl.shape[0])


class Perplexity(EvalMetric):
    """``exp(mean(-log p[label]))`` per update, weighted by rows;
    ``ignore_label`` rows count for nothing."""

    def __init__(self, ignore_label, axis=-1):
        super().__init__("Perplexity")
        self.ignore_label = ignore_label
        self.axis = axis

    def _device_shapes_ok(self, labels, preds):
        return all(pred.dim() >= 1 and pred.shape[-1] > 0 and
                   label.numel() * pred.shape[-1] == pred.numel()
                   for label, pred in zip(labels, preds))

    def device_stat_fn(self):
        ignore_label = self.ignore_label

        def fn(labels, preds):
            dev = preds[0].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            num = torch.zeros((), dtype=torch.int32, device=dev)
            for label, pred in zip(labels, preds):
                lbl = label.reshape(-1).to(torch.int32)
                p = pred.reshape(-1, pred.shape[-1])
                probs = p[torch.arange(p.shape[0], device=dev),
                          lbl.to(torch.int64)].to(torch.float32)
                n = lbl.numel()
                if ignore_label is not None:
                    ignore = (lbl == ignore_label).to(torch.float32)
                    num = num - ignore.sum().to(torch.int32)
                    probs = probs * (1 - ignore) + ignore
                loss = loss - torch.log(torch.clamp(probs, min=1e-10)).sum()
                num = num + n
            # one exp an update, as the host update does: accumulating
            # the loss and taking exp at get() would make the value
            # depend on how often get() is called
            numf = num.to(torch.float32)
            return torch.exp(loss / numf) * numf, num
        return fn

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.
        num = 0
        for label, pred in zip(labels, preds):
            assert _tensor(label).numel() == \
                _tensor(pred).numel() / _tensor(pred).shape[-1], \
                "shape mismatch"
            label, probs = _label_probs(label, pred)
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(probs.dtype)
                num -= int(_np.sum(ignore))
                probs = probs * (1 - ignore) + ignore
            loss -= _np.sum(_np.log(_np.maximum(1e-10, probs)))
            num += label.size
        self.sum_metric += _np.exp(loss / num) * num
        self.num_inst += num


class CrossEntropy(EvalMetric):
    """Mean ``-log(p[label] + eps)`` over rows."""

    def __init__(self, eps=1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def _device_shapes_ok(self, labels, preds):
        return all(pred.dim() == 2 and label.numel() == pred.shape[0]
                   for label, pred in zip(labels, preds))

    def device_stat_fn(self):
        eps = self.eps

        def fn(labels, preds):
            dev = preds[0].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            count = 0
            for label, pred in zip(labels, preds):
                lbl = label.reshape(-1).to(torch.int64)
                prob = pred[torch.arange(lbl.numel(), device=dev),
                            lbl].to(torch.float32)
                loss = loss - torch.log(prob + eps).sum()
                count += lbl.numel()
            return loss, _count(count, dev)
        return fn

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, prob = _label_probs(label, pred)
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


def _as_columns(label, pred):
    """Host numpy copies, a 1-D side as (n, 1): an (n, 1) - (n,)
    difference would broadcast into an (n, n) matrix."""
    label, pred = host_numpy(_tensor(label)), host_numpy(_tensor(pred))
    if label.ndim == 1:
        label = label.reshape(label.shape[0], 1)
    if pred.ndim == 1:
        pred = pred.reshape(pred.shape[0], 1)
    return label, pred


def _columns(t):
    return t.reshape(t.shape[0], 1) if t.dim() == 1 else t


class _Regression(EvalMetric):
    """One batch's ``_error(label, pred)`` per update; on the device,
    ``_device_error`` on float32 columns of equal shape (the host update
    broadcasts other shapes)."""

    def _device_shapes_ok(self, labels, preds):
        return all(label.dim() >= 1 and pred.dim() >= 1 and
                   _columns(label).shape == _columns(pred).shape
                   for label, pred in zip(labels, preds))

    def device_stat_fn(self):
        err = self._device_error

        def fn(labels, preds):
            total = torch.zeros((), dtype=torch.float32,
                                device=preds[0].device)
            for label, pred in zip(labels, preds):
                total = total + err(_columns(label).to(torch.float32),
                                    _columns(pred).to(torch.float32))
            return total, _count(len(preds), preds[0].device)
        return fn

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self.sum_metric += self._error(*_as_columns(label, pred))
            self.num_inst += 1


class MAE(_Regression):
    """Mean absolute error."""

    def __init__(self):
        super().__init__("mae")

    @staticmethod
    def _error(label, pred):
        return _np.abs(label - pred).mean()

    @staticmethod
    def _device_error(label, pred):
        return (label - pred).abs().mean()


class MSE(_Regression):
    """Mean squared error."""

    def __init__(self):
        super().__init__("mse")

    @staticmethod
    def _error(label, pred):
        return ((label - pred) ** 2.0).mean()

    @staticmethod
    def _device_error(label, pred):
        return ((label - pred) ** 2.0).mean()


class RMSE(_Regression):
    """Root of the mean squared error, per batch."""

    def __init__(self):
        super().__init__("rmse")

    @staticmethod
    def _error(label, pred):
        return _np.sqrt(((label - pred) ** 2.0).mean())

    @staticmethod
    def _device_error(label, pred):
        return torch.sqrt(((label - pred) ** 2.0).mean())


class Loss(EvalMetric):
    """Average of the raw outputs (for ``MakeLoss``-style heads): every
    output's elements summed on the host, over their count, as the
    reference's; it has no device path."""

    def __init__(self):
        super().__init__("loss")

    def update(self, _, preds):
        for pred in preds:
            pred = _tensor(pred)
            self.sum_metric += host_numpy(pred).sum()
            self.num_inst += pred.numel()


def create(metric, **kwargs):
    """A metric by name (``acc``, ``accuracy``, ``top_k_accuracy``,
    ``ce``, ``cross-entropy``, ``perplexity``, ``mae``, ``mse``,
    ``rmse``, ``loss``), ``metric`` itself when it is one, or a
    :class:`CompositeEvalMetric` of a list of either."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        return CompositeEvalMetric(metric)
    metrics = {"acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy,
               "top_k_accuracy": TopKAccuracy,
               "cross-entropy": CrossEntropy, "perplexity": Perplexity,
               "mae": MAE, "mse": MSE, "rmse": RMSE, "loss": Loss}
    try:
        return metrics[metric.lower()](**kwargs)
    except KeyError:
        raise ValueError("Metric must be in {}".format(sorted(metrics)))
