"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``):
``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``,
``Perplexity``, ``CrossEntropy``, the regression metrics ``MAE``, ``MSE``
and ``RMSE``, and ``create`` (of a name, a metric, or a list of
either).

Each classification metric first reduces on the predictions' device to
the numbers it needs per row (the argmax, or the probability of the
label), fetches those to the host, and then does the reference's numpy
arithmetic on them, so the values equal the reference's on the same
arrays while a training step fetches one value per row instead of the
whole output.  The regression metrics fetch their one value per row as
it is and do the reference's arithmetic: one batch's error per update.
"""
from __future__ import annotations

import numpy as _np
import torch

from .ndarray import NDArray, host_numpy

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "Perplexity", "CrossEntropy", "MAE", "MSE", "RMSE", "create"]


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


class EvalMetric:
    """Running ``sum_metric / num_inst``."""

    def __init__(self, name):
        self.name = name
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
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


class _Regression(EvalMetric):
    """One batch's ``_error(label, pred)`` per update."""

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


class MSE(_Regression):
    """Mean squared error."""

    def __init__(self):
        super().__init__("mse")

    @staticmethod
    def _error(label, pred):
        return ((label - pred) ** 2.0).mean()


class RMSE(_Regression):
    """Root of the mean squared error, per batch."""

    def __init__(self):
        super().__init__("rmse")

    @staticmethod
    def _error(label, pred):
        return _np.sqrt(((label - pred) ** 2.0).mean())


def create(metric, **kwargs):
    """A metric by name (``acc``, ``accuracy``, ``top_k_accuracy``,
    ``ce``, ``cross-entropy``, ``perplexity``, ``mae``, ``mse``,
    ``rmse``), ``metric`` itself when it is one, or a
    :class:`CompositeEvalMetric` of a list of either."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        return CompositeEvalMetric(metric)
    metrics = {"acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy,
               "top_k_accuracy": TopKAccuracy,
               "cross-entropy": CrossEntropy, "perplexity": Perplexity,
               "mae": MAE, "mse": MSE, "rmse": RMSE}
    try:
        return metrics[metric.lower()](**kwargs)
    except KeyError:
        raise ValueError("Metric must be in {}".format(sorted(metrics)))
