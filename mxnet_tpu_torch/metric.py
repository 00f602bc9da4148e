"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``):
``EvalMetric``, ``Accuracy``, ``Perplexity``, ``CrossEntropy`` and
``create``.

Each metric first reduces on the predictions' device to the numbers it
needs per row (the argmax, or the probability of the label), fetches
those to the host, and then does the reference's numpy arithmetic on
them, so the values equal the reference's on the same arrays while a
training step fetches one value per row instead of the whole output.
"""
from __future__ import annotations

import numpy as _np
import torch

from .ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "Perplexity", "CrossEntropy",
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


def _label_probs(label, pred):
    """(label as int32 numpy, pred[i, label[i]] as float numpy) per row
    of ``pred`` viewed as (rows, classes); the gather runs on pred's
    device."""
    p = _tensor(pred)
    p = p.reshape(-1, p.shape[-1])
    lbl = _tensor(label).reshape(-1).to(torch.int32)
    probs = p[torch.arange(p.shape[0], device=p.device),
              lbl.to(device=p.device, dtype=torch.int64)]
    return lbl.cpu().numpy(), probs.detach().cpu().numpy()


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
            pred_label = pred.detach().cpu().numpy().astype("int32")
            label = label.detach().cpu().numpy().astype("int32")
            pred_label, label = pred_label.flatten(), label.flatten()
            if pred_label.shape != label.shape:
                raise ValueError("Shape of labels {} does not match shape "
                                 "of predictions {}".format(
                                     label.shape, pred_label.shape))
            self.sum_metric += (pred_label == label).sum()
            self.num_inst += len(pred_label)


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


def create(metric, **kwargs):
    """A metric by name (``acc``, ``accuracy``, ``ce``, ``cross-entropy``,
    ``perplexity``), or ``metric`` itself when it is one."""
    if isinstance(metric, EvalMetric):
        return metric
    metrics = {"acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy,
               "cross-entropy": CrossEntropy, "perplexity": Perplexity}
    try:
        return metrics[metric.lower()](**kwargs)
    except KeyError:
        raise ValueError("Metric must be in {}".format(sorted(metrics)))
