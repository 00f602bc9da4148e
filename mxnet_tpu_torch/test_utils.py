"""Shared helpers for harnesses (counterpart of
``mxnet_tpu/test_utils.py``; only :func:`smoke_mlp` is ported so far)."""
from __future__ import annotations

__all__ = ["smoke_mlp"]


def smoke_mlp(num_hidden=64, num_classes=10):
    """The tiny 2-layer softmax MLP of the smoke protocols
    (``serving.loadgen.latency_protocol``): ``fc1`` (ReLU), ``fc2``,
    ``SoftmaxOutput`` named ``softmax``."""
    from . import symbol as sym
    data = sym.Variable("data")
    h = sym.Activation(
        sym.FullyConnected(data, num_hidden=num_hidden, name="fc1"),
        act_type="relu")
    return sym.SoftmaxOutput(
        sym.FullyConnected(h, num_hidden=num_classes, name="fc2"),
        name="softmax")
