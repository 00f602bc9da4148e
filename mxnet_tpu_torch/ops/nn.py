"""Functional normalisation doors (counterpart of the LayerNorm/RMSNorm
lowerings of ``mxnet_tpu/ops/nn.py``).

Both normalise over the last axis of an N-d input: they view it as 2D
rows, call the kernel wrapper (CUDA kernel on a CUDA tensor, plain
version on a CPU tensor) and restore the shape.
"""
from __future__ import annotations

from ..kernels import norm as _norm

__all__ = ["rms_norm", "layer_norm"]


def _rows(x):
    return x.reshape(-1, x.shape[-1]).contiguous()


def rms_norm(x, gamma, eps=1e-6):
    """RMSNorm over the last axis of ``x``, scaled by ``gamma``."""
    return _norm.rms_norm(_rows(x), gamma, eps).reshape(x.shape)


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis of ``x`` with affine gamma/beta."""
    return _norm.layer_norm(_rows(x), gamma, beta, eps).reshape(x.shape)
