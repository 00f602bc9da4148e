"""Device selection for the port (counterpart of ``mxnet_tpu/context.py``).

Every entry point of the port runs on the first CUDA device unless the
caller asks for the CPU by name.  Without a GPU and without an explicit
``"cpu"`` it raises: the port never carries on silently on the CPU,
where every kernel wrapper would take its plain PyTorch version.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["default_device", "cpu", "gpu"]


def cpu(device_id=0):
    """The host, as a ``torch.device`` (``device_id`` is accepted for the
    reference's signature and ignored)."""
    return torch.device("cpu")


def gpu(device_id=0):
    """CUDA device ``device_id`` as a ``torch.device``; raises without
    CUDA, like :func:`default_device`."""
    return default_device(torch.device("cuda", int(device_id)))


def default_device(device=None):
    """Resolve ``device`` to a ``torch.device``.

    ``None`` means ``cuda:0``; ``"cpu"`` (or a CPU ``torch.device``) is
    honoured as asked.  A CUDA device raises :class:`MXNetError` when
    CUDA is unavailable.  Choosing a CUDA device also pins fp32 matrix
    products to full fp32 (``torch.backends.cuda.matmul.allow_tf32 =
    False``, PyTorch's default, set explicitly), so the projections the
    port leaves to ``torch.matmul`` keep fp32 precision."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise MXNetError("the port runs on 'cuda' or 'cpu', got %r"
                         % (device,))
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev
