"""Device contexts of the port (counterpart of ``mxnet_tpu/context.py``).

A :class:`Context` names a device, ``cpu(0)``, ``gpu(i)`` or
``cpu_pinned(0)`` (host memory that CUDA copies read directly), and works
both as a value (``ctx=``, ``context=``, ``device=``) and as a ``with``
scope that sets the thread's current context.  Outside any scope the
current context is ``gpu(0)``: every entry point of the port runs on the
first CUDA device unless the caller asks for the CPU by name, and
without a GPU resolving it raises.  The port never carries on silently
on the CPU, where every kernel wrapper would take its plain PyTorch
version.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "current_context",
           "default_device", "num_devices"]


class Context:
    """A device: type ``"cpu"`` or ``"gpu"`` and an id.  ``with ctx:``
    makes it the thread's current context."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}
    _default_ctx = threading.local()

    __slots__ = ("device_typeid", "device_id", "_old_ctx")

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if device_type not in Context.devstr2type:
            raise MXNetError("unknown device type %r" % (device_type,))
        self.device_typeid = Context.devstr2type[device_type]
        self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx


def cpu(device_id=0):
    """The host context (``device_id`` is kept for the reference's
    signature; there is one host)."""
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    """Page-locked host memory (the reference's ``kCPUPinned``): an
    array made there is a CPU tensor in pinned memory when a GPU is
    present, so a copy to the card can run asynchronously."""
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    """CUDA device ``device_id``."""
    return Context("gpu", device_id)


def num_devices(device_type="gpu"):
    """The number of devices of a type: the CUDA devices for ``"gpu"``,
    one host for ``"cpu"`` and ``"cpu_pinned"``."""
    if device_type in ("cpu", "cpu_pinned"):
        return 1
    if device_type != "gpu":
        raise MXNetError("unknown device type %r" % (device_type,))
    return torch.cuda.device_count()


def current_context():
    """The context of the innermost ``with`` scope of this thread, else
    ``gpu(0)``."""
    ctx = getattr(Context._default_ctx, "value", None)
    return gpu(0) if ctx is None else ctx


def context_of(device):
    """The :class:`Context` of a ``torch.device``."""
    if device.type == "cpu":
        return cpu(0)
    return gpu(0 if device.index is None else device.index)


def default_device(device=None):
    """Resolve ``device`` to a ``torch.device``.

    ``None`` means the current context (``cuda:0`` outside any ``with``
    scope); a :class:`Context`, a ``torch.device`` or a string is taken
    as asked.  A CUDA device raises :class:`MXNetError` when CUDA is
    unavailable.  Choosing a CUDA device also pins fp32 matrix products
    to full fp32 (``torch.backends.cuda.matmul.allow_tf32 = False``,
    PyTorch's default, set explicitly) and fp32 convolutions too
    (``torch.backends.cudnn.allow_tf32 = False``, where PyTorch's
    default is True), so the projections and convolutions the port
    leaves to ``torch.matmul`` and cuDNN keep fp32 precision, and makes bf16
    products accumulate in fp32 to the end
    (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    = False``), as the reference's bf16 products do."""
    if device is None:
        device = current_context()
    if isinstance(device, Context):
        if device.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        device = torch.device("cuda", device.device_id)
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise MXNetError("the port runs on 'cuda' or 'cpu', got %r"
                         % (device,))
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' (or "
            "ctx=mx.cpu(), or run under 'with mx.cpu():') to run the "
            "port's plain PyTorch versions on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev
