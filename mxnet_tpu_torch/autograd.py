"""Imperative autograd (counterpart of ``mxnet_tpu/autograd.py``), on
``torch.autograd``.

``mark_variables`` / ``NDArray.attach_grad`` make a variable's tensor a
leaf that requires grad.  Inside :func:`record` every imperative op
runs with grad enabled, so PyTorch builds the graph; outside it ops run
under ``torch.no_grad()`` and no graph is built.  :func:`backward` calls
``torch.autograd.grad`` from the outputs to every marked variable and
writes (``'write'``), adds (``'add'``) or drops (``'null'``) the result
into the variable's gradient buffer.  ``record()`` also sets train mode
(``is_training``), under which the stateful ops train: BatchNorm
normalises with the batch statistics and updates its moving statistics
in place, Dropout and rrelu draw.

Where PyTorch's semantics differ from the reference's tape, the
reference's are kept:

* a marked variable that no output depends on keeps its gradient buffer
  unchanged (it is not zeroed);
* a ``backward`` without ``retain_graph`` clears the tape, as the
  reference does: everything recorded before it is forgotten.  A later
  ``backward`` from an output recorded before the clear reaches no
  variable (and does not raise PyTorch's "backward through the graph a
  second time"), and an array recorded before the clear enters later
  recorded ops as a constant.  Each recorded NDArray carries the number
  of the tape it was recorded on (``NDArray._tape``) for this.
"""
from __future__ import annotations

import functools
import threading

import torch

from .base import MXNetError

__all__ = ["is_recording", "is_training", "set_recording", "set_training",
           "record", "pause", "train_mode", "predict_mode", "train_section",
           "test_section", "mark_variables", "backward", "get_grad",
           "grad_and_loss", "grad"]

_STATE = threading.local()


def _state():
    if not hasattr(_STATE, "recording"):
        _STATE.recording = False
        _STATE.training = False
        _STATE.tape = 0       # number of the current tape
        _STATE.marked = {}    # id(NDArray) -> (var, grad NDArray, grad_req)
    return _STATE


def is_recording():
    return _state().recording


def is_training():
    return _state().training


def set_recording(flag):
    s = _state()
    prev, s.recording = s.recording, bool(flag)
    return prev


def set_training(flag):
    s = _state()
    prev, s.training = s.training, bool(flag)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train_mode_):
        self._rec, self._train = is_record, train_mode_
        self._prev = None

    def __enter__(self):
        s = _state()
        self._prev = (s.recording, s.training)
        if self._rec is not None:
            s.recording = self._rec
        if self._train is not None:
            s.training = self._train
        return self

    def __exit__(self, *exc):
        s = _state()
        s.recording, s.training = self._prev


def record(train_mode_=True):
    """Record imperative ops (and set train mode)."""
    return _RecordingStateScope(True, train_mode_)


def pause(train_mode_=False):
    return _RecordingStateScope(False, train_mode_)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


# the reference's contrib.autograd names
train_section = record
test_section = pause


def current_tape():
    """Number of the current tape (see the module docstring)."""
    return _state().tape


def op_input(arr):
    """The tensor a recorded op takes for NDArray ``arr``: its own, or a
    detached alias when it was recorded on a cleared tape."""
    t = arr._data
    if arr._tape is not None and arr._tape != _state().tape:
        return t.detach()
    return t


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to variables: each variable's tensor
    becomes a leaf that requires grad (floating dtypes only)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    s = _state()
    for var, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be 'write', 'add' or 'null', "
                             "got %r" % (req,))
        if var._data.is_floating_point():
            var._data = var._data.detach().requires_grad_(True)
            var._tape = None
        s.marked[id(var)] = (var, g, req)


def get_grad(var):
    ent = _state().marked.get(id(var))
    return ent[1] if ent is not None else None


def _live(arr, s):
    t = arr._data
    return t.requires_grad and (arr._tape is None or arr._tape == s.tape)


def backward(outputs, out_grads=None, retain_graph=False):
    """Gradients of ``outputs`` (cotangents ``out_grads``, ones by
    default) into every marked variable's buffer."""
    from .ndarray import NDArray
    s = _state()
    if out_grads is None:
        out_grads = [None] * len(outputs)
    heads, cots = [], []
    for y, gy in zip(outputs, out_grads):
        if not _live(y, s):
            continue
        t = y._data
        if gy is None:
            g = torch.ones_like(t)
        else:
            g = gy._data if isinstance(gy, NDArray) else torch.as_tensor(gy)
            g = g.to(device=t.device, dtype=t.dtype)
        heads.append(t)
        cots.append(g)
    marked = [ent for ent in s.marked.values() if _live(ent[0], s)]
    if heads and marked:
        grads = torch.autograd.grad(heads, [v._data for v, _, _ in marked],
                                    cots, retain_graph=retain_graph,
                                    allow_unused=True)
        for (_, gbuf, req), g in zip(marked, grads):
            if g is None:
                continue
            if req == "write":
                gbuf._data = g
            elif req == "add":
                gbuf._data = gbuf._data + g
    if not retain_graph:
        s.tape += 1


# ---------------------------------------------------------------------------
# Functional forms (the reference's contrib.autograd)
# ---------------------------------------------------------------------------
def grad_and_loss(func, argnum=None):
    """Return a function computing both the gradient of ``func`` and its
    loss."""
    @functools.wraps(func)
    def wrapped(*args):
        from . import ndarray as nd
        variables = list(args)
        if argnum is not None:
            argnums = [argnum] if isinstance(argnum, int) else argnum
            variables = [args[i] for i in argnums]
        for x in variables:
            if not isinstance(x, nd.NDArray):
                raise MXNetError("grad_and_loss inputs must be NDArrays")
        grads = [nd.zeros_like(x) for x in variables]
        mark_variables(variables, grads)
        with record():
            outputs = func(*args)
        backward(outputs if isinstance(outputs, (list, tuple))
                 else [outputs])
        return grads, outputs
    return wrapped


def grad(func, argnum=None):
    """Gradient-only version of :func:`grad_and_loss`."""
    grad_with_loss_func = grad_and_loss(func, argnum)

    @functools.wraps(grad_with_loss_func)
    def wrapped(*args):
        return grad_with_loss_func(*args)[0]
    return wrapped
