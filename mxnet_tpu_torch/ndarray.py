"""NDArray: the imperative tensor of the port (counterpart of
``mxnet_tpu/ndarray.py``).

An NDArray is a mutable handle to a ``torch.Tensor`` (``_data``) on one
device.  Arithmetic, comparison and reduction methods are plain torch
ops on ``_data``; every registered op is a function of this module
(``mx.nd.FullyConnected(...)``, ``mx.nd.sgd_mom_update(...)``) that
funnels through :func:`imperative_invoke`.  Both run with grad enabled
only inside ``autograd.record()`` (see :mod:`.autograd`), so outside it
no graph is built.  Writes the reference performs by rebinding its
immutable buffer (``x[key] = v``, ``out=``, the state inputs of the
optimizer ops, in-place arithmetic outside ``record()``) update the
tensor in place under ``torch.no_grad()``, so a parameter stays a leaf.
Basic indexing and ``reshape`` return views that share the tensor's
memory, as the reference MXNet's NDArray does (the JAX package, whose
arrays are immutable, returns copies).

Creation functions place arrays on the current context: ``cuda:0``
unless the call passes ``ctx=mx.cpu()`` or runs under ``with
mx.cpu():``; without a GPU they raise.  Sources without a dtype become
float32 (lists, scalars, float64) or int32 (int64), as in the reference.

``save``/``load`` read and write the reference's npz container: a dict
or list of arrays plus the ``__mx_format__`` key, under ``fname +
".npz"`` unless the name already ends so; ``load`` accepts either name
and returns host arrays.  So a checkpoint written by one package loads
in the other.
"""
from __future__ import annotations

import builtins
import os
import sys

import numpy as np
import torch

from . import autograd as _autograd
from . import engine as _engine
from . import random as _random
from . import ops as _ops  # noqa: F401  (registers every op)
from .base import MXNetError, atomic_write
from .context import Context, context_of, cpu, default_device
from .ops.elemwise import saturating_cast
from .ops.registry import get_op, list_ops

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full",
           "zeros_like", "ones_like", "arange", "concatenate", "waitall",
           "imperative_invoke", "save", "load"]

# numpy sources keep their dtype but for these (the reference's rule)
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}
_NARROW_TORCH = {torch.float64: torch.float32, torch.int64: torch.int32}


def _torch_dtype(dtype):
    """``None`` (float32), a name, a numpy dtype or a torch dtype as a
    torch dtype."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name == "bool":
        return torch.bool
    found = getattr(torch, name, None)
    if not isinstance(found, torch.dtype):
        raise MXNetError("unknown dtype %r" % (dtype,))
    return found


class NamedDtype(str):
    """``NDArray.dtype`` of a bf16 array where ``ml_dtypes`` is not
    imported (numpy has no bfloat16 of its own): the name, equal to
    ``'bfloat16'``, with numpy's ``name`` and ``itemsize``; every call
    that takes a dtype takes it back."""

    __slots__ = ()
    itemsize = 2

    @property
    def name(self):
        return str(self)


def _numpy_dtype(torch_dtype):
    """The numpy dtype of a torch dtype, as the reference's
    ``NDArray.dtype``: bfloat16 is ``ml_dtypes``' where that imports,
    else a :class:`NamedDtype`."""
    name = str(torch_dtype).replace("torch.", "")
    if name != "bfloat16":
        return np.dtype(name)
    try:
        import ml_dtypes
    except ImportError:
        return NamedDtype(name)
    return np.dtype(ml_dtypes.bfloat16)


def host_numpy(t):
    """A host numpy copy of tensor ``t``.  numpy has no bfloat16, so a
    bf16 tensor widens to float32 on the way, which is exact (every bf16
    is an fp32); the JAX package returns an ``ml_dtypes`` bfloat16
    array there."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def _eager(name, fn, *args):
    """Run ``fn`` on the tensors of NDArray ``args`` (other arguments
    pass as they are) with grad enabled only while recording."""
    recording = _autograd.is_recording()
    ts = [(_autograd.op_input(a) if recording else a._data)
          if isinstance(a, NDArray) else a for a in args]
    with torch.set_grad_enabled(recording):
        return NDArray(_engine.get().dispatch(name, fn, *ts))


def _assign(arr, t):
    """Make ``t`` the value of NDArray ``arr``: in place under no_grad
    when it fits the tensor and carries no graph, else by rebinding (a
    recorded value keeps its graph; a tensor that is itself inside a
    graph is not written in place)."""
    cur = arr._data
    if (t.requires_grad or (cur.requires_grad and not cur.is_leaf)
            or cur.shape != t.shape or cur.dtype != t.dtype
            or cur.device != t.device):
        arr._data = t
        arr._tape = _autograd.current_tape() if t.grad_fn is not None \
            else None
        return
    with torch.no_grad():
        cur.copy_(t)


class NDArray:
    """A mutable handle to a tensor on one device."""

    __slots__ = ("_data", "_tape")

    def __init__(self, data):
        if isinstance(data, NDArray):
            data = data._data
        self._data = data
        # the tape this value was recorded on (None: not recorded)
        self._tape = _autograd.current_tape() if data.grad_fn is not None \
            else None

    # -- properties --------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def dtype(self):
        """The element type as numpy's dtype (bfloat16:
        :func:`_numpy_dtype`)."""
        return _numpy_dtype(self._data.dtype)

    @property
    def context(self):
        """The :class:`~.context.Context` this array lives on."""
        return context_of(self._data.device)

    ctx = context

    @property
    def T(self):
        """Transpose (reversed axes)."""
        return self.transpose()

    # -- sync / host access ------------------------------------------------
    def wait_to_read(self):
        """Block until the work that writes this array has finished."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    def asnumpy(self):
        """A host numpy copy (waits for the device); bfloat16 comes back
        as float32 (:func:`host_numpy`)."""
        return host_numpy(self._data)

    def asscalar(self):
        """The single element of a size-1 array as a Python scalar."""
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size != 1:
            raise MXNetError("Truth value of multi-element NDArray is "
                             "ambiguous")
        return bool(self.asscalar())

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    # -- shape and copies ----------------------------------------------------
    def reshape(self, shape, *more):
        """A view with a new shape (a tuple or varargs dims)."""
        if more:
            shape = (shape,) + tuple(more)
        if isinstance(shape, int):
            shape = (shape,)
        return _eager("reshape", lambda t: t.reshape(tuple(shape)), self)

    def astype(self, dtype):
        """A copy converted to ``dtype``, outside the tape as the
        reference's: no gradient flows through it under ``record()``
        (``Cast`` is the recorded cast)."""
        return NDArray(saturating_cast(self._data.detach(),
                                       _torch_dtype(dtype)))

    def broadcast_to(self, shape):
        """A copy broadcast to ``shape`` (a 0 keeps this array's
        dimension, as the reference's ``broadcast_to``)."""
        cur = (1,) * (len(shape) - self.ndim) + self.shape
        target = tuple(c if s == 0 else s for s, c in zip(shape, cur))
        return _eager("broadcast_to",
                      lambda t: t.reshape(cur).expand(target).contiguous(),
                      self)

    def copy(self):
        """A deep copy on the same device."""
        return _eager("copy", torch.clone, self)

    def copyto(self, other):
        """Copy into NDArray ``other``, or onto a context or device as a
        new array."""
        if isinstance(other, NDArray):
            _assign(other, self._data.detach().to(other._data.device,
                                                  copy=True))
            return other
        return NDArray(self._data.detach().to(default_device(other),
                                              copy=True))

    def as_in_context(self, ctx):
        """This array on ``ctx`` (itself when already there, else a
        copy)."""
        if Context(ctx) == self.context:
            return self
        return self.copyto(ctx)

    def slice(self, start, stop):
        """Rows ``[start, stop)`` along axis 0 (a view)."""
        return self[start:stop]

    def slice_axis(self, axis, begin, end):
        """``[begin, end)`` along ``axis`` (a view; ``end`` None: to the
        end)."""
        idx = [builtins.slice(None)] * self.ndim
        idx[axis] = builtins.slice(begin, end)
        return self[tuple(idx)]

    def at(self, idx):
        """Row ``idx`` along axis 0."""
        return self[idx]

    def flatten(self):
        """Collapse all trailing axes: ``(d0, d1*...*dn)``."""
        return self.reshape((self.shape[0], -1)) if self.ndim > 1 else self

    def expand_dims(self, axis):
        """A size-1 axis inserted at ``axis``."""
        return _eager("expand_dims", lambda t: t.unsqueeze(axis), self)

    def transpose(self, axes=None):
        """Permute axes (reversed when ``axes`` is None)."""
        perm = tuple(axes) if axes else tuple(reversed(range(self.ndim)))
        return _eager("transpose", lambda t: t.permute(perm), self)

    # -- indexing ------------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, NDArray):
            key = key._data
        return _eager("getitem", lambda t: t[key], self)

    def __setitem__(self, key, value):
        """Write ``value`` (NDArray, tensor, scalar or array-like) at
        ``key``, in place under no_grad.  A tensor that lies inside a
        recorded graph is replaced by a detached copy first, so the
        write cuts it from the graph as the reference's rebinding
        does."""
        t = self._data
        if t.requires_grad and not t.is_leaf:
            t = self._data = t.detach().clone()
            self._tape = None
        if isinstance(key, NDArray):
            key = key._data
        if isinstance(value, NDArray):
            value = value._data
        with torch.no_grad():
            if isinstance(value, (int, float, bool, np.generic)):
                t[key] = value
                return
            if not isinstance(value, torch.Tensor):
                value = torch.as_tensor(np.asarray(value))
            value = value.to(device=t.device, dtype=t.dtype)
            if isinstance(key, builtins.slice) and \
                    key == builtins.slice(None) and \
                    value.shape != t.shape and value.numel() == t.numel():
                value = value.reshape(t.shape)
            t[key] = value

    # -- arithmetic ----------------------------------------------------------
    def _binary(self, other, fn, name):
        if isinstance(other, (np.ndarray, list, tuple)):
            other = torch.as_tensor(np.asarray(other),
                                    device=self._data.device)
        return _eager(name, fn, self, other)

    def __add__(self, o): return self._binary(o, torch.add, "add")
    def __radd__(self, o): return self._binary(o, lambda a, b: b + a, "radd")
    def __sub__(self, o): return self._binary(o, torch.sub, "sub")
    def __rsub__(self, o): return self._binary(o, lambda a, b: b - a, "rsub")
    def __mul__(self, o): return self._binary(o, torch.mul, "mul")
    def __rmul__(self, o): return self._binary(o, lambda a, b: b * a, "rmul")
    def __truediv__(self, o): return self._binary(o, torch.true_divide,
                                                  "div")
    def __rtruediv__(self, o): return self._binary(o, lambda a, b: b / a,
                                                   "rdiv")
    def __mod__(self, o): return self._binary(o, torch.remainder, "mod")
    def __pow__(self, o): return self._binary(o, torch.pow, "pow")
    def __rpow__(self, o): return self._binary(o, lambda a, b: b ** a,
                                               "rpow")
    def __neg__(self): return _eager("negative", torch.neg, self)
    def __abs__(self): return _eager("abs", torch.abs, self)

    def _ibinary(self, o, fn, name):
        """In-place arithmetic: recorded as a new value while recording
        (the reference's rebinding).  Otherwise the result is written
        into the tensor (views see it) when its dtype and shape are
        ``self``'s, and rebound as in the reference when they differ
        (int32 ``+= 0.5`` is float32, a broadcast grows the shape)."""
        if _autograd.is_recording() or (self._data.requires_grad
                                        and not self._data.is_leaf):
            res = _eager(name, fn, self, o)
            self._data, self._tape = res._data, res._tape
            return self
        other = o._data if isinstance(o, NDArray) else o
        with torch.no_grad():
            res = fn(self._data, other)
            if res.dtype == self._data.dtype and \
                    res.shape == self._data.shape:
                self._data.copy_(res)
            else:
                self._data = res
        return self

    def __iadd__(self, o): return self._ibinary(o, torch.add, "iadd")
    def __isub__(self, o): return self._ibinary(o, torch.sub, "isub")
    def __imul__(self, o): return self._ibinary(o, torch.mul, "imul")
    def __itruediv__(self, o): return self._ibinary(o, torch.true_divide,
                                                    "idiv")

    def _compare(self, o, fn):
        other = o._data if isinstance(o, NDArray) else o
        return NDArray(fn(self._data.detach(), other))

    def __eq__(self, o): return self._compare(o, torch.eq)
    def __ne__(self, o): return self._compare(o, torch.ne)
    def __gt__(self, o): return self._compare(o, torch.gt)
    def __ge__(self, o): return self._compare(o, torch.ge)
    def __lt__(self, o): return self._compare(o, torch.lt)
    def __le__(self, o): return self._compare(o, torch.le)

    def __hash__(self):
        return id(self)

    # -- reductions (the registered ops) -------------------------------------
    def _reduce(self, name, axis, keepdims):
        return imperative_invoke(name, [self], {"axis": axis,
                                                "keepdims": keepdims})

    def sum(self, axis=None, keepdims=False):
        """Sum over ``axis`` (all axes when None)."""
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        """Arithmetic mean over ``axis``."""
        return self._reduce("mean", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        """Maximum over ``axis``."""
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        """Minimum over ``axis``."""
        return self._reduce("min", axis, keepdims)

    def argmax(self, axis=None):
        """Index of the maximum along ``axis`` (float32, the reference's
        convention)."""
        return imperative_invoke("argmax", [self], {"axis": axis})

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self.context)

    # -- autograd ------------------------------------------------------------
    def attach_grad(self, grad_req="write"):
        """Mark this array as a variable of ``autograd.record()`` and
        allocate its ``.grad`` buffer."""
        _autograd.mark_variables([self], [zeros_like(self)], grad_req)

    @property
    def grad(self):
        """The gradient buffer ``backward()`` fills (after
        ``attach_grad``)."""
        return _autograd.get_grad(self)

    def backward(self, out_grad=None, retain_graph=False):
        """Backpropagate from this array into every attached ``.grad``."""
        _autograd.backward([self], [out_grad] if out_grad is not None
                           else None, retain_graph=retain_graph)


# ---------------------------------------------------------------------------
# Creation
# ---------------------------------------------------------------------------
def array(source, ctx=None, dtype=None):
    """An NDArray holding a copy of ``source`` (numpy, tensor, NDArray,
    nested lists or a scalar) on ``ctx`` (the current context when
    None).  Without ``dtype``: lists and scalars become float32, float64
    float32 and int64 int32; other dtypes stay.  On ``cpu_pinned()``
    the copy lies in page-locked memory when a GPU is present."""
    dev = default_device(ctx)
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        t = source.detach()
        dt = _NARROW_TORCH.get(t.dtype, t.dtype) if dtype is None \
            else _torch_dtype(dtype)
        return NDArray(_pinned(t.to(device=dev, dtype=dt, copy=True), ctx))
    npv = np.array(source, copy=True)
    if dtype is None:
        dtype = _NARROW.get(npv.dtype, npv.dtype) \
            if isinstance(source, np.ndarray) else np.float32
    return NDArray(_pinned(torch.from_numpy(npv).to(
        device=dev, dtype=_torch_dtype(dtype)), ctx))


def _pinned(t, ctx):
    """``t`` in page-locked memory when ``ctx`` is ``cpu_pinned()`` and a
    GPU is present (pinning needs the CUDA driver); else ``t``."""
    if isinstance(ctx, Context) and ctx.device_type == "cpu_pinned" and \
            torch.cuda.is_available():
        return t.pin_memory()
    return t


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def empty(shape, ctx=None, dtype=None):
    """A new array (zero-filled, as the reference's)."""
    return zeros(shape, ctx, dtype)


def zeros(shape, ctx=None, dtype=None):
    """A new array of zeros (float32 unless ``dtype``)."""
    return NDArray(torch.zeros(_shape(shape), dtype=_torch_dtype(dtype),
                               device=default_device(ctx)))


def ones(shape, ctx=None, dtype=None):
    """A new array of ones."""
    return NDArray(torch.ones(_shape(shape), dtype=_torch_dtype(dtype),
                              device=default_device(ctx)))


def full(shape, val, ctx=None, dtype=None):
    """A new array filled with ``val``."""
    return NDArray(torch.full(_shape(shape), val, dtype=_torch_dtype(dtype),
                              device=default_device(ctx)))


def zeros_like(other):
    """Zeros of ``other``'s shape, dtype and device."""
    return NDArray(torch.zeros_like(other._data.detach()))


def ones_like(other):
    """Ones of ``other``'s shape, dtype and device."""
    return NDArray(torch.ones_like(other._data.detach()))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    """Evenly spaced values in ``[start, stop)``, each repeated
    ``repeat`` times."""
    if stop is None:
        start, stop = 0, start
    t = torch.arange(start, stop, step, dtype=_torch_dtype(dtype),
                     device=default_device(ctx))
    if repeat > 1:
        t = torch.repeat_interleave(t, repeat)
    return NDArray(t)


def concatenate(arrays, axis=0, always_copy=True):
    """Join NDArrays along ``axis``."""
    return _eager("concatenate", lambda *ts: torch.cat(ts, dim=axis),
                  *arrays)


def waitall():
    """Block until all queued device work has finished."""
    _engine.waitall()


# ---------------------------------------------------------------------------
# Save / load: the reference's npz container
# ---------------------------------------------------------------------------
def _npz_save_name(fname):
    return fname if fname.endswith(".npz") else fname + ".npz"


def _npz_load_name(fname):
    if fname.endswith(".npz") or not os.path.exists(fname + ".npz"):
        return fname
    return fname + ".npz"


def save(fname, data):
    """Save an NDArray, a list of them or a dict name -> NDArray in the
    reference's npz format; the file is written to a temporary name and
    renamed, so a crash never leaves a torn checkpoint."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        arrays = {k: v.asnumpy() for k, v in data.items()}
        fmt = "dict"
    elif isinstance(data, (list, tuple)):
        arrays = {"arr_%d" % i: v.asnumpy() for i, v in enumerate(data)}
        fmt = "list"
    else:
        raise MXNetError("save requires NDArray, list or dict")
    with atomic_write(_npz_save_name(fname)) as f:
        np.savez(f, __mx_format__=np.array(fmt), **arrays)


def load(fname):
    """Load what ``save`` (of either package) wrote: a list or dict of
    NDArrays on the host."""
    with np.load(_npz_load_name(fname)) as zf:
        fmt = str(zf["__mx_format__"])
        if fmt == "dict":
            return {k: array(v, ctx=cpu()) for k, v in zf.items()
                    if k != "__mx_format__"}
        items = sorted((k for k in zf.files if k.startswith("arr_")),
                       key=lambda k: int(k[4:]))
        return [array(zf[k], ctx=cpu()) for k in items]


# ---------------------------------------------------------------------------
# Imperative invoke and one function per registered op
# ---------------------------------------------------------------------------
def imperative_invoke(op_name, args, kwargs):
    """Run registered op ``op_name`` on NDArrays: the engine behind every
    ``mx.nd.<op>`` function.  NDArray inputs come positionally or by
    argument name, the rest of ``kwargs`` are the op's attributes; a
    variadic op (``Concat``, ``add_n``) counts its positional inputs
    into its ``num_args``.  An op's auxiliary states come after its
    arguments, positionally or by name (BatchNorm's ``moving_mean``,
    ``moving_var``); under ``autograd.train_mode()`` (which ``record()``
    sets) the op trains, and the new values are written into them in
    place, outside the tape.  An op that draws (the samplers, Dropout)
    draws from the generator of its device: its first input's, else its
    ``ctx``'s or the current context's.  The op's ``mutate`` outputs are
    written into their state inputs in place; ``out=`` (an NDArray or a
    list) receives the remaining outputs and is returned.  Otherwise one
    output comes back as an NDArray, several as a list."""
    op = get_op(op_name)
    out = kwargs.pop("out", None)
    kwargs.pop("name", None)
    nd_kwargs = {k: v for k, v in kwargs.items() if isinstance(v, NDArray)}
    attr_kwargs = {k: v for k, v in kwargs.items()
                   if not isinstance(v, NDArray)}
    if op.key_var_num_args and op.key_var_num_args not in attr_kwargs:
        attr_kwargs[op.key_var_num_args] = len(args)
    attrs = op.parse_attrs(attr_kwargs)
    names = op.arguments(attrs) + op.aux_states(attrs)
    if len(args) > len(names):
        raise MXNetError("op %s takes %d inputs (%s), got %d"
                         % (op_name, len(names), ", ".join(names),
                            len(args)))
    inputs = list(args)
    for nm in names[len(inputs):]:
        if nm not in nd_kwargs:
            raise MXNetError("op %s: input %r missing" % (op_name, nm))
        inputs.append(nd_kwargs[nm])
    for x in inputs:
        if not isinstance(x, NDArray):
            raise MXNetError("op %s takes NDArray inputs, got %s"
                             % (op_name, type(x).__name__))
    nargs = len(names) - len(op.aux_states(attrs))
    aux_nds = inputs[nargs:]
    inputs = inputs[:nargs]
    recording = _autograd.is_recording()
    tensors = [_autograd.op_input(x) if recording else x._data
               for x in inputs]
    training = _autograd.is_training()
    gen = None
    if op.needs_rng and (training or op.rng_at_eval):
        gen = _random.generator(tensors[0].device if tensors else
                                default_device(attrs.get("ctx")))
    with torch.set_grad_enabled(recording):
        outs, new_aux = _engine.get().dispatch(
            op_name, op.apply, attrs, tensors, [a._data for a in aux_nds],
            training, gen)
    for a, u in zip(aux_nds, new_aux):
        if u is not a._data:
            _assign(a, u.detach())
    if op.mutate:
        mutated = set()
        for out_idx, arg_idx in op.mutate:
            _assign(inputs[arg_idx], outs[out_idx])
            mutated.add(out_idx)
        outs = tuple(o for i, o in enumerate(outs) if i not in mutated)
    if out is not None:
        outs_nd = (out,) if isinstance(out, NDArray) else tuple(out)
        for o_nd, o in zip(outs_nd, outs):
            _assign(o_nd, o)
        return out
    results = [NDArray(o) for o in outs]
    return results[0] if len(results) == 1 else results


def _make_op_func(op_name):
    def fn(*args, **kwargs):
        return imperative_invoke(op_name, args, kwargs)
    fn.__name__ = op_name
    fn.__doc__ = get_op(op_name).doc or "%s operator." % op_name
    return fn


def _init_ndarray_module():
    """Attach one function per registered op to this module."""
    mod = sys.modules[__name__]
    for name in list_ops():
        if not hasattr(mod, name):
            setattr(mod, name, _make_op_func(name))


_init_ndarray_module()
