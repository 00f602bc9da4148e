"""The step program: one training step of a symbol on one device
(counterpart of ``mxnet_tpu/parallel/spmd.py``).

The reference compiles forward, backward and the in-graph optimizer
update into one XLA program over a mesh.  The port's program is the
same step run eagerly on one device, built once for each cache key
into two closures over the graph's nodes.  Both evaluate the graph
with the port's ``Executor``'s own walk (:func:`..executor.evaluate`):

* ``train_step(params, opt_state, aux, batch, lrs, wds, rng=None)``:
  cast the floating inputs and parameters (differentiably) to
  ``compute_dtype``; run the forward through the port's op registry;
  ``torch.autograd.backward`` from the outputs with cotangents of ones;
  update every live parameter with one multi-tensor update
  (``parallel/ingraph_opt.py``); write the moving statistics back in
  their master dtype.  ``params``, ``opt_state`` and ``aux`` are
  updated in place; it returns the outputs, detached.
* ``predict_step(params, aux, batch, rng=None)``: the inference
  forward's outputs.

Labels keep their master dtype under ``compute_dtype`` (class ids past
256 are not exact in bf16), and so do the arguments the graph reads
only as indices (``Embedding``'s token ids), as in the port's
``Module``.  Ops that draw (Dropout, the samplers) take ``rng``, a
``torch.Generator``, or else the device's generator
(:func:`mxnet_tpu_torch.random.generator`).

Programs are cached in a bounded LRU keyed as the reference's is, with
the device in the mesh's place: (symbol fingerprint, device, input
shapes, dtypes, optimizer statics, fixed parameters), so trainers over
the same setup share one program (``MXNET_SPMD_PROGRAM_CACHE`` bounds
it).  The reference also keys on ``shard_optimizer_state``, which
changes nothing on one device, so it keys nothing here.  The
reference's ``reduce_mode='bucket'`` reduces gradients across a mesh's
devices, and the port has one device.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import torch

from ..base import MXNetError, get_env
from ..executor import evaluate, ones_cotangent, shape_overrides, write_aux
from ..ndarray import _torch_dtype
from .ingraph_opt import InGraphOptimizer, ingraph_fingerprint

__all__ = ["StepProgram", "get_step_program", "program_cache_stats",
           "reset_program_cache", "_cache_size"]


# ---------------------------------------------------------------------------
# Cache keys
# ---------------------------------------------------------------------------
def _symbol_fingerprint(symbol):
    """Content fingerprint of a Symbol graph (computed when a program is
    fetched, never per step); a graph that cannot serialize falls back
    to its identity."""
    try:
        return ("sha1", hashlib.sha1(symbol.tojson().encode()).hexdigest())
    except (TypeError, ValueError, AttributeError):
        return ("id", id(symbol))


def device_fingerprint(device):
    """Hashable identity of the program's device."""
    return (device.type, device.index)


def _shapes_key(shapes):
    if not shapes:
        return ()
    return tuple(sorted((k, tuple(int(x) for x in v))
                        for k, v in shapes.items()))


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------
class StepProgram:
    """One training step (plus its predict twin) for one cache key."""

    __slots__ = ("key", "symbol", "device", "train_step", "predict_step",
                 "param_names", "aux_names", "arg_shapes", "aux_shapes",
                 "data_names", "label_names")

    def __init__(self, key, symbol, device, train_step, predict_step,
                 param_names, aux_names, arg_shapes, aux_shapes,
                 data_names, label_names):
        self.key = key
        # a strong reference: an identity-keyed entry must keep its
        # symbol alive, or another graph could reuse the id
        self.symbol = symbol
        self.device = device
        self.train_step = train_step
        self.predict_step = predict_step
        self.param_names = param_names
        self.aux_names = aux_names
        self.arg_shapes = arg_shapes
        self.aux_shapes = aux_shapes
        self.data_names = data_names
        self.label_names = label_names


def _build_program(key, symbol, device, data_shapes, label_shapes, dtype,
                   compute_dtype, optimizer, fixed_params):
    """The step's closures for one cache key."""
    shapes = dict(data_shapes)
    if label_shapes:
        shapes.update(label_shapes)
    data_names = list(data_shapes)
    label_names = list(label_shapes or {})
    arg_shape_list, _, aux_shape_list = symbol.infer_shape(**shapes)
    arg_names = symbol.list_arguments()
    aux_names = symbol.list_auxiliary_states()
    param_names = [n for n in arg_names if n not in shapes]
    arg_shapes = dict(zip(arg_names, arg_shape_list))
    aux_shapes = dict(zip(aux_names, aux_shape_list))

    nodes = symbol._nodes()
    heads = [(id(n), oi) for n, oi in symbol._outputs]
    attrs = shape_overrides(symbol, arg_shapes, device)
    opt_update = InGraphOptimizer(optimizer).update
    fixed = set(fixed_params)
    live = [n for n in param_names if n not in fixed]
    cdt = _torch_dtype(compute_dtype) if compute_dtype else None
    keep = frozenset(label_names) | frozenset(
        symbol.list_index_arguments())

    def forward(params, aux, batch, is_train, rng):
        values = dict(batch)
        values.update(params)
        values.update(aux)
        return evaluate(nodes, heads, attrs, values, is_train, device,
                        rng=rng, compute_dtype=cdt, keep_dtype=keep)

    def train_step(params, opt_state, aux, batch, lrs, wds, rng=None):
        with torch.enable_grad():
            outs, new_aux = forward(params, aux, batch, True, rng)
        heads_ = [o for o in outs if o.requires_grad]
        if heads_:
            # a loss head (SoftmaxOutput) ignores its cotangent
            torch.autograd.backward(heads_,
                                    [ones_cotangent(o) for o in heads_])
        ws = [params[n] for n in live]
        gs = [w.grad if w.grad is not None else torch.zeros_like(w)
              for w in ws]
        if ws:
            opt_update(ws, gs, [opt_state[n] for n in live], lrs, wds)
        for w in ws:
            w.grad = None
        # moving statistics stay in their master dtype across steps
        write_aux(aux, new_aux)
        return tuple(o.detach() for o in outs)

    @torch.no_grad()
    def predict_step(params, aux, batch, rng=None):
        return tuple(forward(params, aux, batch, False, rng)[0])

    return StepProgram(
        key=key, symbol=symbol, device=device, train_step=train_step,
        predict_step=predict_step, param_names=param_names,
        aux_names=aux_names, arg_shapes=arg_shapes, aux_shapes=aux_shapes,
        data_names=data_names, label_names=label_names)


# ---------------------------------------------------------------------------
# The bounded program LRU (one entry = one StepProgram shared by every
# trainer with the same key)
# ---------------------------------------------------------------------------
class _ProgramCache:
    def __init__(self, max_size):
        self.max_size = max(1, int(max_size))
        self._entries = OrderedDict()
        self._stats = {"hits": 0, "misses": 0, "evictions": 0}
        self._lock = threading.Lock()

    def acquire(self, key, builder):
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self._stats["hits"] += 1
                return entry
            self._stats["misses"] += 1
            entry = self._entries[key] = builder()
            while len(self._entries) > self.max_size:
                self._entries.popitem(last=False)
                self._stats["evictions"] += 1
            return entry

    def snapshot(self):
        with self._lock:
            return dict(self._stats, size=len(self._entries),
                        max_size=self.max_size)


_cache = None


def _get_cache():
    if _cache is None:
        reset_program_cache()
    return _cache


def program_cache_stats():
    """Hit/miss/eviction counters and the current size of the program
    LRU."""
    return _get_cache().snapshot()


def reset_program_cache(max_size=None):
    """Drop every cached step program (tests, reconfiguration)."""
    global _cache
    _cache = _ProgramCache(
        int(max_size) if max_size is not None
        else int(get_env("MXNET_SPMD_PROGRAM_CACHE") or 64))


def _cache_size():
    """Number of step programs currently cached."""
    return program_cache_stats()["size"]


def get_step_program(symbol, device, data_shapes, label_shapes=None,
                     dtype="float32", compute_dtype=None, optimizer=None,
                     fixed_params=(), reduce_mode="fused"):
    """The step program for this training setup on ``device`` (a
    ``torch.device``): the cached :class:`StepProgram` for (symbol,
    device, shapes, dtypes, optimizer statics, fixed parameters), built
    on first use."""
    if optimizer is None:
        raise ValueError("get_step_program requires an optimizer with a "
                         "multi-tensor update (parallel/ingraph_opt.py)")
    if reduce_mode == "bucket":
        raise MXNetError(
            "reduce_mode='bucket' reduces gradients bucket by bucket "
            "across a multi-device mesh; the port trains on one device "
            "until the KVStore and parallelism slice (ROADMAP.md Queue 1 "
            "item 7)")
    if reduce_mode != "fused":
        raise ValueError("reduce_mode must be 'fused' or 'bucket', got %r"
                         % (reduce_mode,))
    fixed = tuple(sorted(fixed_params))
    key = ("spmd_step", _symbol_fingerprint(symbol),
           device_fingerprint(device), _shapes_key(data_shapes),
           _shapes_key(label_shapes), str(dtype),
           str(compute_dtype) if compute_dtype else None,
           ingraph_fingerprint(optimizer), fixed, ("fused",))

    def build():
        return _build_program(key, symbol, device, data_shapes,
                              label_shapes, dtype, compute_dtype, optimizer,
                              fixed)

    return _get_cache().acquire(key, build)
