"""The data-parallel trainer on one device (counterpart of
``mxnet_tpu/parallel/dp.py``).

The reference's trainer runs forward, backward, the gradient
all-reduce and the optimizer update as one compiled program over a
mesh, with the optimizer inside the step (``update_on_kvstore``).  The
port's runs the same step on one device: the trainer holds the state
(master parameters, optimizer state, moving statistics) and places the
batch; the step is the shared :class:`~.spmd.StepProgram`, whose update
is one multi-tensor update over every live parameter
(``parallel/ingraph_opt.py``).  A mesh of several devices waits for the
KVStore and parallelism slice (ROADMAP.md Queue 1 item 7).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ndarray as nd
from .. import random as _random
from ..base import MXNetError
from ..context import Context, cpu, default_device
from ..initializer import InitDesc, Uniform
from ..ndarray import NDArray
from .ingraph_opt import InGraphOptimizer

__all__ = ["DataParallelTrainer", "FusedDPTrainer", "SeedFrom"]


class SeedFrom:
    """An ``initializer`` for :class:`DataParallelTrainer` that starts it
    from given arrays instead of drawing: each parameter and moving
    statistic is a copy of the array of its name (an NDArray or a
    tensor, on any device; a device-to-device copy when it already lies
    on the trainer's device), and no random stream moves.  ``Module``'s
    fused route seeds its trainer so, from its executor's arrays."""

    def __init__(self, arg_params, aux_params=None):
        self.arg_params = dict(arg_params)
        self.aux_params = dict(aux_params or {})


class _TrainerState:
    """Shared mutable holder of the (params, opt_state, aux) dicts.

    Trainers of several input shapes over one model (buckets) share ONE
    state, each with its own program."""

    __slots__ = ("params", "opt_state", "aux")


def _one_device(mesh):
    """The ``torch.device`` of ``mesh``: None (the current context,
    ``cuda:0`` outside any ``with`` scope), a ``Context``, a
    ``torch.device``, a device string, or a one-element list of them."""
    if isinstance(mesh, (list, tuple)):
        if len(mesh) != 1:
            raise MXNetError(
                "DataParallelTrainer: a mesh of %d devices; the port trains "
                "on one device until the KVStore and parallelism slice "
                "(ROADMAP.md Queue 1 item 7)" % len(mesh))
        mesh = mesh[0]
    if mesh is not None and not isinstance(
            mesh, (Context, torch.device, str)):
        raise MXNetError("DataParallelTrainer: mesh must be None, a "
                         "Context or a torch.device, got %r" % (mesh,))
    return default_device(mesh)


def _host_tensor(v):
    """A tensor of a host value (numpy, a list or a scalar); float64
    narrows to float32, as the reference's ``jnp.asarray`` does."""
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


class DataParallelTrainer:
    """Training of a symbol on one device, one step a call.

    >>> trainer = DataParallelTrainer(softmax_sym,
    ...                               data_shapes={'data': (256, 3, 224, 224)},
    ...                               label_shapes={'softmax_label': (256,)},
    ...                               compute_dtype='bfloat16')
    >>> outputs = trainer.step(data, label)   # one step on the card
    """

    def __init__(self, symbol, data_shapes, label_shapes=None, mesh=None,
                 optimizer="sgd", optimizer_params=None, initializer=None,
                 batch_axis="dp", dtype="float32", compute_dtype=None,
                 fixed_params=(), share_state_with=None,
                 shard_optimizer_state=False, reduce_mode="fused"):
        """``mesh``: the device (None is the current context, ``cuda:0``
        outside any ``with`` scope; pass ``mx.cpu()`` for the CPU).

        ``compute_dtype='bfloat16'`` trains in mixed precision:
        parameters, gradients, optimizer state and moving statistics
        stay float32 (master weights), each step casts the floating
        inputs and parameters to bf16 for the forward and backward, and
        the gradients come back float32 through the cast's backward.

        ``shard_optimizer_state=True`` is the reference's ZeRO-1, which
        shards the optimizer state over the mesh's batch axis; over one
        device it is whole, as the reference's is at dp 1.

        ``reduce_mode='bucket'`` (the reference's per-bucket gradient
        reduce across devices) is refused: one device reduces nothing."""
        self.symbol = symbol
        self.mesh = self.device = _one_device(mesh)
        self.batch_axis = batch_axis
        self._fixed = set(fixed_params)
        self._compute_dtype = compute_dtype or None
        self._reduce_mode = reduce_mode

        shapes = dict(data_shapes)
        if label_shapes:
            shapes.update(label_shapes)
        self._data_shapes_map = {k: tuple(v) for k, v in
                                 data_shapes.items()}
        self._label_shapes_map = {k: tuple(v) for k, v in
                                  (label_shapes or {}).items()}
        self.data_names = list(data_shapes)
        self.label_names = list(label_shapes or {})
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.param_names = [n for n in self.arg_names if n not in shapes]
        self._arg_shapes = dict(zip(self.arg_names, arg_shapes))
        self._aux_shapes = dict(zip(self.aux_names, aux_shapes))
        self._dtype = dtype

        # a host Optimizer drives the hyperparameters (schedulers,
        # lr/wd multipliers, update counts); its update arithmetic runs
        # as the step's multi-tensor update
        from .. import optimizer as opt_mod
        if isinstance(optimizer, str):
            opt_params = dict(optimizer_params or {})
            batch = next(iter(data_shapes.values()))[0]
            opt_params.setdefault("rescale_grad", 1.0 / batch)
            optimizer = opt_mod.create(
                optimizer, param_idx2name=dict(enumerate(self.param_names)),
                sym=symbol, **opt_params)
        self.optimizer = optimizer
        self._ingraph = InGraphOptimizer(optimizer)
        # positions in param_names that get updates
        self._live_idx = [i for i, n in enumerate(self.param_names)
                          if n not in self._fixed]

        if share_state_with is not None:
            # a shape variant over the SAME parameter, optimizer and
            # moving-statistic tensors as the primary trainer
            other = share_state_with
            if (set(self.param_names) != set(other.param_names) or
                    set(self.aux_names) != set(other.aux_names)):
                raise MXNetError(
                    "share_state_with requires identical param/aux sets")
            for n in self.param_names:
                if self._arg_shapes[n] != other._arg_shapes[n]:
                    raise MXNetError("param %s shape mismatch across "
                                     "shared trainers" % n)
            if other.device != self.device:
                raise MXNetError("share_state_with: the trainers' devices "
                                 "differ (%s vs %s)" % (self.device,
                                                        other.device))
            self._st = other._st
        else:
            self._st = _TrainerState()
            self._init_params(initializer or Uniform(0.01))
        self._compile()

    # shared-state accessors: all bucket trainers observe each other's steps
    @property
    def params(self):
        return self._st.params

    @params.setter
    def params(self, v):
        self._st.params = v

    @property
    def opt_state(self):
        return self._st.opt_state

    @opt_state.setter
    def opt_state(self, v):
        self._st.opt_state = v

    @property
    def aux(self):
        return self._st.aux

    @aux.setter
    def aux(self, v):
        self._st.aux = v

    # ------------------------------------------------------------------
    def _init_params(self, initializer):
        """Draw every parameter, then every auxiliary state, on the host
        (the port's initializers draw from the host generator, as
        ``Module.init_params`` does) and move them to the device, or copy
        them from a :class:`SeedFrom`'s arrays; the live parameters
        become autograd leaves and the optimizer state starts at
        zeros."""
        if isinstance(initializer, SeedFrom):
            params = self._copies(self.param_names, self._arg_shapes,
                                  initializer.arg_params)
            self.aux = self._copies(self.aux_names, self._aux_shapes,
                                    initializer.aux_params)
        else:
            attrs = self.symbol.attr_dict()

            def draw(name, shape):
                arr = nd.zeros(shape, cpu(), dtype=self._dtype)
                initializer(InitDesc(name, attrs.get(name)), arr)
                return arr._data.to(self.device)

            params = {n: draw(n, self._arg_shapes[n])
                      for n in self.param_names}
            self.aux = {n: draw(n, self._aux_shapes[n])
                        for n in self.aux_names}
        for name, t in params.items():
            if name not in self._fixed:
                t.requires_grad_(True)
        self.params = params
        self.opt_state = dict(zip(self.param_names, self._ingraph.init_states(
            [params[n] for n in self.param_names])))

    def _copies(self, names, shapes, given):
        """Fresh device tensors of ``given``'s arrays of ``names`` (in the
        trainer's dtype), filled by one multi-tensor copy."""
        dtype = nd._torch_dtype(self._dtype)
        srcs = []
        for name in names:
            src = given[name]
            src = src._data if isinstance(src, NDArray) else src
            if tuple(src.shape) != tuple(shapes[name]):
                raise MXNetError("%s: shape %s, the trainer's is %s"
                                 % (name, tuple(src.shape),
                                    tuple(shapes[name])))
            srcs.append(src.detach().to(self.device, dtype))
        dsts = [torch.empty_like(t, memory_format=torch.contiguous_format)
                for t in srcs]
        if dsts:
            torch._foreach_copy_(dsts, srcs)
        return dict(zip(names, dsts))

    def _compile(self):
        """Fetch (or build) the shared step program for this trainer's
        (symbol, device, shapes, dtypes, optimizer, fixed parameters):
        the trainer holds state and placement, ``parallel/spmd.py``'s
        cache owns the program."""
        from . import spmd
        self._program = spmd.get_step_program(
            self.symbol, self.device,
            data_shapes=self._data_shapes_map,
            label_shapes=self._label_shapes_map or None,
            dtype=self._dtype, compute_dtype=self._compute_dtype,
            optimizer=self.optimizer,
            fixed_params=tuple(sorted(self._fixed)),
            reduce_mode=self._reduce_mode)
        self._train_step = self._program.train_step
        self._predict_step = self._program.predict_step

    # ------------------------------------------------------------------
    def _batch(self, data, label=None):
        batch = dict(data) if isinstance(data, dict) else \
            {self.data_names[0]: data}
        if label is not None:
            if isinstance(label, dict):
                batch.update(label)
            else:
                batch[self.label_names[0]] = label
        return self._shard_batch(batch)

    def _shard_batch(self, batch):
        """Each input as a tensor on the device.

        A tensor on the device, or an NDArray whose tensor is there, is
        used as it is, with no copy.  Anything else (numpy, a tensor or
        an NDArray elsewhere) is copied to the device on every step.
        The reference caches its placements by the source's identity,
        which is sound only because jax arrays are immutable: a torch
        tensor edited in place must be seen at the next step."""
        out = {}
        for k, v in batch.items():
            t = v._data if isinstance(v, NDArray) else v
            if not isinstance(t, torch.Tensor):
                t = _host_tensor(t)
            out[k] = t if t.device == self.device else \
                t.detach().to(self.device)
        return out

    def clear_placement_cache(self):
        """The reference's: it drops the cached input placements.  The
        port caches none (see :meth:`_shard_batch`), so there is nothing
        to drop."""

    def step(self, data, label=None, rng=None):
        """Run one training step; returns the outputs as tensors on the
        device, detached (the autograd graph is freed by the step's
        backward).  ``rng``: a ``torch.Generator`` on the device for the
        step's draws (the device's generator when None)."""
        batch = self._batch(data, label)
        lrs, wds = self._host_hyper()
        from .. import engine as _engine
        return _engine.get().dispatch(
            "fused_train_step", self._train_step, self.params,
            self.opt_state, self.aux, batch, lrs, wds, rng)

    def _host_hyper(self):
        """Per-step (lr, wd) lists over the live parameters, from the
        host optimizer (schedulers, multipliers, update counts): Python
        floats, which the update's scalar-list overloads take, so
        nothing is copied to the device for them."""
        return self._ingraph.host_hyper(self._live_idx)

    def step_cost_analysis(self, data, label=None):
        """FLOPs and temporary bytes of one step at this trainer's
        shapes (``flops.compiled_cost``): the step runs once under a
        FLOP counter, on copies of the parameters, optimizer state and
        moving statistics, with the optimizer's update counts and the
        device generator's state restored after it, so the trainer is
        as it was.  A one-shot diagnostic, never a per-step call."""
        from ..flops import compiled_cost
        batch = self._batch(data, label)
        o = self.optimizer
        counts = (dict(o._index_update_count), o.num_update)
        gen = _random.generator(self.device)
        gen_state = gen.get_state()
        try:
            lrs, wds = self._host_hyper()
            with torch.no_grad():
                params = {n: v.detach().clone().requires_grad_(
                    v.requires_grad) for n, v in self.params.items()}
                opt_state = {n: tuple(s.detach().clone() for s in st)
                             for n, st in self.opt_state.items()}
                aux = {n: v.detach().clone() for n, v in self.aux.items()}
            return compiled_cost(self._train_step, params, opt_state, aux,
                                 batch, lrs, wds, None)
        finally:
            o._index_update_count, o.num_update = counts
            gen.set_state(gen_state)

    def predict(self, data, rng=None):
        """The inference forward's outputs for ``data``; labels not given
        are zeros (a loss head's forward does not read them), as the
        reference's ``Module`` fills them for its fused predict."""
        batch = self._batch(data)
        for name in self.label_names:
            if name not in batch:
                batch[name] = torch.zeros(self._label_shapes_map[name],
                                          device=self.device)
        return self._predict_step(self.params, self.aux, batch, rng)

    def get_params(self):
        """Host copies: ``({name: NDArray}, {name: NDArray})`` of the
        parameters and the auxiliary states."""
        args = {n: nd.array(v.detach(), ctx=cpu())
                for n, v in self.params.items()}
        aux = {n: nd.array(v.detach(), ctx=cpu())
               for n, v in self.aux.items()}
        return args, aux

    @staticmethod
    def _copy_into(dst, name, value):
        src = value._data if isinstance(value, NDArray) else value
        if not isinstance(src, torch.Tensor):
            src = _host_tensor(src)
        if tuple(src.shape) != tuple(dst.shape):
            raise MXNetError("%s: shape %s, the trainer's is %s"
                             % (name, tuple(src.shape), tuple(dst.shape)))
        with torch.no_grad():
            dst.copy_(src.detach())

    def set_params(self, arg_params, aux_params=None):
        """Copy named values (NDArrays, tensors or numpy) into the
        parameters and auxiliary states in place; other names pass."""
        for n, v in arg_params.items():
            if n in self.params:
                self._copy_into(self.params[n], n, v)
        for n, v in (aux_params or {}).items():
            if n in self.aux:
                self._copy_into(self.aux[n], n, v)

    # -- optimizer-state interop (Updater.states layout) ----------------
    def get_updater_states(self):
        """The optimizer state as the host ``Updater.states`` dict
        ``{param_index: state in create_state's layout}`` (host NDArrays;
        None for SGD without momentum), which ``.states`` files and
        ``Module``'s updater hold."""
        return {i: self._ingraph.state_to_host(self.opt_state[name])
                for i, name in enumerate(self.param_names)
                if name not in self._fixed}

    def set_updater_states(self, states):
        """Copy ``{param_index: state}`` (NDArrays or numpy, as
        :meth:`get_updater_states` or ``Updater.states`` hold them) into
        the optimizer state in place.  A None state (SGD without
        momentum) is skipped: the trainer's own state stays."""
        for i, name in enumerate(self.param_names):
            if i in states and name not in self._fixed:
                if states[i] is None:
                    continue
                new = self._ingraph.state_from_host(states[i])
                for j, (dst, src) in enumerate(zip(self.opt_state[name],
                                                   new)):
                    self._copy_into(dst, "%s state %d" % (name, j), src)


# The name the step-program design uses for the fused-trainer frontend:
# the same class, a clearer role.
FusedDPTrainer = DataParallelTrainer
