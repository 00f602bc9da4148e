"""Self-contained prediction API (counterpart of
``mxnet_tpu/predictor.py``, after MXNet's ``c_predict_api.h``): create
from symbol JSON and parameter bytes, set an input, forward, get an
output.

    pred = Predictor(open("m-symbol.json").read(),
                     open("m-0010.params", "rb").read(),
                     {"data": (1, 3, 224, 224)})
    pred.forward(data=x)
    y = pred.get_output(0)

The classic route binds an ``Executor`` (``grad_req='null'``) at the
given input shapes.  ``serving=True`` runs a warmed
:class:`~.serving.ProgramStore` instead, so requests of any bucketable
batch size run without rebinding.  Unlike the reference, whose
``dev_type`` defaults to ``'cpu'``, the port's default is the card
(``dev_type='gpu'``): its entry points run on ``cuda:0`` unless the
caller asks for the CPU (``dev_type='cpu'``).
"""
from __future__ import annotations

import io

import numpy as np

from . import context
from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError

__all__ = ["Predictor", "load_ndarray_file"]


def load_ndarray_file(nd_bytes):
    """A serialized NDArray dict (``nd.save``'s npz, of either package)
    from bytes, as numpy arrays."""
    with np.load(io.BytesIO(nd_bytes), allow_pickle=False) as data:
        return {k: np.asarray(v) for k, v in data.items()
                if not k.startswith("__")}


def _as_ctx_array(value, ctx):
    """A parameter value as an NDArray on ``ctx`` (a device copy; an
    NDArray already on a device is not taken through the host)."""
    if isinstance(value, nd.NDArray):
        return nd.NDArray(value._data.to(context.default_device(ctx),
                                         copy=True))
    return nd.array(value, ctx)


class Predictor:
    """Inference-only executor over a symbol-JSON + params checkpoint
    (MXNet's ``MXPredCreate``)."""

    def __init__(self, symbol_json_str, param_raw_bytes, input_shapes,
                 dev_type="gpu", dev_id=0, serving=False,
                 compute_dtype=None, buckets=None):
        if isinstance(symbol_json_str, bytes):
            symbol_json_str = symbol_json_str.decode()
        self._symbol = sym_mod.load_json(symbol_json_str)
        if dev_type not in ("cpu", "gpu"):
            raise MXNetError("dev_type must be 'cpu' or 'gpu', got %r"
                             % (dev_type,))
        self._ctx = getattr(context, dev_type)(dev_id)
        params = load_ndarray_file(param_raw_bytes) \
            if isinstance(param_raw_bytes, (bytes, bytearray)) \
            else dict(param_raw_bytes)
        arg_params, aux_params = {}, {}
        for k, v in params.items():
            if k.startswith("aux:"):
                aux_params[k[4:]] = v
            else:
                arg_params[k[4:] if k.startswith("arg:") else k] = v

        self._input_names = list(input_shapes)
        self._store = None
        self._exec = None
        self._outputs = None
        if serving:
            from .serving import ProgramStore
            self._store = ProgramStore(
                self._symbol, arg_params, aux_params, input_shapes,
                name="predictor", compute_dtype=compute_dtype,
                buckets=buckets, device=self._ctx)
            self._store.warmup()
            self._np_inputs = {
                n: np.zeros(tuple(input_shapes[n]), np.float32)
                for n in self._input_names}
            shapes = {n: tuple(input_shapes[n])
                      for n in self._input_names}
            _, out_shapes, _ = self._symbol.infer_shape_partial(**shapes)
            self._declared_out_shapes = [tuple(s) if s else None
                                         for s in out_shapes]
            return

        arg_names = self._symbol.list_arguments()
        aux_names = self._symbol.list_auxiliary_states()
        arg_shapes, _, aux_shapes = self._symbol.infer_shape_partial(
            **dict(input_shapes))
        args = []
        self._inputs = {}
        for name, shape in zip(arg_names, arg_shapes):
            if name in input_shapes:
                a = nd.zeros(tuple(input_shapes[name]), self._ctx)
                self._inputs[name] = a
            elif name in arg_params:
                a = _as_ctx_array(arg_params[name], self._ctx)
            elif shape is not None:
                # arguments that are neither inputs nor parameters
                # (labels): zeros, which inference never reads
                a = nd.zeros(tuple(shape), self._ctx)
            else:
                raise MXNetError("argument %r is neither an input nor in "
                                 "the params file, and its shape cannot "
                                 "be inferred" % name)
            args.append(a)
        aux = []
        for name, shape in zip(aux_names, aux_shapes):
            if name in aux_params:
                aux.append(_as_ctx_array(aux_params[name], self._ctx))
            elif shape is not None:
                aux.append(nd.zeros(tuple(shape), self._ctx))
            else:
                raise MXNetError("auxiliary state %r is not in the params "
                                 "file and its shape cannot be inferred"
                                 % name)
        self._exec = self._symbol.bind(self._ctx, dict(zip(arg_names, args)),
                                       grad_req="null",
                                       aux_states=dict(zip(aux_names, aux)))

    def set_input(self, name, data):
        """``MXPredSetInput``."""
        if self._store is not None:
            if name not in self._np_inputs:
                raise MXNetError("unknown input %r (have %s)"
                                 % (name, self._input_names))
            # any bucketable batch size; dtype and trailing dims are
            # checked at forward
            self._np_inputs[name] = np.asarray(data)
            return
        if name not in self._inputs:
            raise MXNetError("unknown input %r (have %s)"
                             % (name, self._input_names))
        self._inputs[name][:] = np.asarray(data)

    def forward(self, **inputs):
        """``MXPredForward``; keyword inputs are set first.  Returns the
        output NDArrays."""
        for k, v in inputs.items():
            self.set_input(k, v)
        if self._store is not None:
            feed, n = self._store.canon_inputs(
                {k: self._np_inputs[k] for k in self._input_names})
            outs, _bucket, _bm = self._store.run(feed, n=n)
            self._outputs = [nd.NDArray(o) for o in outs]
            return self._outputs
        self._outputs = self._exec.forward(is_train=False)
        return self._outputs

    def get_output(self, index):
        """``MXPredGetOutput``: output ``index`` as numpy."""
        if self._outputs is None:
            self.forward()
        return self._outputs[index].asnumpy()

    def get_output_shape(self, index):
        """An output's shape, without a device transfer.  On the serving
        route it is the last forward's (the declared template's before
        any forward)."""
        if self._store is not None:
            if self._outputs is not None:
                return tuple(self._outputs[index].shape)
            return self._declared_out_shapes[index]
        return tuple(self._exec.outputs[index].shape)

    def serving_stats(self):
        """The serving store's stats (None on the classic route)."""
        return None if self._store is None else self._store.stats()

    @staticmethod
    def from_checkpoint(prefix, epoch, input_shapes, dev_type="gpu",
                        dev_id=0, **kwargs):
        """From a ``prefix-symbol.json`` + ``prefix-NNNN.params`` pair
        (either package's); extra keyword arguments (``serving=True``,
        ``compute_dtype``, ``buckets``) pass through."""
        with open("%s-symbol.json" % prefix) as f:
            sym_json = f.read()
        from .model import load_checkpoint
        _, arg_params, aux_params = load_checkpoint(prefix, epoch)
        params = {"arg:%s" % k: v for k, v in arg_params.items()}
        params.update({"aux:%s" % k: v for k, v in aux_params.items()})
        return Predictor(sym_json, params, input_shapes, dev_type, dev_id,
                         **kwargs)
