"""Serving artifacts (``.mxsrv``): the registry-loadable deploy unit
(counterpart of the serving half of ``mxnet_tpu/deploy.py``).

An artifact is one zip of the ``(symbol JSON, params, shape buckets)``
triple, which :meth:`~.serving.ModelRegistry.load_artifact` loads: the
registry casts the weights to the serving dtype and shares one
device-resident copy across the bucket programs.  The member names
(``serving.json``, ``symbol.json``, ``params.npz`` with ``arg:`` /
``aux:`` keys) and ``format_version`` are the reference's, so each
package reads the other's files.

The reference's ``export_model`` / ``DeployedModel`` / ``load_model``
bake the weights into serialized StableHLO; their counterpart, a
``torch.export`` artifact, is not ported yet (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

from .base import MXNetError

__all__ = ["to_serving", "to_serving_checkpoint", "read_serving_artifact"]

_SERVE_META = "serving.json"
_SERVE_SYMBOL = "symbol.json"
_SERVE_PARAMS = "params.npz"
_SERVE_FORMAT_VERSION = 1


def _host(v):
    """A parameter value (NDArray, tensor or numpy) as a numpy array."""
    v = getattr(v, "_data", v)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def to_serving(symbol, arg_params, aux_params, input_shapes, path,
               bucket_edges=None, compute_dtype=None, input_dtypes=None):
    """Write a serving artifact that ``ModelRegistry.load_artifact``
    loads.  ``bucket_edges`` defaults to the current
    ``MXNET_SERVE_BUCKETS`` and is recorded, so the serving process
    builds the bucket set the exporter chose.  Returns ``path``."""
    from .serving.program_store import bucket_edges as _resolve

    input_names = list(input_shapes)
    input_dtypes = dict(input_dtypes or {})
    meta = {
        "format_version": _SERVE_FORMAT_VERSION,
        "input_shapes": {n: list(input_shapes[n]) for n in input_names},
        "input_dtypes": {n: str(np.dtype(input_dtypes.get(n, "float32")))
                         for n in input_names},
        "bucket_edges": list(_resolve(bucket_edges)),
        "compute_dtype": compute_dtype,
        "output_names": symbol.list_outputs(),
    }
    payload = {"arg:%s" % k: _host(v) for k, v in arg_params.items()}
    payload.update({"aux:%s" % k: _host(v)
                    for k, v in (aux_params or {}).items()})
    buf = io.BytesIO()
    np.savez(buf, **payload)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(_SERVE_META, json.dumps(meta, indent=1))
        z.writestr(_SERVE_SYMBOL, symbol.tojson())
        z.writestr(_SERVE_PARAMS, buf.getvalue())
    return path


def to_serving_checkpoint(prefix, epoch, input_shapes, path, **kwargs):
    """:func:`to_serving` from a ``save_checkpoint`` prefix/epoch
    pair."""
    from .model import load_checkpoint
    sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
    return to_serving(sym, arg_params, aux_params, input_shapes, path,
                      **kwargs)


def read_serving_artifact(path_or_bytes):
    """Load a :func:`to_serving` artifact (of either package).  Returns
    ``(symbol, arg_params, aux_params, meta)`` with numpy values."""
    from . import symbol as sym_mod

    if isinstance(path_or_bytes, (bytes, bytearray)):
        path_or_bytes = io.BytesIO(path_or_bytes)
    with zipfile.ZipFile(path_or_bytes) as z:
        meta = json.loads(z.read(_SERVE_META))
        if meta.get("format_version", 0) > _SERVE_FORMAT_VERSION:
            raise MXNetError(
                "serving artifact format v%s is newer than this "
                "loader (v%s)" % (meta.get("format_version"),
                                  _SERVE_FORMAT_VERSION))
        symbol = sym_mod.load_json(z.read(_SERVE_SYMBOL).decode())
        with np.load(io.BytesIO(z.read(_SERVE_PARAMS)),
                     allow_pickle=False) as data:
            arg_params, aux_params = {}, {}
            for k in data.files:
                kind, name = k.split(":", 1)
                (arg_params if kind == "arg" else aux_params)[name] = data[k]
    return symbol, arg_params, aux_params, meta
