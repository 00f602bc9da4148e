"""Checkpoint files (counterpart of ``mxnet_tpu/model.py``'s
``save_checkpoint``, ``load_checkpoint`` and ``latest_checkpoint``),
which the examples call as ``mx.model.load_checkpoint``.

A checkpoint is ``prefix-symbol.json`` and ``prefix-NNNN.params``
(keys ``arg:<name>`` and ``aux:<name>``, the reference's npz
container), so one written by either package loads in the other.
``Module.save_checkpoint(..., save_optimizer_states=True)`` adds
``prefix-NNNN.states``.
"""
from __future__ import annotations

import logging
import os
import re

from . import ndarray as nd
from .base import MXNetError
from .symbol import load as load_symbol

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "join_params", "split_params"]


def join_params(arg_params, aux_params):
    """One dict under the ``arg:`` / ``aux:`` key convention."""
    save = {"arg:%s" % k: v for k, v in arg_params.items()}
    save.update(("aux:%s" % k, v) for k, v in aux_params.items())
    return save


def split_params(save_dict, fname="param file"):
    """``(arg_params, aux_params)`` of a dict under the ``arg:`` /
    ``aux:`` key convention."""
    arg_params, aux_params = {}, {}
    for k, value in save_dict.items():
        kind, name = k.split(":", 1)
        if kind == "arg":
            arg_params[name] = value
        elif kind == "aux":
            aux_params[name] = value
        else:
            raise MXNetError("invalid key %r in %s" % (k, fname))
    return arg_params, aux_params


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-NNNN.params``; the params file is written atomically."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, join_params(arg_params, aux_params))
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint written by
    either package."""
    symbol = load_symbol("%s-symbol.json" % prefix)
    fname = "%s-%04d.params" % (prefix, epoch)
    arg_params, aux_params = split_params(nd.load(fname), fname)
    return symbol, arg_params, aux_params


def latest_checkpoint(prefix):
    """The largest epoch N for which ``prefix-NNNN.params`` (or its
    ``.npz`` twin) exists, or None."""
    dirname = os.path.dirname(os.path.abspath(prefix))
    pat = re.compile(re.escape(os.path.basename(prefix))
                     + r"-([0-9]{4,})\.params(\.npz)?$")
    try:
        names = os.listdir(dirname)
    except OSError:
        return None
    epochs = [int(m.group(1)) for m in map(pat.match, names) if m]
    return max(epochs, default=None)
