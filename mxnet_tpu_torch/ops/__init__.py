"""Operators of the port.  Importing the package registers every op."""
from . import (attention, contrib, elemwise, indexing, init_ops, nn,
               optimizer_op, ordering, reduce, registry, rnn_op, sampling,
               sequence, softmax, tensor)

__all__ = ["attention", "contrib", "elemwise", "indexing", "init_ops", "nn",
           "optimizer_op", "ordering", "reduce", "registry", "rnn_op",
           "sampling", "sequence", "softmax", "tensor"]
