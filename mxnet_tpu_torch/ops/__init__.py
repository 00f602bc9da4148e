"""Operators of the port.  Importing the package registers every op."""
from . import (attention, elemwise, indexing, init_ops, nn, optimizer_op,
               ordering, reduce, registry, sampling, sequence, softmax,
               tensor)

__all__ = ["attention", "elemwise", "indexing", "init_ops", "nn",
           "optimizer_op", "ordering", "reduce", "registry", "sampling",
           "sequence", "softmax", "tensor"]
