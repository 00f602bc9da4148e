"""Operators of the port.  Importing the package registers every op."""
from . import (attention, elemwise, indexing, nn, optimizer_op, reduce,
               registry, softmax, tensor)

__all__ = ["attention", "elemwise", "indexing", "nn", "optimizer_op",
           "reduce", "registry", "softmax", "tensor"]
