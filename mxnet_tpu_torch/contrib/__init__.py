"""The reference's ``contrib`` namespace: ``contrib.autograd``."""
from . import autograd

__all__ = ["autograd"]
