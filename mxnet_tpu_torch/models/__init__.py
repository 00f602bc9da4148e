"""Model definitions of the port.  ``models.transformer_lm`` is a
callable module; ``models.resnet``, ``models.lenet`` and ``models.mlp``
are the builders' ``get_symbol`` functions, as in the reference (load
the modules themselves with ``importlib``)."""
from . import transformer_lm
from .lenet import get_symbol as lenet
from .mlp import get_symbol as mlp
from .resnet import get_symbol as resnet

__all__ = ["transformer_lm", "resnet", "lenet", "mlp"]
