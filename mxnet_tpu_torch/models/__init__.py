"""Model definitions of the port.  ``models.transformer_lm`` is a
callable module; the image-classification zoo (``resnet``, ``alexnet``,
``vgg``, ``inception_bn``, ``googlenet``, ``inception_v3``,
``resnext``, ``inception_resnet_v2``), ``lenet``, ``mlp`` and
``lstm_lm`` (the stacked-LSTM language model) are the
builders' ``get_symbol`` functions, as in the reference (load the
modules themselves with ``importlib``)."""
from . import transformer_lm
from .alexnet import get_symbol as alexnet
from .googlenet import get_symbol as googlenet
from .inception_bn import get_symbol as inception_bn
from .inception_resnet_v2 import get_symbol as inception_resnet_v2
from .inception_v3 import get_symbol as inception_v3
from .lenet import get_symbol as lenet
from .lstm_lm import get_symbol as lstm_lm
from .mlp import get_symbol as mlp
from .resnet import get_symbol as resnet
from .resnext import get_symbol as resnext
from .vgg import get_symbol as vgg

__all__ = ["transformer_lm", "resnet", "lenet", "mlp", "alexnet", "vgg",
           "inception_bn", "googlenet", "inception_v3", "resnext",
           "inception_resnet_v2", "lstm_lm"]
