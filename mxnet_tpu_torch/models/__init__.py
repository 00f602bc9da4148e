"""Model definitions of the port."""
from . import transformer_lm

__all__ = ["transformer_lm"]
