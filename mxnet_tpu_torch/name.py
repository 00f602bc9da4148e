"""Automatic symbol names (counterpart of ``mxnet_tpu/name.py``):
``NameManager`` (one counter per op type: ``fullyconnected0``, ...) and
``Prefix``, a manager that puts a prefix before every automatic name."""
from __future__ import annotations

from .symbol import NameManager

__all__ = ["NameManager", "Prefix"]


class Prefix(NameManager):
    """``with Prefix('enc_'):`` names ``fc`` nodes ``enc_fullyconnected0``,
    ... and prefixes explicit names too, as the reference's does."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
