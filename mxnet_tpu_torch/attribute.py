"""``AttrScope``: attributes given to every symbol made inside a ``with``
block (counterpart of ``mxnet_tpu/attribute.py``), such as
``ctx_group`` or ``lr_mult``, as ``examples/model-parallel-lstm/lstm.py``
uses it.  Keys are stored as ``__key__``; a symbol's own attributes win
over the scope's, and nested scopes merge, the inner one winning."""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        self._old_scope = None
        self._attr = {"__%s__" % k if not k.startswith("__") else k: str(v)
                      for k, v in kwargs.items()}

    def get(self, attr):
        """``attr`` merged over this scope's attributes (``attr``
        wins)."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return dict(attr) if attr else {}

    def __enter__(self):
        self._old_scope = getattr(AttrScope._current, "value", None)
        attr = {} if self._old_scope is None else \
            dict(self._old_scope._attr)
        attr.update(self._attr)
        merged = AttrScope.__new__(AttrScope)
        merged._attr = attr
        merged._old_scope = None
        AttrScope._current.value = merged
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope._current.value = self._old_scope

    @staticmethod
    def current():
        """The innermost scope of this thread (an empty one outside any
        ``with``)."""
        cur = getattr(AttrScope._current, "value", None)
        if cur is None:
            cur = AttrScope._current.value = AttrScope()
        return cur
