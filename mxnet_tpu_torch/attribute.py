"""Attribute scoping for symbols, counterpart of
``mxnet_tpu/attribute.py``: attributes such as ``ctx_group`` or
``__lr_mult__`` attach to symbols created inside a ``with`` block."""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["AttrScope"]


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        self._old_scope: Optional[AttrScope] = None
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("attributes must be strings")
        self._attr: Dict[str, str] = kwargs

    def get(self, attr: Optional[Dict[str, str]]) -> Dict[str, str]:
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        self._old_scope = AttrScope.current()
        attr = self._old_scope._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, *args):
        AttrScope._current.value = self._old_scope

    @staticmethod
    def current() -> "AttrScope":
        if getattr(AttrScope._current, "value", None) is None:
            AttrScope._current.value = AttrScope()
        return AttrScope._current.value
