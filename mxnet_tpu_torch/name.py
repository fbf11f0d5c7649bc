"""Automatic naming of symbols, counterpart of ``mxnet_tpu/name.py``.

The counters are the JAX package's exactly (``<hint>N``, one counter per
hint, per thread), so a graph built in either package gets the same
argument names and the same JSON.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]


class NameManager:
    """Assigns unique names to anonymous symbols, ``<op>N`` style."""

    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old_manager = NameManager.current()
        NameManager._current.value = self
        return self

    def __exit__(self, *args):
        NameManager._current.value = self._old_manager

    @staticmethod
    def current() -> "NameManager":
        if getattr(NameManager._current, "value", None) is None:
            NameManager._current.value = NameManager()
        return NameManager._current.value


class Prefix(NameManager):
    """Prefixes every name, given or generated, with ``prefix``."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
