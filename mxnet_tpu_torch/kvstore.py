"""KVStore, counterpart of the ``local`` store of ``mxnet_tpu/kvstore.py``:
one process, one device. ``push`` sums a key's list of values (one per
device) and hands the sum to the updater, or stores it; ``pull`` copies
the stored value out. The ``dist_*`` and device stores are not ported
yet (ROADMAP.md Queue A item 10)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "local_update_cpu", "local_allreduce_cpu")


def _key_list(key):
    return [key] if isinstance(key, (int, str)) else list(key)


def _val_list(value, nkeys):
    """Per key, the list of its per-device values."""
    if isinstance(value, NDArray):
        return [[value]]
    if not isinstance(value, (list, tuple)):
        raise MXNetError("invalid kvstore value type %s" % type(value))
    if all(isinstance(v, NDArray) for v in value):
        if nkeys == 1:
            return [list(value)]
        if len(value) != nkeys:
            raise MXNetError("value count must match key count")
        return [[v] for v in value]
    return [list(v) if isinstance(v, (list, tuple)) else [v] for v in value]


class KVStore:
    """The single-process store."""

    def __init__(self, kv_type: str = "local"):
        self._type = kv_type
        self._store: Dict = {}
        self._updater: Optional[Callable] = None

    @property
    def type(self) -> str:
        return self._type

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    def init(self, key, value):
        keys = _key_list(key)
        for k, vlist in zip(keys, _val_list(value, len(keys))):
            if k in self._store:
                raise MXNetError("key %s already initialized" % k)
            self._store[k] = vlist[0].copyto(vlist[0].context)

    def push(self, key, value, priority: int = 0):
        keys = _key_list(key)
        for k, vlist in zip(keys, _val_list(value, len(keys))):
            if k not in self._store:
                raise MXNetError("key %s not initialized" % k)
            merged = vlist[0].handle
            for v in vlist[1:]:
                merged = merged + v.handle.to(merged.device)
            merged = NDArray(merged, vlist[0].context)
            if self._updater is not None:
                self._updater(k, merged, self._store[k])
            else:
                self._store[k][:] = merged

    def pull(self, key, out=None, priority: int = 0):
        if out is None:
            raise MXNetError("pull requires out")
        keys = _key_list(key)
        for k, olist in zip(keys, _val_list(out, len(keys))):
            if k not in self._store:
                raise MXNetError("key %s not initialized" % k)
            for o in olist:
                o[:] = self._store[k]

    def set_updater(self, updater: Callable):
        self._updater = updater

    def set_optimizer(self, optimizer):
        from .optimizer import get_updater

        self.set_updater(get_updater(optimizer))

    def _optimizer_updater(self):
        from .optimizer import Updater

        if not isinstance(self._updater, Updater):
            raise MXNetError("no optimizer set")
        return self._updater

    def save_optimizer_states(self, fname: str):
        """The updater's states to ``fname`` through a temporary file and
        a rename, so a crash mid-save leaves the old file whole."""
        from .checkpoint import atomic_write_bytes

        atomic_write_bytes(fname, self._optimizer_updater().get_states())

    def load_optimizer_states(self, fname: str):
        """States from ``fname`` into the updater, in place; a torn or
        foreign file raises naming it."""
        updater = self._optimizer_updater()
        with open(fname, "rb") as f:
            blob = f.read()
        try:
            updater.set_states(blob)
        except Exception as e:
            raise MXNetError("invalid optimizer-states file %s: %s "
                             "(partial/torn write?)" % (fname, e)) from e


def create(name: str = "local") -> KVStore:
    """A store by type name: ``local`` (also ``local_update_cpu`` and
    ``local_allreduce_cpu``). ``dist_*`` and ``device`` stores raise."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    lname = name.lower()
    if lname in _LOCAL:
        return KVStore(lname)
    if "dist" in lname or "device" in lname or "tpu" in lname:
        raise MXNetError("kvstore type '%s' is not ported yet: the port has "
                         "one device and the local store (ROADMAP.md Queue A "
                         "item 10, distribution)" % name)
    raise MXNetError("unknown kvstore type %s" % name)
