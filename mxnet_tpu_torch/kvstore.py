"""KVStore, counterpart of the single-process stores of
``mxnet_tpu/kvstore.py``.

* ``local`` (also ``local_update_cpu`` and ``local_allreduce_cpu``): one
  process; ``push`` sums a key's list of values (one per device) and
  hands the sum to the updater, or stores it; ``pull`` copies the stored
  value out.
* ``device`` / ``tpu_sync`` (:class:`TPUSyncKVStore`, any name with
  ``device`` or ``tpu``): the same API; the sum of a list of per-card
  values lands on the first value's card, and ``pull`` copies the stored
  value to every card of the ``out`` list.
* ``device_sync`` (:class:`DeviceSyncKVStore`): one process over several
  cards with the gradient exchange inside the training step. The
  executor group sums every card's gradients into each card's copy after
  the backward (an all-reduce over one flat buffer a card), so the
  training path never pushes; ``fit`` takes the fused step by default
  under this store (``MXNET_TPU_DEVICE_SYNC_FUSED``).

Every store but the ``dist_*`` ones may be subsumed by the fused step
(``fused_step_compatible``). The ``dist_*`` stores (a server, several
processes) are ROADMAP.md Queue A item 10b and raise here.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "TPUSyncKVStore", "DeviceSyncKVStore", "create"]

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


def _tree_sum(tensors):
    """The balanced pairwise tree sum of the JAX package's ``_tree_sum``
    (pairs in order, an odd last one carried up), so that both packages
    add in the same order."""
    xs = list(tensors)
    while len(xs) > 1:
        half, odd = divmod(len(xs), 2)
        paired = [xs[2 * i] + xs[2 * i + 1] for i in range(half)]
        if odd:
            paired.append(xs[-1])
        xs = paired
    return xs[0]


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

    @property
    def fused_step_compatible(self) -> bool:
        """True where the fused train step may subsume this store's
        gradient aggregation: every single-process store, whose exchange
        the executor group runs inside the step."""
        return "dist" not in self._type

    @property
    def in_jit_gradient_exchange(self) -> bool:
        """True for a store that asks for the fused step by default
        (``device_sync``)."""
        return False

    def init(self, key, value):
        keys = _key_list(key)
        for k, vlist in zip(keys, _val_list(value, len(keys))):
            if k in self._store:
                raise MXNetError("key %s already initialized" % k)
            self._store[k] = vlist[0].copyto(vlist[0].context)

    def _reduce(self, vlist: List[NDArray]) -> NDArray:
        """The sum of a key's per-device values, on the first value's
        device, added in the JAX package's tree order."""
        if len(vlist) == 1:
            return vlist[0]
        dev = vlist[0].handle.device
        return NDArray(_tree_sum([v.handle.to(dev) for v in vlist]),
                       vlist[0].context)

    def push(self, key, value, priority: int = 0):
        keys = _key_list(key)
        for k, vlist in zip(keys, _val_list(value, len(keys))):
            if k not in self._store:
                raise MXNetError("key %s not initialized" % k)
            merged = self._reduce(vlist)
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


class TPUSyncKVStore(KVStore):
    """``tpu_sync`` / ``device``: the reduce of a list of per-card values
    on the first value's card."""


class DeviceSyncKVStore(TPUSyncKVStore):
    """``device_sync``: one process over several cards with the gradient
    exchange inside the training step (the executor group's all-reduce
    after the backward). The store keeps the push/pull API for explicit
    use; ``fit`` under it asks for the fused step by default."""

    def __init__(self, kv_type: str = "device_sync"):
        super().__init__(kv_type)

    @property
    def in_jit_gradient_exchange(self) -> bool:
        return True

    def grad_reduce_sharding(self, mesh, param_sharding):
        """Where the exchanged gradient lands: on its param's placement.
        Without fsdp (item 10c) every param is replicated, so this is the
        identity, as in the JAX package."""
        return param_sharding


def create(name: str = "local") -> KVStore:
    """A store by type name, routed as the JAX package routes it:
    ``device_sync``; any name with ``tpu`` or ``device``; the ``local``
    names. ``dist_*`` stores raise (ROADMAP.md Queue A item 10b)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    lname = name.lower()
    if lname == "device_sync":
        return DeviceSyncKVStore(lname)
    if "tpu" in lname or "device" in lname:
        return TPUSyncKVStore(lname)
    if "dist" in lname or "async" in lname:
        raise MXNetError("kvstore type '%s' is not ported yet: the port has "
                         "one process and its single-process stores "
                         "(ROADMAP.md Queue A item 10b, the dist stores)"
                         % name)
    if lname in _LOCAL:
        return KVStore(lname)
    raise MXNetError("unknown kvstore type %s" % name)
